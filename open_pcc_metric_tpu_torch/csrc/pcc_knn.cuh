// The k-NN refines' device pieces, shared by K3 (refine_knn.cu) and K3b
// (refine_knn_straight.cu): the register k-buffer and its insertion, the
// 8-chunk staging step, the range bound (two minima of 32 strided groups,
// and the k-th of those 64) and the gate pass that builds each thread's
// 256-bit mask of the candidates that can enter, skipping a warp's
// 32-record word by its box. refine_knn.cu's note gives the design. The
// moments K4 (knn_moments.cu) takes the staging step.
#pragma once

#include "pcc_common.cuh"

#include <climits>

namespace pcc {
namespace knn {

constexpr int kMaxK = 32;
constexpr int kStage = 8;            // chunks staged between one barrier pair
constexpr int kWords = kChunk / 32;  // gate-mask words per staged chunk
constexpr int kGroups = 32;          // strided groups of the threshold pass

// Carry (d, id) into the ascending buffer: at each position keep the
// smaller of (carried, held) and carry the larger on.
__device__ __forceinline__ void insert(float (&bd)[kMaxK], int (&bi)[kMaxK],
                                       float d, int id) {
#pragma unroll
  for (int m = 0; m < kMaxK; ++m) {
    const bool lt = pcc::lex_less(d, id, bd[m], bi[m]);
    const float hd = bd[m];
    const int hi = bi[m];
    bd[m] = lt ? d : hd;
    bi[m] = lt ? id : hi;
    d = lt ? hd : d;
    id = lt ? hi : id;
  }
}

// Stages the chunks slots[s], s < n, whose bit s of `take` is set (all of
// them by default) into chunks[0..), in order, and the boxes of their gate
// words into boxes[0..), between barriers; returns how many it staged.
// `take` is the same in every thread.
__device__ __forceinline__ int stage_step(Rec (*chunks)[kChunk],
                                          float (*boxes)[kWords * 6],
                                          const float* b, const int* b_orig,
                                          const int* slots, int n, int lane,
                                          unsigned take = ~0u) {
  __syncthreads();  // every thread is done with the previous step
  int m = 0;
  for (int s = 0; s < n; ++s) {
    if ((take >> s) & 1u) {
      pcc::stage_chunk_boxed(chunks[m], boxes[m], b, b_orig, slots[s], lane);
      ++m;
    }
  }
  __syncthreads();
  return m;
}

// The threshold pass over one staged chunk: m1[g] <= m2[g] are the two
// smallest d of group g (columns j, j % 32 == g) so far, self column
// excluded.
template <bool kSelf>
__device__ __forceinline__ void group_two_min(const Rec* chunk, float qx,
                                              float qy, float qz, int lane,
                                              float (&m1)[kGroups],
                                              float (&m2)[kGroups]) {
#pragma unroll 1
  for (int wd = 0; wd < kWords; ++wd) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = wd * 32 + g;
      float d = pcc::offset(chunk[j], qx, qy, qz).d;
      if (kSelf && j == lane) d = pcc::inf();
      const float hi = fmaxf(m1[g], d);
      m1[g] = fminf(m1[g], d);
      m2[g] = fminf(m2[g], hi);
    }
  }
}

// The k-th smallest of the 64 group minima: an ascending bitonic sort, then
// a select of v[k - 1]. k is a runtime value, so ptxas keeps v in a 256-byte
// stack frame for that select: 16 stores and one load, once a block.
__device__ __forceinline__ float kth_of_groups(const float (&m1)[kGroups],
                                               const float (&m2)[kGroups],
                                               int k) {
  constexpr int kLogN = 6;
  constexpr int kN = 1 << kLogN;
  static_assert(kN == 2 * kGroups, "the sort takes both minima of a group");
  float v[kN];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    v[g] = m1[g];
    v[kGroups + g] = m2[g];
  }
#pragma unroll
  for (int ls = 1; ls <= kLogN; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          const float lo = fminf(v[i], v[l]);
          const float hi = fmaxf(v[i], v[l]);
          const bool up = (i & size) == 0;
          v[i] = up ? lo : hi;
          v[l] = up ? hi : lo;
        }
      }
    }
  }
  float t = pcc::inf();
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) t = i == k - 1 ? v[i] : t;
  return t;
}

// The gate pass: bit j of this thread's mask is set iff candidate j is
// finite, not the thread's own column, and (d, id) <lex (gd, gi). A warp
// skips a word (32 candidates, one box of `boxes`) when every row's bound
// to the box is above its gd: none of them could pass.
template <bool kSelf>
__device__ __forceinline__ void gate_chunk(const Rec* chunk,
                                           const float* boxes,
                                           unsigned* masks, float qx,
                                           float qy, float qz, int lane,
                                           float gd, int gi) {
#pragma unroll 1
  for (int wd = 0; wd < kWords; ++wd) {
    unsigned m = 0;
    const float lb = pcc::point_box_lb(boxes + 6 * wd, qx, qy, qz);
    if (__any_sync(0xffffffffu, !(lb > gd))) {
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const int j = wd * 32 + bit;
        const Rec r = chunk[j];
        const float d = pcc::offset(r, qx, qy, qz).d;
        const bool pass = (!kSelf || j != lane) && d < pcc::inf() &&
                          pcc::lex_less(d, r.id, gd, gi);
        m |= static_cast<unsigned>(pass) << bit;
      }
    }
    masks[wd * kChunk + lane] = m;
  }
}

}  // namespace knn
}  // namespace pcc
