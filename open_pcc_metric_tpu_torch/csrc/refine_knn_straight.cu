// K3b: ungated, unseeded k-NN refine over Morton candidate chunks (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:209
// (_knn_kernel), its group refine_pallas.py:271 (_knn_group) and its entry
// point refine_pallas.py:305 (refine_knn_pallas). Semantics, not layout: for
// each 256-query tile t and each of its query rows, the k lexicographically
// smallest (squared distance, original id) pairs over every candidate chunk
// cand[t, s], s < w, ascending, starting from k copies of (inf, INT32_MAX).
// No seed, no slot gate: the fixed-cap schedule's stage 1
// (ops/knn_pruned.py), every slot of a table in lb order.
//
//   * Distance and merge rule: K3's (refine_knn.cu). pcc::offset, and a
//     candidate enters iff it is finite and (d, id) <lex (d_k, id_k), the
//     buffer's k-th pair. The lexicographic k-best is unique, so d and id
//     equal K3's bit for bit whatever each kernel skips, and K4's
//     membership test holds on them.
//   * exclude_self as in K3, on global rows (tiles[t] * 256 + lane).
//   * A row must not repeat a chunk: the insertion keeps a second copy of a
//     point (the TPU merge, which masks by id, would not). The fixed
//     schedule's candidates repeat chunk 0 only on tiles without a valid
//     row, whose results are discarded; there the kernels keep the k-best
//     of the repeated multiset, K3 and K3b alike.
//
// Bound: FP32 ALU, as K1 (8 flops and a compare per pair), plus the
// insertions: a pair that enters costs a 32-step compare-and-carry.
//
// Design: K3's pieces (pcc_knn.cuh: one 256-thread block per tile, one
// query per thread, the k-buffer in 32 register pairs right-aligned behind
// (-inf, INT_MIN) pairs for k < 32, 8 chunks staged a barrier pair with
// their word boxes, per-thread gate masks with the word skip), on a table
// where every slot is live and nothing seeds the buffer. What differs from
// K3 ungated, which first walks the WHOLE range for its bound (a full scan
// no word can skip, most of its time on the fixed table):
//   * The range bound comes from the first step alone: the two smallest d
//     of 32 strided groups over its up to 8 chunks, and the k-th of those
//     64, which at least k candidates lie at or below. The step stays
//     staged for the gate pass. The slots are in lb order, so the first 8
//     chunks hold most of a row's neighbours: once the first step has
//     filled the buffer, its k-th pair gates the rest and the later steps
//     skip most words, as K3's seeded extension does.
//   * Slot skip (when the chunk boxes are given): before a later step is
//     staged, each row bounds its distance to each slot's chunk box
//     (pcc::point_box_lb, bbox_lo/hi of the search grid, which enclose all
//     256 records, padding included) and the block stages only the slots
//     some row is not bounded away from (one warp OR, one shared atomicOr
//     and one barrier a step). The bound rounds as pcc::offset does, so it
//     never exceeds a record's d: a skipped slot holds no candidate that
//     could enter any row, sentinel rows included.
//   * No split, no cluster merge, no seed: the fixed tables have thousands
//     of tiles, so one block a tile fills the card.
// Do not stop early on the lb order of the slots: lb is not a lower bound
// for the sentinel rows of a tile whose box was built from its valid rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_knn.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;
using pcc::knn::gate_chunk;
using pcc::knn::group_two_min;
using pcc::knn::insert;
using pcc::knn::kGroups;
using pcc::knn::kMaxK;
using pcc::knn::kStage;
using pcc::knn::kth_of_groups;
using pcc::knn::kWords;
using pcc::knn::stage_step;

__global__ void __launch_bounds__(kChunk)
refine_knn_straight_kernel(const float* __restrict__ q,
                           const float* __restrict__ b,
                           const int* __restrict__ b_orig,
                           const int* __restrict__ cand,
                           const int* __restrict__ tiles,
                           const float* __restrict__ c_lo,
                           const float* __restrict__ c_hi,
                           float* __restrict__ out_d, int* __restrict__ out_i,
                           int w, int k, int exclude_self) {
  __shared__ Rec chunks[kStage][kChunk];
  __shared__ float boxes[kStage][kWords * 6];  // each gate word's box
  __shared__ unsigned masks[kWords * kChunk];  // column lane: own thread's
  __shared__ unsigned need[2];  // slot skip: a step's slots some row needs

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
  const int* slots = cand + static_cast<int64_t>(t) * w;
  if (lane < 2) need[lane] = 0;  // published by the first step's barriers

  // The bound (td, INT32_MAX) from the first step, which stays staged.
  const int first = min(kStage, w);
  stage_step(chunks, boxes, b, b_orig, slots, first, lane);
  float td;
  {
    float m1[kGroups], m2[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) m1[g] = m2[g] = pcc::inf();
    for (int s = 0; s < first; ++s) {
      if (exclude_self && slots[s] == tile) {
        group_two_min<true>(chunks[s], qx, qy, qz, lane, m1, m2);
      } else {
        group_two_min<false>(chunks[s], qx, qy, qz, lane, m1, m2);
      }
    }
    td = kth_of_groups(m1, m2, k);
  }

  const int lead = kMaxK - k;  // sentinel pairs in front of the live buffer
  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    bd[j] = j < lead ? -pcc::inf() : pcc::inf();
    bi[j] = j < lead ? INT_MIN : INT_MAX;
  }

  for (int s0 = 0, step = 0; s0 < w; s0 += kStage, ++step) {
    const int n = min(kStage, w - s0);
    // The row's threshold: no candidate above it can enter.
    float gd = td;
    int gi = INT_MAX;
    if (pcc::lex_less(bd[kMaxK - 1], bi[kMaxK - 1], gd, gi)) {
      gd = bd[kMaxK - 1];
      gi = bi[kMaxK - 1];
    }
    unsigned take = (1u << n) - 1u;  // the step's slots to stage
    int staged = n;
    if (step > 0) {
      if (c_lo != nullptr) {
        unsigned mine = 0;
        for (int s = 0; s < n; ++s) {
          const int64_t c = slots[s0 + s];
          const float box[6] = {c_lo[3 * c], c_lo[3 * c + 1], c_lo[3 * c + 2],
                                c_hi[3 * c], c_hi[3 * c + 1], c_hi[3 * c + 2]};
          if (!(pcc::point_box_lb(box, qx, qy, qz) > gd)) mine |= 1u << s;
        }
        mine = __reduce_or_sync(0xffffffffu, mine);
        if ((lane & 31) == 0 && mine != 0) atomicOr(&need[step & 1], mine);
        __syncthreads();
        take = need[step & 1];
        // need[(step + 1) & 1] was last read in the previous step, before
        // this step's barrier; the next step writes it after this one's.
        if (lane == 0) need[(step + 1) & 1] = 0;
      }
      staged = stage_step(chunks, boxes, b, b_orig, slots + s0, n, lane,
                          take);
    }
    unsigned rest = take;
    for (int i = 0; i < staged; ++i) {
      const int s = __ffs(rest) - 1;  // the staged chunk's slot in the step
      rest &= rest - 1;
      gd = td;
      gi = INT_MAX;
      if (pcc::lex_less(bd[kMaxK - 1], bi[kMaxK - 1], gd, gi)) {
        gd = bd[kMaxK - 1];
        gi = bi[kMaxK - 1];
      }
      if (exclude_self && slots[s0 + s] == tile) {  // uniform per block
        gate_chunk<true>(chunks[i], boxes[i], masks, qx, qy, qz, lane, gd,
                         gi);
      } else {
        gate_chunk<false>(chunks[i], boxes[i], masks, qx, qy, qz, lane, gd,
                          gi);
      }
      // Each thread walks its own set bits; its mask column is its own.
      int wd = 0;
      unsigned m = masks[lane];
      for (;;) {
        while (m == 0 && ++wd < kWords) m = masks[wd * kChunk + lane];
        if (m == 0) break;
        const int j = wd * 32 + __ffs(m) - 1;
        m &= m - 1;
        const Rec r = chunks[i][j];
        const float d = pcc::offset(r, qx, qy, qz).d;
        if (pcc::lex_less(d, r.id, bd[kMaxK - 1], bi[kMaxK - 1])) {
          insert(bd, bi, d, r.id);
        }
      }
    }
  }

  const int64_t o = (static_cast<int64_t>(t) * kChunk + lane) * k;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= lead) {
      out_d[o + (j - lead)] = bd[j];
      out_i[o + (j - lead)] = bi[j];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. q (Pa, 3), b (Pb, 3), cand (nt, w), out (nt,
// 256, k); tiles is a null pointer or (nt,); c_lo and c_hi are null
// pointers (no slot skip) or the search grid's chunk boxes (Pb / 256, 3).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for k outside
// [1, 32] or only one of the boxes.
extern "C" int pcc_refine_knn_straight(const float* q, const float* b,
                                       const int* b_orig, const int* cand,
                                       const int* tiles, const float* c_lo,
                                       const float* c_hi, float* out_d,
                                       int* out_i, int nt, int w, int k,
                                       int exclude_self, void* stream) {
  if (k < 1 || k > kMaxK || (c_lo == nullptr) != (c_hi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  refine_knn_straight_kernel<<<nt, kChunk, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, c_lo, c_hi, out_d, out_i, w, k,
      exclude_self);
  return static_cast<int>(cudaGetLastError());
}

// ctypes entry: registers a thread and resident blocks an SM of K3b;
// returns the CUDA error.
extern "C" int pcc_refine_knn_straight_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(refine_knn_straight_kernel, kChunk, 0, regs, blocks);
}
