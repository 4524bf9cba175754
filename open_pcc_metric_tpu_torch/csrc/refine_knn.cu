// K3: count-gated, seeded k-NN refine over Morton candidate chunks (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:861
// (_knn_kernel_t) and its entry point refine_pallas.py:1046
// (refine_knn_pallas_t). Semantics, not layout: for each 256-query tile t
// and each of its query rows, keep the k lexicographically smallest
// (squared distance, original id) pairs over the candidate chunks
// cand[t, s], s < ncand[t], merged into the seed k-buffer init[t] when
// given, else into k copies of (inf, INT32_MAX). Output rows are ascending.
//
//   * Distance: pcc::offset (pcc_common.cuh), shared with K1 and K4 so that
//     K4's membership test sees the very d this kernel stored.
//   * Tie-aware gate: a candidate enters iff (d, id) <lex (d_k, id_k), the
//     buffer's k-th pair, so a candidate at the k-th distance with a lower
//     id displaces it (the TPU kernel's refine_pallas.py:919-934). The
//     result is the lexicographic k-best, whatever the visit order.
//   * Only finite d enters: a self-excluded column (exclude_self, as in K1)
//     never does, so a buffer with fewer than k finite candidates keeps
//     (inf, INT32_MAX) in its tail.
//   * Chunks are never visited twice within or across the seeded passes, so
//     an insertion needs no duplicate check.
//
// Bound: FP32 ALU, as K1 (8 flops and one lexicographic compare per pair),
// plus the insertions: a pair that enters costs a 32-step compare-and-carry
// through the buffer.
//
// Design: one query row per thread, 256 threads a block. The per-thread
// buffer is kMaxK (d, id) pairs in registers: every index is a compile-time
// constant after unrolling, so nothing spills to local memory. A k < kMaxK
// buffer is right-aligned behind kMaxK - k (-inf, INT_MIN) pairs that no
// candidate can displace, so the gate always reads the last register pair
// and one build serves every k <= 32. The insertion is a branch-free carry:
// at each position keep the smaller of (carried, held) and carry the larger
// on.
//   * Steps and word skip: as K1 (refine_nn.cu), each step stages up to 8
//     chunks between one pair of barriers, with the box of each warp's 32
//     records (a gate word); the gate pass skips a word when each row of
//     the warp is bounded away from its box by more than the row's
//     threshold (pcc::point_box_lb never exceeds a record's d).
//   * Insert only what can enter. A warp pays the 32-step carry whenever
//     any of its threads inserts, and a buffer that is still filling takes
//     nearly every candidate. So each staged chunk takes two passes: a gate
//     pass computes every d and keeps, per thread, a 256-bit mask (8 words
//     in shared memory, the thread's own column) of the candidates that
//     beat the threshold; then each thread walks its own set bits,
//     recomputes d, checks it against the buffer's current k-th pair and
//     carries it in. A warp pays the carry as often as its busiest thread
//     inserts, not as often as any thread does.
//   * A threshold before the flood: the gate compares against the
//     lexicographic minimum of the buffer's k-th pair and a bound (td, ti)
//     that no member of the final k-set exceeds: the seed's k-th pair when
//     there is a seed (in every split: the seed is part of the union). A
//     block some of whose rows have no finite bound (an unseeded probe)
//     first walks its whole live range once more, keeping for each of 32
//     strided groups (column j in group j % 32) the two smallest d. Those
//     64 values belong to 64 distinct candidates, so with T the k-th
//     smallest of them at least k candidates lie at or below T, the final
//     k-th pair is below (T, INT32_MAX), and nothing above it can enter.
//     The whole range, not its first chunk: in bound order the next few
//     chunks still hold many closer candidates. When the range fits one
//     step, the second pass reuses the staged chunks. Dropping candidates
//     that cannot be members does not change the k-set.
//   * Split: as K1 (refine_nn.cu): the host picks S (ops/refine.py
//     split_count: 1 at probe shapes, up to 8 in tier B), block (t, s)
//     walks the s-th of S balanced parts of tile t's live range, and the S
//     blocks of a tile form a thread-block cluster. Each leaves its
//     ascending k-list (256 x k pairs, 61 KB at k = 30, dynamic shared
//     memory) and the leader merges the other S - 1 lists into its register
//     buffer through distributed shared memory, each list in order until
//     its first pair that does not enter. The lexicographic k-best of a
//     union is unique, so any split gives the serial result bit for bit.
//     The seed k-buffer enters exactly once, in split 0: chunks are never
//     visited twice, so there is no duplicate check, and a seed entering
//     every split would duplicate its members.
//   * The buffer, the staging step, the range bound and the gate pass live
//     in pcc_knn.cuh, shared with K3b (refine_knn_straight.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_knn.cuh"

#include <cooperative_groups.h>

#include <climits>

namespace cg = cooperative_groups;

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
refine_knn_kernel(const float* __restrict__ q, const float* __restrict__ b,
                  const int* __restrict__ b_orig, const int* __restrict__ cand,
                  const int* __restrict__ tiles,
                  const int* __restrict__ ncand,
                  const float* __restrict__ init_d,
                  const int* __restrict__ init_i, float* __restrict__ out_d,
                  int* __restrict__ out_i, int w, int k, int exclude_self,
                  int splits) {
  __shared__ Rec chunks[kStage][kChunk];
  __shared__ float boxes[kStage][kWords * 6];  // each gate word's box
  __shared__ unsigned masks[kWords * kChunk];  // column lane: own thread's
  extern __shared__ float part[];  // splits > 1: k rows of 256 d, then of id

  const int t = blockIdx.x / splits;
  const int split = blockIdx.x - t * splits;  // the block's cluster rank
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  const int lead = kMaxK - k;  // sentinel pairs in front of the live buffer
  const int64_t o = (static_cast<int64_t>(t) * kChunk + lane) * k;
  int live = w;
  if (ncand != nullptr) live = min(max(ncand[t], 0), w);  // uniform per block
  const int begin = pcc::split_begin(live, split, splits);
  const int end = pcc::split_begin(live, split + 1, splits);
  const int* slots = cand + static_cast<int64_t>(t) * w;

  // (td, ti): no member of the final k-set is lexicographically above it.
  float td = pcc::inf();
  int ti = INT_MAX;
  if (init_d != nullptr) {
    td = init_d[o + k - 1];
    ti = init_i[o + k - 1];
  }
  bool staged = false;  // the threshold pass left the one step staged
  if (__syncthreads_or(td == pcc::inf())) {  // uniform per block
    float m1[kGroups], m2[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) m1[g] = m2[g] = pcc::inf();
    for (int s0 = begin; s0 < end; s0 += kStage) {
      const int n = min(kStage, end - s0);
      stage_step(chunks, boxes, b, b_orig, slots + s0, n, lane);
      for (int s = 0; s < n; ++s) {
        if (exclude_self && slots[s0 + s] == tile) {
          group_two_min<true>(chunks[s], qx, qy, qz, lane, m1, m2);
        } else {
          group_two_min<false>(chunks[s], qx, qy, qz, lane, m1, m2);
        }
      }
    }
    staged = end - begin <= kStage;
    const float bound = kth_of_groups(m1, m2, k);
    if (bound < td) {
      td = bound;
      ti = INT_MAX;
    }
  }

  const bool seeded = init_d != nullptr && split == 0;  // the seed enters once
  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < lead) {
      bd[j] = -pcc::inf();
      bi[j] = INT_MIN;
    } else if (seeded) {
      bd[j] = init_d[o + (j - lead)];
      bi[j] = init_i[o + (j - lead)];
    } else {
      bd[j] = pcc::inf();
      bi[j] = INT_MAX;
    }
  }

  for (int s0 = begin; s0 < end; s0 += kStage) {
    const int n = min(kStage, end - s0);
    if (!staged) stage_step(chunks, boxes, b, b_orig, slots + s0, n, lane);
    for (int s = 0; s < n; ++s) {
      float gd = td;
      int gi = ti;
      if (pcc::lex_less(bd[kMaxK - 1], bi[kMaxK - 1], gd, gi)) {
        gd = bd[kMaxK - 1];
        gi = bi[kMaxK - 1];
      }
      if (exclude_self && slots[s0 + s] == tile) {  // uniform per block
        gate_chunk<true>(chunks[s], boxes[s], masks, qx, qy, qz, lane, gd,
                         gi);
      } else {
        gate_chunk<false>(chunks[s], boxes[s], masks, qx, qy, qz, lane, gd,
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
        const Rec r = chunks[s][j];
        const float d = pcc::offset(r, qx, qy, qz).d;
        if (pcc::lex_less(d, r.id, bd[kMaxK - 1], bi[kMaxK - 1])) {
          insert(bd, bi, d, r.id);
        }
      }
    }
  }

  if (splits > 1) {
    float* part_d = part;
    int* part_i = reinterpret_cast<int*>(part + k * kChunk);
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j >= lead) {
        part_d[(j - lead) * kChunk + lane] = bd[j];
        part_i[(j - lead) * kChunk + lane] = bi[j];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every split's k-list is in its shared memory
    if (split == 0) {
      for (int r = 1; r < splits; ++r) {
        const float* rd = cluster.map_shared_rank(part_d, r);
        const int* ri = cluster.map_shared_rank(part_i, r);
        for (int j = 0; j < k; ++j) {  // ascending: stop at the first miss
          const float d = rd[j * kChunk + lane];
          const int id = ri[j * kChunk + lane];
          if (!pcc::lex_less(d, id, bd[kMaxK - 1], bi[kMaxK - 1])) break;
          insert(bd, bi, d, id);
        }
      }
    }
    cluster.sync();  // no block leaves while the leader reads its list
    if (split != 0) return;
  }
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= lead) {
      out_d[o + (j - lead)] = bd[j];
      out_i[o + (j - lead)] = bi[j];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. Arrays are row-major: q (Pa, 3), b (Pb, 3),
// cand (nt, w), init and out (nt, 256, k). Optional arrays are null
// pointers. `splits` (1..8) blocks walk each tile's live range, as a
// cluster when above 1. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for k
// outside [1, 32] or a bad split count.
extern "C" int pcc_refine_knn(const float* q, const float* b,
                              const int* b_orig, const int* cand,
                              const int* tiles, const int* ncand,
                              const float* init_d, const int* init_i,
                              float* out_d, int* out_i, int nt, int w, int k,
                              int exclude_self, int splits, void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  // The partial k-lists of a cluster launch: k (d, id) pairs per query.
  const size_t smem = splits > 1 ? 2 * sizeof(float) * kChunk * k : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        refine_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return pcc::launch_split(refine_knn_kernel, nt, splits, smem,
                           static_cast<cudaStream_t>(stream), q, b, b_orig,
                           cand, tiles, ncand, init_d, init_i, out_d, out_i, w,
                           k, exclude_self, splits);
}

// ctypes entry: registers a thread and resident blocks an SM of K3 at one
// block a tile (no dynamic shared memory); returns the CUDA error.
extern "C" int pcc_refine_knn_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(refine_knn_kernel, kChunk, 0, regs, blocks);
}
