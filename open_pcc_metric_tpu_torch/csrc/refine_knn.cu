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
// plus the insertions: a pair that passes the gate costs a 32-step
// compare-and-carry through the buffer, and a warp pays it whenever any of
// its threads inserts. Insertions are frequent while the probe fills the
// buffers and rare in the seeded extension and tiers.
// Design: K1's (one 256-thread block per tile, one query per thread, each
// live chunk staged once in shared memory as (x, y, z, id), ncand as the
// loop bound, tiles[] for global ids). The per-thread buffer is kMaxK
// (d, id) pairs in registers: every index is a compile-time constant after
// unrolling, so nothing spills to local memory. A k < kMaxK buffer is
// right-aligned behind kMaxK - k (-inf, INT_MIN) pairs that no candidate
// can displace, so the gate always reads the last register pair and one
// build serves every k <= 32. The insertion is a branch-free carry: at
// each position keep the smaller of (carried, held) and carry the larger
// on. TMA, wgmma and slot batching are left out: this version is meant to
// be right and simple.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;

constexpr int kMaxK = 32;

__global__ void __launch_bounds__(kChunk)
refine_knn_kernel(const float* __restrict__ q, const float* __restrict__ b,
                  const int* __restrict__ b_orig, const int* __restrict__ cand,
                  const int* __restrict__ tiles,
                  const int* __restrict__ ncand,
                  const float* __restrict__ init_d,
                  const int* __restrict__ init_i, float* __restrict__ out_d,
                  int* __restrict__ out_i, int w, int k, int exclude_self) {
  __shared__ Rec chunk[kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  const int lead = kMaxK - k;  // sentinel pairs in front of the live buffer
  const int64_t o = (static_cast<int64_t>(t) * kChunk + lane) * k;
  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < lead) {
      bd[j] = -pcc::inf();
      bi[j] = INT_MIN;
    } else if (init_d != nullptr) {
      bd[j] = init_d[o + (j - lead)];
      bi[j] = init_i[o + (j - lead)];
    } else {
      bd[j] = pcc::inf();
      bi[j] = INT_MAX;
    }
  }

  int live = w;
  if (ncand != nullptr) live = min(max(ncand[t], 0), w);  // uniform per block

  for (int s = 0; s < live; ++s) {
    const int c = cand[static_cast<int64_t>(t) * w + s];
    __syncthreads();  // every thread is done with the previous chunk
    pcc::stage_chunk(chunk, b, b_orig, c, lane);
    __syncthreads();
    const int self_j = (exclude_self && c == tile) ? lane : -1;
#pragma unroll 2
    for (int j = 0; j < kChunk; ++j) {
      const Rec r = chunk[j];
      const float d = pcc::offset(r, qx, qy, qz).d;
      if (j != self_j && d < pcc::inf() &&
          pcc::lex_less(d, r.id, bd[kMaxK - 1], bi[kMaxK - 1])) {
        float cd = d;
        int ci = r.id;
#pragma unroll
        for (int m = 0; m < kMaxK; ++m) {
          const bool lt = pcc::lex_less(cd, ci, bd[m], bi[m]);
          const float hd = bd[m];
          const int hi = bi[m];
          bd[m] = lt ? cd : hd;
          bi[m] = lt ? ci : hi;
          cd = lt ? hd : cd;
          ci = lt ? hi : ci;
        }
      }
    }
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
// pointers. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for k outside
// [1, 32].
extern "C" int pcc_refine_knn(const float* q, const float* b,
                              const int* b_orig, const int* cand,
                              const int* tiles, const int* ncand,
                              const float* init_d, const int* init_i,
                              float* out_d, int* out_i, int nt, int w, int k,
                              int exclude_self, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  refine_knn_kernel<<<nt, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, ncand, init_d, init_i, out_d, out_i, w, k,
      exclude_self);
  return static_cast<int>(cudaGetLastError());
}
