// K1: count-gated, seeded 1-NN refine over Morton candidate chunks (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:575
// (_nn_kernel_t) and its entry point refine_pallas.py:728
// (refine_nn_pallas_t). Semantics, not layout: for each 256-query tile t
// and each of its query rows, keep the running lexicographic minimum of
// (squared distance, original id) over the candidate chunks cand[t, s],
// s < ncand[t], seeded from init when given, else (inf, INT32_MAX).
//
//   * Distance: pcc::offset (pcc_common.cuh), the one rounding K1, K3 and
//     K4 share; it equals the uncontracted eager PyTorch reference bit for
//     bit.
//   * Ties: the lowest original id wins.
//   * exclude_self: the column whose global sorted row equals the query's
//     global sorted row (tiles[t] * 256 + lane) counts as d = inf, as in the
//     TPU kernel. tiles[] carries global tile ids, so compacted tier calls
//     read their queries in place and still exclude the right column.
//
// Bound: FP32 ALU. Each (query, candidate) pair costs 8 flops (3 sub,
// 3 mul, 2 add) plus one compare-select, against 16 bytes of shared memory
// read as a warp-wide broadcast; global traffic is 4 KB per chunk per tile.
// Design: one block of 256 threads per tile, one query row per thread held
// in registers; each live slot stages its chunk's 256 (x, y, z, id)
// records in shared memory once, and every thread scans all 256 of them,
// so each staged record serves 256 pairs. The per-tile ncand gate is the
// loop bound, so gated slots cost nothing. TMA, wgmma and slot batching
// are left out: this version is meant to be right and simple.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;

__global__ void __launch_bounds__(kChunk)
refine_nn_kernel(const float* __restrict__ q, const float* __restrict__ b,
                 const int* __restrict__ b_orig, const int* __restrict__ cand,
                 const int* __restrict__ tiles, const int* __restrict__ ncand,
                 const float* __restrict__ init_d,
                 const int* __restrict__ init_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int w, int exclude_self) {
  __shared__ Rec chunk[kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  float best_d = init_d != nullptr ? init_d[o] : pcc::inf();
  int best_i = init_i != nullptr ? init_i[o] : INT_MAX;

  int live = w;
  if (ncand != nullptr) live = min(max(ncand[t], 0), w);  // uniform per block

  for (int s = 0; s < live; ++s) {
    const int c = cand[static_cast<int64_t>(t) * w + s];
    __syncthreads();  // every thread is done with the previous chunk
    pcc::stage_chunk(chunk, b, b_orig, c, lane);
    __syncthreads();
    const int self_j = (exclude_self && c == tile) ? lane : -1;
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const Rec r = chunk[j];
      float d = pcc::offset(r, qx, qy, qz).d;
      if (j == self_j) d = pcc::inf();
      if (pcc::lex_less(d, r.id, best_d, best_i)) {
        best_d = d;
        best_i = r.id;
      }
    }
  }
  out_d[o] = best_d;
  out_i[o] = best_i;
}

}  // namespace

// Plain C entry for ctypes. Optional arrays are null pointers. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_refine_nn(const float* q, const float* b, const int* b_orig,
                             const int* cand, const int* tiles,
                             const int* ncand, const float* init_d,
                             const int* init_i, float* out_d, int* out_i,
                             int nt, int w, int exclude_self, void* stream) {
  if (nt <= 0) return 0;
  refine_nn_kernel<<<nt, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, ncand, init_d, init_i, out_d, out_i, w,
      exclude_self);
  return static_cast<int>(cudaGetLastError());
}
