// K7: the adaptive schedule's 1-NN refine over augmented candidate records,
// with expanded-norm distances (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_adaptive.py:76
// (_adaptive_kernel) and its entry point refine_adaptive.py:249
// (adaptive_refine). Semantics, not layout: for each row r, the tile
// tids[r] of the packed queries, keep the running lexicographic minimum of
// (squared distance, original id) over the first ncand[r] candidate chunks
// cand[r, s], seeded from init when given, else (inf, INT32_MAX).
//
//   * Inputs in the JAX package's coordinate-major layout
//     (ops/refine_adaptive.py pack_queries / pack_candidates): qhat (8, Pa)
//     = [-2x, -2y, -2z, |q|^2, 1, 0, 0, 0] and bhat (8, Pb) = [x, y, z, 1,
//     |b|^2, bitcast(original id), 0, 0]. A thread reads its query's four
//     rows and a chunk's five rows with neighbouring lanes on neighbouring
//     addresses; the id row is read as int bits, never as a float.
//   * Distance: pcc::expanded (pcc_common.cuh), the one K1's expanded mode
//     uses: 1 add + 3 FMA a pair. The TPU kernel took the same sum as one
//     HIGHEST-precision contraction over the 8 rows; both are exact under
//     Cloud.mxu_exact, which the caller (nn_pruned.nn_pruned_sorted) gates.
//   * Ties: the lowest original id wins. The TPU kernel's gate on chunks
//     that improve no query changes no result and is left out.
//   * exclude_self: the pair whose global query row tids[r] * 256 + lane
//     equals the candidate's global row cand * 256 + col counts as d = inf.
//
// Bound: FP32 ALU. Each (query, candidate) pair costs 1 add and 3 FMA
// (7 flops) plus one compare-select, 8 operations against K1's 9, and 20
// bytes of shared memory read as a warp-wide broadcast; global traffic is
// 5 KB per chunk per row.
// Design: K1's (refine_nn.cu): one block of 256 threads per row, one query
// per thread in registers; each live slot stages its chunk's 256 records in
// shared memory once and every thread scans them. The slot loop's bound is
// ncand[r], so gated slots and the P3 tail's unused width cost nothing.
// TMA, wgmma and slot batching are left out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;

struct __align__(16) XRec {
  float x, y, z, sq;  // candidate and |b|^2
};

__global__ void __launch_bounds__(kChunk)
adaptive_refine_kernel(const float* __restrict__ qhat,
                       const float* __restrict__ bhat,
                       const int* __restrict__ cand,
                       const int* __restrict__ ncand,
                       const int* __restrict__ tids,
                       const float* __restrict__ init_d,
                       const int* __restrict__ init_i,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int slots, int64_t pa, int64_t pb, int exclude_self) {
  __shared__ XRec chunk[kChunk];
  __shared__ int chunk_id[kChunk];

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tids[r];
  const int64_t qrow = static_cast<int64_t>(tile) * kChunk + lane;
  const pcc::XQuery q{qhat[qrow], qhat[pa + qrow], qhat[2 * pa + qrow],
                      qhat[3 * pa + qrow]};
  const int* bid = reinterpret_cast<const int*>(bhat + 5 * pb);

  const int64_t o = static_cast<int64_t>(r) * kChunk + lane;
  float best_d = init_d != nullptr ? init_d[o] : pcc::inf();
  int best_i = init_i != nullptr ? init_i[o] : INT_MAX;
  const int live = min(max(ncand[r], 0), slots);  // uniform per block

  for (int s = 0; s < live; ++s) {
    const int c = cand[static_cast<int64_t>(r) * slots + s];
    const int64_t col = static_cast<int64_t>(c) * kChunk + lane;
    __syncthreads();  // every thread is done with the previous chunk
    chunk[lane] = XRec{bhat[col], bhat[pb + col], bhat[2 * pb + col],
                       bhat[4 * pb + col]};
    chunk_id[lane] = bid[col];
    __syncthreads();
    const int self_j = (exclude_self && c == tile) ? lane : -1;
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const XRec b = chunk[j];
      const int id = chunk_id[j];
      float d = pcc::expanded(q, b.x, b.y, b.z, b.sq);
      if (j == self_j) d = pcc::inf();
      if (pcc::lex_less(d, id, best_d, best_i)) {
        best_d = d;
        best_i = id;
      }
    }
  }
  out_d[o] = best_d;
  out_i[o] = best_i;
}

}  // namespace

// Plain C entry for ctypes. init_d/init_i may be null pointers. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_adaptive_refine(const float* qhat, const float* bhat,
                                   const int* cand, const int* ncand,
                                   const int* tids, const float* init_d,
                                   const int* init_i, float* out_d,
                                   int* out_i, int rows, int slots, int pa,
                                   int pb, int exclude_self, void* stream) {
  if (rows <= 0) return 0;
  adaptive_refine_kernel<<<rows, kChunk, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      qhat, bhat, cand, ncand, tids, init_d, init_i, out_d, out_i, slots, pa,
      pb, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
