// K1b: ungated, unseeded 1-NN refine over Morton candidate chunks, g chunks
// a step (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:77
// (_nn_kernel), its group refine_pallas.py:128 (_nn_group) and its entry
// point refine_pallas.py:178 (refine_nn_pallas). Semantics, not layout: for
// each 256-query tile t and each of its query rows, the lexicographic
// minimum of (squared distance, original id) over every candidate chunk
// cand[t, s], s < w, starting from (inf, INT32_MAX). No gate, no seed: the
// fixed-cap schedule's stage 1 (ops/nn_pruned.py).
//
//   * Distance: pcc::offset (pcc_common.cuh), K1's rounding, so K1b equals
//     K1 ungated and the plain version bit for bit.
//   * Ties: the lowest original id wins.
//   * exclude_self: the column whose global sorted row equals the query's
//     (tiles[t] * 256 + lane) counts as d = inf, as in the TPU kernel.
//
// The TPU kernel's grid steps over g chunks at a time (8, or the largest
// power of two that divides w), and per chunk it takes each query's chunk
// minimum and the lowest id at it, then merges that pair into the running
// best; its skip gate (refine_pallas.py:100-120) leaves a step's (256, 1)
// column update out when no query improves or ties. That gate is a TPU
// device, where a single-lane column update costs as much as the chunk's
// scan; here the update is one compare-select in a thread's registers, so
// the gate is dropped. It does not change any result.
//
// Bound: FP32 ALU, as K1: 8 flops and one lexicographic compare per
// (query, candidate) pair against a 16-byte shared-memory broadcast; global
// traffic is 4 KB per chunk per tile.
// Design: one block of 256 threads per tile, one query row per thread held
// in registers. A step stages its g chunks' (x, y, z, id) records in shared
// memory together (32 KB at g = 8), so a step costs one pair of barriers
// where K1 pays one per chunk. Per chunk a thread scans the 256 records for
// its chunk minimum (d, lowest id), then merges it lexicographically into
// its running best, as the TPU kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;

constexpr int kMaxG = 8;  // chunks staged a step

__global__ void __launch_bounds__(kChunk)
refine_nn_straight_kernel(const float* __restrict__ q,
                          const float* __restrict__ b,
                          const int* __restrict__ b_orig,
                          const int* __restrict__ cand,
                          const int* __restrict__ tiles,
                          float* __restrict__ out_d, int* __restrict__ out_i,
                          int w, int g, int exclude_self) {
  __shared__ Rec chunks[kMaxG][kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
  const int* slots = cand + static_cast<int64_t>(t) * w;

  float best_d = pcc::inf();
  int best_i = INT_MAX;
  for (int s0 = 0; s0 < w; s0 += g) {
    __syncthreads();  // every thread is done with the previous step's chunks
    for (int s = 0; s < g; ++s) {
      pcc::stage_chunk(chunks[s], b, b_orig, slots[s0 + s], lane);
    }
    __syncthreads();
    for (int s = 0; s < g; ++s) {
      const int self_j = (exclude_self && slots[s0 + s] == tile) ? lane : -1;
      float chunk_d = pcc::inf();
      int chunk_i = INT_MAX;
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        const Rec r = chunks[s][j];
        float d = pcc::offset(r, qx, qy, qz).d;
        if (j == self_j) d = pcc::inf();
        if (pcc::lex_less(d, r.id, chunk_d, chunk_i)) {
          chunk_d = d;
          chunk_i = r.id;
        }
      }
      if (pcc::lex_less(chunk_d, chunk_i, best_d, best_i)) {
        best_d = chunk_d;
        best_i = chunk_i;
      }
    }
  }
  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  out_d[o] = best_d;
  out_i[o] = best_i;
}

}  // namespace

// Plain C entry for ctypes. q (Pa, 3), b (Pb, 3), cand (nt, w) with w a
// multiple of g, 1 <= g <= 8; tiles is a null pointer or (nt,). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 = ok),
// or cudaErrorInvalidValue for a bad g.
extern "C" int pcc_refine_nn_straight(const float* q, const float* b,
                                      const int* b_orig, const int* cand,
                                      const int* tiles, float* out_d,
                                      int* out_i, int nt, int w, int g,
                                      int exclude_self, void* stream) {
  if (g < 1 || g > kMaxG || w % g) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  refine_nn_straight_kernel<<<nt, kChunk, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, out_d, out_i, w, g, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
