// K3b: ungated, unseeded k-NN refine over Morton candidate chunks, with the
// TPU kernel's chunk gate (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:209
// (_knn_kernel), its group refine_pallas.py:271 (_knn_group) and its entry
// point refine_pallas.py:305 (refine_knn_pallas). Semantics, not layout: for
// each 256-query tile t and each of its query rows, the k lexicographically
// smallest (squared distance, original id) pairs over every candidate chunk
// cand[t, s], s < w, ascending, starting from k copies of (inf, INT32_MAX).
// No seed, no slot gate: the fixed-cap schedule's stage 1
// (ops/knn_pruned.py).
//
//   * Distance and merge rule: K3's (refine_knn.cu). pcc::offset, and a
//     candidate enters iff it is finite and (d, id) <lex (d_k, id_k), the
//     buffer's k-th pair. So d and id equal K3's bit for bit, and K4's
//     membership test holds on them.
//   * exclude_self as in K3, on global rows (tiles[t] * 256 + lane).
//   * A row must not repeat a chunk: the insertion keeps a second copy of a
//     point (the TPU merge, which masks by id, would not). The fixed
//     schedule's candidates repeat chunk 0 only on tiles without a valid
//     row, whose results are discarded.
//
// The chunk gate of the TPU kernel (refine_pallas.py:228-243): a chunk is
// merged only if some query's chunk minimum beats its k-th pair, ties
// broken by the lower id. Here, per chunk: a first pass in which each
// thread takes its chunk's lexicographic minimum over the finite
// distances; one __syncthreads_or over "my minimum beats my k-th"; and, only
// if some thread needs it, the second pass with K3's register insertion,
// which each thread runs only if its own minimum passed. The first pass
// costs K1's scan; the insertions, a 32-step compare-and-carry that a warp
// pays whenever any of its threads inserts, are skipped for every thread
// and chunk that cannot change the buffer. The results are those of K3
// ungated: a candidate that enters during the second pass beats the k-th
// pair the first pass compared against.
//
// Bound: FP32 ALU, as K1 (8 flops and a compare per pair per pass), plus
// the insertions of the chunks that pass the gate.
// Design: K3's (one 256-thread block per tile, one query per thread, each
// chunk staged once in shared memory as (x, y, z, id), the k-buffer in 32
// register pairs, right-aligned behind (-inf, INT_MIN) pairs for k < 32).
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
refine_knn_straight_kernel(const float* __restrict__ q,
                           const float* __restrict__ b,
                           const int* __restrict__ b_orig,
                           const int* __restrict__ cand,
                           const int* __restrict__ tiles,
                           float* __restrict__ out_d, int* __restrict__ out_i,
                           int w, int k, int exclude_self) {
  __shared__ Rec chunk[kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
  const int* slots = cand + static_cast<int64_t>(t) * w;

  const int lead = kMaxK - k;  // sentinel pairs in front of the live buffer
  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    bd[j] = j < lead ? -pcc::inf() : pcc::inf();
    bi[j] = j < lead ? INT_MIN : INT_MAX;
  }

  for (int s = 0; s < w; ++s) {
    const int c = slots[s];
    __syncthreads();  // every thread is done with the previous chunk
    pcc::stage_chunk(chunk, b, b_orig, c, lane);
    __syncthreads();
    const int self_j = (exclude_self && c == tile) ? lane : -1;
    float min_d = pcc::inf();
    int min_i = INT_MAX;
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const Rec r = chunk[j];
      const float d = pcc::offset(r, qx, qy, qz).d;
      if (j != self_j && d < pcc::inf() &&
          pcc::lex_less(d, r.id, min_d, min_i)) {
        min_d = d;
        min_i = r.id;
      }
    }
    const bool mine =
        pcc::lex_less(min_d, min_i, bd[kMaxK - 1], bi[kMaxK - 1]);
    if (!__syncthreads_or(mine) || !mine) continue;
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
// 256, k); tiles is a null pointer or (nt,). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for k outside [1, 32].
extern "C" int pcc_refine_knn_straight(const float* q, const float* b,
                                       const int* b_orig, const int* cand,
                                       const int* tiles, float* out_d,
                                       int* out_i, int nt, int w, int k,
                                       int exclude_self, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  refine_knn_straight_kernel<<<nt, kChunk, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, out_d, out_i, w, k, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
