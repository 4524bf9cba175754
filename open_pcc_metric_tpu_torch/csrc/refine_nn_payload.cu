// K6: 1-NN refine that also returns the winner's payload row (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:1156
// (_nn_kernel_tp) and its entry point refine_pallas.py:1272
// (refine_nn_pallas_payload). Semantics, not layout: K1 without gate or
// seed (refine_nn.cu) over every slot of cand[t], plus, for each query, the
// PAYLOAD_F = 16 float row of pay (Pb, 16), in the candidates' sorted order,
// at the winning column: the lowest original id among the minimum
// distances. Rows no candidate won (an empty candidate row) get zeros, as
// the TPU kernel's zero-seeded payload.
//
//   * Distance and ties: pcc::offset and pcc::lex_less, as K1.
//   * The TPU kernel selected the payload with an exactly one-hot matmul per
//     chunk (its matrix unit made that cheap). Here the winner's sorted
//     column is kept in a register beside best_i, and an epilogue copies
//     that row with four 16-byte loads: exact, the payload equals a gather
//     at the returned id bit for bit.
//   * exclude_self: as K1, with tile t's global rows t * 256 + lane.
//
// Bound: FP32 ALU, as K1: 9 operations a (query, candidate) pair; the
// payload adds 64 bytes read and 64 written per query, about 0.1 ms at
// 800k queries against the pairs' ~0.2 ms at the probe's width.
// Design: K1's: one block of 256 threads per tile, one query per thread,
// each slot's chunk staged in shared memory and scanned by every thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;

constexpr int kPayload = 16;  // floats per payload row (ops/refine.PAYLOAD_F)

__global__ void __launch_bounds__(kChunk)
refine_nn_payload_kernel(const float* __restrict__ q,
                         const float* __restrict__ b,
                         const int* __restrict__ b_orig,
                         const float* __restrict__ pay,
                         const int* __restrict__ cand,
                         float* __restrict__ out_d, int* __restrict__ out_i,
                         float* __restrict__ out_p, int w, int exclude_self) {
  __shared__ Rec chunk[kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(t) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  float best_d = pcc::inf();
  int best_i = INT_MAX;
  int64_t best_col = -1;  // sorted row of the winner

  for (int s = 0; s < w; ++s) {
    const int c = cand[static_cast<int64_t>(t) * w + s];
    __syncthreads();  // every thread is done with the previous chunk
    pcc::stage_chunk(chunk, b, b_orig, c, lane);
    __syncthreads();
    const int self_j = (exclude_self && c == t) ? lane : -1;
    int win_j = -1;  // winner within this chunk, if any
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const Rec r = chunk[j];
      float d = pcc::offset(r, qx, qy, qz).d;
      if (j == self_j) d = pcc::inf();
      if (pcc::lex_less(d, r.id, best_d, best_i)) {
        best_d = d;
        best_i = r.id;
        win_j = j;
      }
    }
    if (win_j >= 0) best_col = static_cast<int64_t>(c) * kChunk + win_j;
  }
  out_d[row] = best_d;
  out_i[row] = best_i;

  float4* dst = reinterpret_cast<float4*>(out_p + row * kPayload);
  if (best_col >= 0) {
    const float4* src =
        reinterpret_cast<const float4*>(pay + best_col * kPayload);
#pragma unroll
    for (int k = 0; k < kPayload / 4; ++k) dst[k] = src[k];
  } else {
#pragma unroll
    for (int k = 0; k < kPayload / 4; ++k)
      dst[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

// Plain C entry for ctypes. pay and out_p must be 16-byte aligned (the
// wrapper checks). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok).
extern "C" int pcc_refine_nn_payload(const float* q, const float* b,
                                     const int* b_orig, const float* pay,
                                     const int* cand, float* out_d,
                                     int* out_i, float* out_p, int nt, int w,
                                     int exclude_self, void* stream) {
  if (nt <= 0) return 0;
  refine_nn_payload_kernel<<<nt, kChunk, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, pay, cand, out_d, out_i, out_p, w, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
