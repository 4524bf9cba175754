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
//
// Design: K1's (refine_nn.cu), through the pieces of pcc_nn.cuh. The first
// design was K1's first one (one chunk staged between two barriers, every
// record scanned) with the winner's column in an int64 register updated at
// every improving candidate: 5x K1 ungated on the same stage-1 table.
//   * Steps: up to 8 chunks staged between one pair of barriers; each
//     thread takes a chunk's (d, id, column) minimum and folds it into its
//     running best once, so the winner's sorted row, chunk * 256 + column
//     (an int32), is written once a chunk at most.
//   * Word skip: a warp skips a staged word of 32 records whose box every
//     row is bounded away from by more than its best d (pcc::point_box_lb
//     never exceeds pcc::offset's d, so the skip is exact on any cloud).
//     K6 is unseeded, so a tile's first chunk skips nothing.
//   * One block a tile: the payload schedule calls K6 at stage-1 shapes,
//     thousands of tiles of `cap` slots, which fill the card unsplit.
//   * Epilogue: the winner's payload row with four 16-byte loads and
//     stores, zeros for a row that no candidate won.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

namespace {

using pcc::kChunk;
namespace nn = pcc::nn;

constexpr int kPayload = 16;  // floats per payload row (ops/refine.PAYLOAD_F)

__global__ void __launch_bounds__(kChunk)
refine_nn_payload_kernel(const float* __restrict__ q,
                         const float* __restrict__ b,
                         const int* __restrict__ b_orig,
                         const float* __restrict__ pay,
                         const int* __restrict__ cand,
                         float* __restrict__ out_d, int* __restrict__ out_i,
                         float* __restrict__ out_p, int w, int exclude_self) {
  __shared__ nn::Staged<false> st;

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(t) * kChunk + lane;
  const nn::Query qq =
      nn::make_query(q[row * 3 + 0], q[row * 3 + 1], q[row * 3 + 2]);

  nn::Best best{pcc::inf(), INT_MAX, -1};
  const auto stage = [&](int s, int c) {
    nn::stage_points(st, s, b, b_orig, c, lane);
  };
  nn::walk<false, true>(st, stage, cand + static_cast<int64_t>(t) * w, 0, w,
                        exclude_self ? t : -1, qq, lane, best);
  out_d[row] = best.d;
  out_i[row] = best.i;

  float4* dst = reinterpret_cast<float4*>(out_p + row * kPayload);
  if (best.col >= 0) {
    const float4* src = reinterpret_cast<const float4*>(
        pay + static_cast<int64_t>(best.col) * kPayload);
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

// Registers a thread and resident blocks an SM of the kernel (0 = ok).
extern "C" int pcc_refine_nn_payload_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(refine_nn_payload_kernel, kChunk, 0, regs, blocks);
}
