// K4: covariance moment sums of each query's exact k-NN set (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:1330
// (_moments_kernel_t) and its entry point refine_pallas.py:1440
// (moments_pallas_t). For each 256-query tile t and each query row with
// k-th neighbour (rk, ik) from K3, walk the candidate chunks cand[t, s],
// s < ncand[t], and add up, over the members (d < rk) | (d == rk & id <= ik),
// the ten sums [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] of the
// query-relative offsets b - q, starting from init[t] when given, else 0.
// Centring on the query keeps the sums free of the cancellation a raw
// sum-of-squares form would have.
//
//   * Distance: pcc::offset (pcc_common.cuh), shared with K3, so the
//     membership test sees the d that K3 stored and a valid row counts
//     exactly k members.
//   * Sums: float32, per thread, in chunk-slot and then row order (the TPU
//     sums each chunk's 256 rows first; results differ by summation order
//     only).
//
// Bound: FP32 ALU: per pair 8 flops for the offset and distance and up to
// three compares; a member adds 6 multiplies and 10 adds. Members are k of
// the 256 * ncand pairs a query sees, so the distance and the test
// dominate.
// Design: K1's (one 256-thread block per tile, one query per thread, each
// live chunk staged once in shared memory, ncand as the loop bound,
// tiles[] for global ids); the per-thread state is the ten sums in
// registers. TMA and slot batching are left out: this version is meant to
// be right and simple.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

namespace {

using pcc::kChunk;
using pcc::Rec;

constexpr int kMomCh = 10;

__global__ void __launch_bounds__(kChunk)
knn_moments_kernel(const float* __restrict__ q, const float* __restrict__ b,
                   const int* __restrict__ b_orig,
                   const int* __restrict__ cand,
                   const int* __restrict__ tiles,
                   const int* __restrict__ ncand,
                   const float* __restrict__ rk, const int* __restrict__ ik,
                   const float* __restrict__ init, float* __restrict__ out,
                   int w) {
  __shared__ Rec chunk[kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  const float rkv = rk[o];
  const int ikv = ik[o];
  float acc[kMomCh];
#pragma unroll
  for (int m = 0; m < kMomCh; ++m) {
    acc[m] = init != nullptr ? init[o * kMomCh + m] : 0.0f;
  }

  const int live = min(max(ncand[t], 0), w);  // uniform per block
  for (int s = 0; s < live; ++s) {
    const int c = cand[static_cast<int64_t>(t) * w + s];
    __syncthreads();  // every thread is done with the previous chunk
    pcc::stage_chunk(chunk, b, b_orig, c, lane);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const Rec r = chunk[j];
      const pcc::Offset f = pcc::offset(r, qx, qy, qz);
      if (f.d < rkv || (f.d == rkv && r.id <= ikv)) {
        acc[0] = __fadd_rn(acc[0], 1.0f);
        acc[1] = __fadd_rn(acc[1], f.dx);
        acc[2] = __fadd_rn(acc[2], f.dy);
        acc[3] = __fadd_rn(acc[3], f.dz);
        acc[4] = __fadd_rn(acc[4], __fmul_rn(f.dx, f.dx));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(f.dy, f.dy));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(f.dz, f.dz));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(f.dx, f.dy));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(f.dx, f.dz));
        acc[9] = __fadd_rn(acc[9], __fmul_rn(f.dy, f.dz));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMomCh; ++m) out[o * kMomCh + m] = acc[m];
}

}  // namespace

// Plain C entry for ctypes. Arrays are row-major: q (Pa, 3), b (Pb, 3),
// cand (nt, w), ncand (nt,), rk and ik (nt, 256), init and out
// (nt, 256, 10). tiles and init may be null pointers. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_knn_moments(const float* q, const float* b,
                               const int* b_orig, const int* cand,
                               const int* tiles, const int* ncand,
                               const float* rk, const int* ik,
                               const float* init, float* out, int nt, int w,
                               void* stream) {
  if (nt <= 0) return 0;
  knn_moments_kernel<<<nt, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, ncand, rk, ik, init, out, w);
  return static_cast<int>(cudaGetLastError());
}
