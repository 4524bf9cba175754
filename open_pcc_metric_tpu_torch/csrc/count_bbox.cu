// K2b: fused bbox lower-bound count, the certificate counts of the pruned
// searches under prologue="select" (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/select_pallas.py:133
// (_count_kernel) and its entry point select_pallas.py:220
// (count_bbox_pallas). Semantics, not layout: for query tile t, the number
// of search chunks c whose bound, rounded down to the key resolution
// (bits(lb) & ~low, as K2a packs it), is at most thr[t]. The caller passes
// thr already inflated by count_slack (ops/select.py inflate, in float32);
// the kernel never recomputes it. The (nta, ncb) bound matrix is never
// stored.
//
// Bound: FP32 ALU. The bytes are tiny (28 bytes per tile in, 4 out, 24 per
// chunk); each (tile, chunk) pair costs 17 operations for its bound
// (pcc::bbox_lb, the expression K2a selects with) plus a mask, a compare
// and an add: about 20 operations a pair against 67 TFLOP/s.
// Design: one block of 256 threads per tile, the tile's box and threshold
// in registers, each thread counting a strided share of the chunks (chunk
// boxes read through L2), then a warp-shuffle and shared-memory block sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

namespace {

constexpr int kThreads = 256;  // one block per query tile
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
count_bbox_kernel(const float* __restrict__ a_lo,
                  const float* __restrict__ a_hi,
                  const float* __restrict__ b_lo,
                  const float* __restrict__ b_hi,
                  const float* __restrict__ thr, int ncb, unsigned high,
                  int* __restrict__ out) {
  __shared__ int warp_sums[kWarps];

  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  float alo[3], ahi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    alo[d] = a_lo[t * 3 + d];
    ahi[d] = a_hi[t * 3 + d];
  }
  const float th = thr[t];

  int n = 0;
  for (int c = tid; c < ncb; c += kThreads) {
    const int64_t o = 3 * static_cast<int64_t>(c);
    const float lb = pcc::bbox_lb(alo, ahi, b_lo + o, b_hi + o);
    n += __uint_as_float(__float_as_uint(lb) & high) <= th;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    out[t] = total;
  }
}

}  // namespace

// Plain C entry for ctypes: boxes are (n, 3) float32, thr and out (nta,);
// ncb <= 2^bits. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok).
extern "C" int pcc_count_bbox(const float* a_lo, const float* a_hi,
                              const float* b_lo, const float* b_hi,
                              const float* thr, int* out, int nta, int ncb,
                              int bits, void* stream) {
  if (nta <= 0) return 0;
  if (ncb < 1 || bits < 1 || bits > 30 || ncb > (1 << bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned high = ~((1u << bits) - 1u);
  count_bbox_kernel<<<nta, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a_lo, a_hi, b_lo, b_hi, thr, ncb, high, out);
  return static_cast<int>(cudaGetLastError());
}
