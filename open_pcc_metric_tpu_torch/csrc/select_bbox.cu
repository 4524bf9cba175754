// K2a: fused bbox lower-bound select, the candidate prologue of the pruned
// searches under prologue="select" (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/select_pallas.py:117
// (_select_kernel) and its entry point select_pallas.py:170
// (select_bbox_pallas). Semantics, not layout: for query tile t, the bound
// lb(t, c) to every search chunk c (pcc::bbox_lb), packed into the unique
// key (bits(lb) & ~low) | c with low = 2^bits - 1; the row's `cap` smallest
// keys in ascending order, written as cand = min(key & low, ncb - 1) and
// lb_sel = the float of key & ~low (the bound rounded down). The (nta, ncb)
// bound matrix is never stored.
//
// Bound: the selection work. The bytes are tiny (24 bytes per box in, 8
// per selected slot out); each (tile, chunk) pair costs 17 FP32 operations
// for its bound and a key pack, and the selection has to look at every
// pair at least once (about 19 operations a pair against 67 TFLOP/s).
// Design, right and simple first: one block of 256 threads per tile, the
// tile's box in registers, the chunk boxes read through L2 (24 bytes a
// chunk, 196 KB at 8192 chunks, shared by every block). The cap-th
// smallest key T is found by a radix select (pcc::radix_select,
// pcc_select.cuh, shared with K2c), 4 passes of 8 bits from the top, each a
// 256-bin histogram in shared memory over the keys that match the prefix
// so far (warp-aggregated atomics: most keys share their high bytes), a
// block scan to pick the bin, and the bound recomputed in every pass
// instead of stored, so no shared array caps ncb. Keys are unique, so
// exactly cap keys are <= T; a fifth pass writes them into the output row
// in arrival order and a bitonic sort in place (pcc::bitonic_sort, in
// global memory, padded virtually with +inf to a power of two, every
// comparator ascending) puts them in order, so no shared array caps `cap`
// either. The selection passes cost about 5x the bound's arithmetic; a
// faster version would keep keys in registers or shared memory when ncb
// allows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_select.cuh"

namespace {

constexpr int kThreads = 256;  // one block per query tile

// Packed key of chunk c for the tile box (alo, ahi).
__device__ __forceinline__ unsigned key_of(const float* alo, const float* ahi,
                                           const float* b_lo,
                                           const float* b_hi, int c,
                                           unsigned high) {
  const float lb = pcc::bbox_lb(alo, ahi, b_lo + 3 * static_cast<int64_t>(c),
                                b_hi + 3 * static_cast<int64_t>(c));
  return (__float_as_uint(lb) & high) | static_cast<unsigned>(c);
}

__global__ void __launch_bounds__(kThreads)
select_bbox_kernel(const float* __restrict__ a_lo,
                   const float* __restrict__ a_hi,
                   const float* __restrict__ b_lo,
                   const float* __restrict__ b_hi, int ncb, int cap,
                   unsigned low, int* cand, float* lb_sel) {
  __shared__ pcc::RadixScratch<kThreads> scratch;
  __shared__ int s_fill;

  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned high = ~low;
  float alo[3], ahi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    alo[d] = a_lo[t * 3 + d];
    ahi[d] = a_hi[t * 3 + d];
  }

  // The cap-th smallest key itself (keys are unique).
  const unsigned kth = pcc::radix_select<kThreads>(
      ncb, cap,
      [&](int c) { return key_of(alo, ahi, b_lo, b_hi, c, high); }, scratch);

  // The cap keys <= kth, in arrival order, into the output row.
  int* row = cand + t * cap;
  if (tid == 0) s_fill = 0;
  __syncthreads();
  for (int c = tid; c < ncb; c += kThreads) {
    const unsigned key = key_of(alo, ahi, b_lo, b_hi, c, high);
    if (key <= kth) row[atomicAdd(&s_fill, 1)] = static_cast<int>(key);
  }
  __syncthreads();
  pcc::bitonic_sort<kThreads>(row, cap);

  float* lrow = lb_sel + t * cap;
  for (int s = tid; s < cap; s += kThreads) {
    const unsigned key = static_cast<unsigned>(row[s]);
    lrow[s] = __uint_as_float(key & high);
    row[s] = min(static_cast<int>(key & low), ncb - 1);
  }
}

}  // namespace

// Plain C entry for ctypes: boxes are (n, 3) float32, cand and lb_sel
// (nta, cap); 1 <= cap <= ncb <= 2^bits. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_select_bbox(const float* a_lo, const float* a_hi,
                               const float* b_lo, const float* b_hi,
                               int* cand, float* lb_sel, int nta, int ncb,
                               int cap, int bits, void* stream) {
  if (nta <= 0) return 0;
  if (cap < 1 || cap > ncb || bits < 1 || bits > 30 || ncb > (1 << bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned low = (1u << bits) - 1u;
  select_bbox_kernel<<<nta, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a_lo, a_hi, b_lo, b_hi, ncb, cap, low, cand, lb_sel);
  return static_cast<int>(cudaGetLastError());
}
