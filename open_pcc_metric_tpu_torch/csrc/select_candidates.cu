// K2c: each row's `cap` smallest entries of a materialised lower-bound
// matrix (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:491
// (_select_kernel) and its entry point refine_pallas.py:503
// (select_candidates_pallas). Semantics, not layout: the TPU kernel runs
// `cap` rounds over a row; each round picks the lowest column among the
// row's minima, writes it, and masks that entry to +inf. So:
//
//   * while a row has finite entries left, round j picks the j-th entry of
//     the row's ascending (value, column) order: ties go to the lowest
//     column, as in a stable sort;
//   * once every finite entry has been picked, every entry left is +inf,
//     masked or not, and each further round picks column 0, the lowest
//     column among them. The row of a query tile with no valid row is all
//     +inf (pcc::bbox_lb), so it comes out as 0, 0, ...;
//   * the TPU kernel clamps a pick to ncb - 1 (its rows are padded with
//     +inf to a multiple of 128 columns); no pick here can exceed it.
//
// The matrix holds no NaN. -0.0 and +0.0 compare equal, so they tie.
//
// Bound: reading the matrix once. That is nta * ncb * 4 bytes (30 MB at
// 800k, 3328 x 1920: 0.008 ms at 3.35 TB/s) against nta * ncb compares;
// the picks are a small fraction. A design that pays per pick (the TPU
// kernel's rounds, and this file's first design: one block argmin and one
// barrier a pick) is 20x the bound at cap 32 and 300x at cap 512.
// Design: one 256-thread block per row, a radix select instead of rounds.
//   * The row is read once into shared memory as order-preserving keys
//     (-0.0 made +0.0, then the sign bit flipped on positives and every bit
//     on negatives, so unsigned order is float order), counting its f
//     finite entries; c = min(cap, f) picks come from the row, the rest
//     are 0.
//   * The key T of the c-th smallest entry comes from pcc::radix_select
//     (pcc_select.cuh, shared with K2a): 4 passes of 8 bits, each a
//     256-bin histogram of the shared keys and a block scan, independent of
//     cap. It also gives how many entries equal to T are among the c.
//   * Every entry below T is taken (any order), then the lowest columns
//     equal to T, found by a block prefix count in column order: exactly
//     the stable order's first c entries. K2a's packed key (value bits with
//     the column in the low bits) would reorder values that differ in
//     their low bits only, so the pairs are kept whole: (key << 32) |
//     column, 64 bits.
//   * The c pairs are sorted in shared memory (pcc::bitonic_sort, about
//     log2(c)^2 / 2 barriers), then written; then the zeros.
// A row whose keys and pairs do not fit the shared-memory limit takes the
// first design (below), which reads the row from device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_select.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A row's shared bytes: below the opt-in limit of one block (232448),
// leaving room for the static arrays.
constexpr int kMaxSharedBytes = 224 * 1024;

// The row's entry as an unsigned key in the order of the floats.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
select_candidates_radix(const float* __restrict__ lb, int* __restrict__ out,
                        int ncb, int cap) {
  // min(cap, ncb) (key, column) pairs, then ncb keys.
  extern __shared__ unsigned long long pairs[];
  __shared__ pcc::RadixScratch<kThreads> scratch;
  __shared__ int s_fill;

  const int tid = threadIdx.x;
  unsigned* keys = reinterpret_cast<unsigned*>(pairs + min(cap, ncb));
  const float* row = lb + static_cast<int64_t>(blockIdx.x) * ncb;
  int finite = 0;
  for (int i = tid; i < ncb; i += kThreads) {
    const float v = row[i];
    keys[i] = order_key(v);
    finite += v < pcc::inf();
  }
  int f;  // the row's finite entries; the scan's barriers publish keys[]
  pcc::block_inclusive_scan<kThreads>(finite, scratch.warp_sums, &f);
  const int c = min(cap, f);  // uniform per block
  int* picks = out + static_cast<int64_t>(blockIdx.x) * cap;
  if (c > 0) {
    int ties;
    const unsigned kth = pcc::radix_select<kThreads>(
        ncb, c, [&](int i) { return keys[i]; }, scratch, &ties);
    const int below = c - ties;  // entries under kth, all of them picked
    if (tid == 0) s_fill = 0;
    __syncthreads();
    for (int i = tid; i < ncb; i += kThreads) {
      const unsigned k = keys[i];
      if (k < kth) {
        pairs[atomicAdd(&s_fill, 1)] =
            (static_cast<unsigned long long>(k) << 32) | static_cast<unsigned>(i);
      }
    }
    // The first `ties` columns whose key is kth, in column order.
    int taken = 0;  // uniform per block
    for (int base = 0; base < ncb && taken < ties; base += kThreads) {
      const int i = base + tid;
      const int tie = i < ncb && keys[i] == kth;
      int total;
      const int incl =
          pcc::block_inclusive_scan<kThreads>(tie, scratch.warp_sums, &total);
      if (tie && taken + incl <= ties) {
        pairs[below + taken + incl - 1] =
            (static_cast<unsigned long long>(kth) << 32) |
            static_cast<unsigned>(i);
      }
      taken += total;
    }
    __syncthreads();
    pcc::bitonic_sort<kThreads>(pairs, c);
    for (int j = tid; j < c; j += kThreads) {
      picks[j] = static_cast<int>(pairs[j] & 0xFFFFFFFFull);
    }
  }
  for (int j = c + tid; j < cap; j += kThreads) picks[j] = 0;
}

// The first design, for rows wider than the shared-memory limit: `cap`
// rounds of a 256-thread lexicographic argmin, each a warp shuffle tree and
// one barrier. No entry is ever written: each thread keeps the
// lexicographic minimum of ITS columns (c = tid, tid + 256, ...) above the
// last pick it owned, so a round is one block reduction of 256 candidates,
// and only the thread that owned the pick rescans its columns, for the
// next one above it. The warps' results go to a shared array with two
// halves used in turns, so a round needs one barrier. A round whose
// minimum is +inf ends the row: the rest is 0. The row is staged in shared
// memory when it fits (`staged`), else read from device memory.

// The lexicographically smallest (row[c], c) over the columns
// c = tid, tid + kThreads, ... that lies above (lv, lc) in that order; +inf
// and INT_MAX when there is none.
__device__ __forceinline__ void next_above(const float* row, int ncb, int tid,
                                           float lv, int lc, float& bv,
                                           int& bc) {
  bv = pcc::inf();
  bc = INT_MAX;
  for (int c = tid; c < ncb; c += kThreads) {
    const float v = row[c];
    if (pcc::lex_less(lv, lc, v, c) && pcc::lex_less(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
select_candidates_rounds(const float* __restrict__ lb, int* __restrict__ out,
                         int ncb, int cap, int staged) {
  extern __shared__ float srow[];
  __shared__ float wv[2][kWarps];
  __shared__ int wc[2][kWarps];

  const int tid = threadIdx.x;
  const float* row = lb + static_cast<int64_t>(blockIdx.x) * ncb;
  if (staged) {
    for (int c = tid; c < ncb; c += kThreads) srow[c] = row[c];
    __syncthreads();
    row = srow;
  }
  int* picks = out + static_cast<int64_t>(blockIdx.x) * cap;

  float bv;
  int bc;
  next_above(row, ncb, tid, -pcc::inf(), -1, bv, bc);
  int j = 0;
  for (; j < cap; ++j) {
    float v = bv;
    int c = bc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oc = __shfl_xor_sync(0xffffffffu, c, off);
      if (pcc::lex_less(ov, oc, v, c)) {
        v = ov;
        c = oc;
      }
    }
    const int half = j & 1;
    if ((tid & 31) == 0) {
      wv[half][tid >> 5] = v;
      wc[half][tid >> 5] = c;
    }
    // The other half was last read a round ago, before this barrier.
    __syncthreads();
    v = wv[half][0];
    c = wc[half][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (pcc::lex_less(wv[half][w], wc[half][w], v, c)) {
        v = wv[half][w];
        c = wc[half][w];
      }
    }
    if (!(v < pcc::inf())) break;  // the same (v, c) in every thread
    if (tid == 0) picks[j] = c;
    if (c == bc) next_above(row, ncb, tid, v, c, bv, bc);  // its owner
  }
  for (int r = j + tid; r < cap; r += kThreads) picks[r] = 0;
}

}  // namespace

// Plain C entry for ctypes. lb is (nta, ncb) row-major float32, out (nta,
// cap) int32. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok). `radix` 0 takes the first design whatever
// the row's width (a test argument).
extern "C" int pcc_select_candidates(const float* lb, int* out, int nta,
                                     int ncb, int cap, int radix,
                                     void* stream) {
  if (nta <= 0 || cap <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t radix_bytes =
      static_cast<size_t>(ncb) * sizeof(unsigned) +
      static_cast<size_t>(cap < ncb ? cap : ncb) * sizeof(unsigned long long);
  if (radix && radix_bytes <= kMaxSharedBytes) {
    if (radix_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          select_candidates_radix,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(radix_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    select_candidates_radix<<<nta, kThreads, radix_bytes, st>>>(lb, out, ncb,
                                                               cap);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(ncb) * sizeof(float);
  const int staged = bytes <= kMaxSharedBytes;
  const size_t shared = staged ? bytes : 0;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_candidates_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_candidates_rounds<<<nta, kThreads, shared, st>>>(lb, out, ncb, cap,
                                                          staged);
  return static_cast<int>(cudaGetLastError());
}
