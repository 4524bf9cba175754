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
// The matrix holds no NaN.
//
// Bound: the block-wide reductions. Reading the matrix once is nta * ncb * 4
// bytes; the work is nta * ncb compares for the first pick and a few per
// later pick, so on paper both are a fraction of a millisecond at 800k
// (3328 x 1920). What takes the time is `cap` rounds of a 256-thread
// lexicographic argmin, each a warp shuffle tree and one barrier.
// Design: one 256-thread block per row. The row is staged in shared memory
// (dynamic, up to the opt-in limit; a longer row is read from global
// memory). No entry is ever written: each thread keeps the lexicographic
// minimum of ITS columns (c = tid, tid + 256, ...) above the last pick it
// owned, so a round is one block reduction of 256 candidates, and only the
// thread that owned the pick rescans its columns, for the next one above
// it. The warps' results go to a shared array with two halves used in
// turns, so a round needs one barrier. A round whose minimum is +inf ends
// the row: the rest is 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A staged row's bytes: below the opt-in limit of one block (232448),
// leaving room for the static arrays.
constexpr int kMaxSharedBytes = 224 * 1024;

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
select_candidates_kernel(const float* __restrict__ lb, int* __restrict__ out,
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
// cudaGetLastError() (0 = ok).
extern "C" int pcc_select_candidates(const float* lb, int* out, int nta,
                                     int ncb, int cap, void* stream) {
  if (nta <= 0 || cap <= 0) return 0;
  const size_t bytes = static_cast<size_t>(ncb) * sizeof(float);
  const int staged = bytes <= kMaxSharedBytes;
  const size_t shared = staged ? bytes : 0;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_candidates_kernel<<<nta, kThreads, shared,
                             static_cast<cudaStream_t>(stream)>>>(
      lb, out, ncb, cap, staged);
  return static_cast<int>(cudaGetLastError());
}
