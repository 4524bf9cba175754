// K5: brute-force 1-NN, the lowest-index nearest row of b for every row of a
// (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/nn_pallas.py:40 (_kernel)
// and its entry point nn_pallas.py:77 (nn_argmin). Semantics, not layout:
// for every query row i of a, the lexicographic minimum of (squared
// distance, row index j) over all rows j of b; with exclude_self the pair
// j == i counts as d = inf.
//
//   * Distance: pcc::offset (pcc_common.cuh), the rounding K1, K3 and K4
//     share and the plain version (ops/nn.py nn_chunked) evaluates, so d is
//     bit-identical to both and is returned as it is. The TPU kernel
//     minimised the expanded-norm proxy |b|^2 - 2 a.b instead, because its
//     matrix unit made a.b cheap; that proxy is inexact for float clouds
//     (the TPU package recomputes d at the chosen index afterwards,
//     ops/nn.py:156-160), and TF32 tensor cores would make it worse. It is
//     not carried over.
//   * Ties: the lowest j wins (pcc::lex_less on (d, j)).
//
// Bound: FP32 ALU. Every pair costs 3 sub, 3 mul, 2 add and a compare
// (about 9 operations) and there are Na * Nb pairs, while the bytes are
// (Na + Nb) * 12 in and Na * 8 out: at 61440 x 61440 the operations bound
// (~0.5 ms at 67 TFLOP/s) is about 860 times the bytes bound.
// Design: one thread per query row, held in registers; b is staged through
// shared memory 1024 rows at a time as 16-byte (x, y, z, j) records, read
// as warp-wide broadcasts (one shared load per pair); the running (d, j)
// minimum stays in registers; the stage loop is unrolled 16 times. A
// small cloud has few query blocks (61440 rows make 240 blocks of 256
// threads on 132 SMs), so b's rows are split over gridDim.y: each split
// writes its partial minimum and a second kernel merges them per query,
// which is exact because the lexicographic minimum is associative.
// exclude_self is a template argument, so cross searches carry no
// diagonal test.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::Rec;

constexpr int kThreads = 256;  // query rows per block
constexpr int kStage = 1024;   // b rows per shared-memory stage (16 KB)

template <bool kExcludeSelf>
__global__ void __launch_bounds__(kThreads)
nn_brute_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int na, int nb, int span, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  __shared__ Rec stage[kStage];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < na;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = a[static_cast<int64_t>(i) * 3 + 0];
    qy = a[static_cast<int64_t>(i) * 3 + 1];
    qz = a[static_cast<int64_t>(i) * 3 + 2];
  }
  const int j0 = blockIdx.y * span;
  const int j1 = min(nb, j0 + span);
  float best_d = pcc::inf();
  int best_i = INT_MAX;

  for (int t = j0; t < j1; t += kStage) {
    const int m = min(kStage, j1 - t);
    __syncthreads();  // every thread is done with the previous stage
    for (int s = threadIdx.x; s < m; s += kThreads) {
      const int64_t src = static_cast<int64_t>(t + s) * 3;
      stage[s] = Rec{b[src + 0], b[src + 1], b[src + 2], t + s};
    }
    __syncthreads();
#pragma unroll 16  // 8 spilled a few bytes at the 32 registers ptxas chose
    for (int s = 0; s < m; ++s) {
      const Rec r = stage[s];
      float d = pcc::offset(r, qx, qy, qz).d;
      if (kExcludeSelf && r.id == i) d = pcc::inf();
      if (pcc::lex_less(d, r.id, best_d, best_i)) {
        best_d = d;
        best_i = r.id;
      }
    }
  }
  if (live) {
    const int64_t o = static_cast<int64_t>(blockIdx.y) * na + i;
    out_d[o] = best_d;
    out_i[o] = best_i;
  }
}

// Lexicographic minimum over the splits' partial results of each query.
__global__ void __launch_bounds__(kThreads)
nn_merge_kernel(const float* __restrict__ part_d,
                const int* __restrict__ part_i, int na, int splits,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= na) return;
  float best_d = part_d[i];
  int best_i = part_i[i];
  for (int s = 1; s < splits; ++s) {
    const int64_t o = static_cast<int64_t>(s) * na + i;
    if (pcc::lex_less(part_d[o], part_i[o], best_d, best_i)) {
      best_d = part_d[o];
      best_i = part_i[o];
    }
  }
  out_d[i] = best_d;
  out_i[i] = best_i;
}

}  // namespace

// Plain C entry for ctypes. b's rows are cut into `splits` ranges of `span`
// rows; with splits > 1 the partial minima go to part_d / part_i (splits x
// na) and are merged into out_d / out_i, else they are written there
// directly and the part buffers may be null. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_nn_brute(const float* a, const float* b, float* part_d,
                            int* part_i, float* out_d, int* out_i, int na,
                            int nb, int span, int splits, int exclude_self,
                            void* stream) {
  if (na <= 0 || nb <= 0 || splits <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pd = splits > 1 ? part_d : out_d;
  int* pi = splits > 1 ? part_i : out_i;
  const dim3 grid((na + kThreads - 1) / kThreads, splits);
  if (exclude_self) {
    nn_brute_kernel<true><<<grid, kThreads, 0, st>>>(a, b, na, nb, span, pd,
                                                     pi);
  } else {
    nn_brute_kernel<false><<<grid, kThreads, 0, st>>>(a, b, na, nb, span, pd,
                                                      pi);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  nn_merge_kernel<<<(na + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part_d, part_i, na, splits, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}
