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
//     bit-identical to both and is returned as it is, on float clouds too.
//     The TPU kernel minimised the expanded-norm proxy |b|^2 - 2 a.b
//     instead, because its matrix unit made a.b cheap; that proxy is exact
//     only on clouds that pass Cloud.mxu_exact (the TPU package recomputes
//     d at the chosen index afterwards, ops/nn.py:156-160), while K5 serves
//     every cloud of the default path. It is not carried over.
//   * Ties: the lowest j wins.
//
// Bound: the FP32 issue rate. Every pair costs 3 sub, 3 mul and 2 add
// (under -fmad=false none fuse) and a minimum, and there are Na * Nb
// pairs, while the bytes are (Na + Nb) * 12 in and Na * 8 out: at 61440 x
// 57344 the operations bound is ~900 times the bytes bound. So the design
// spends as few instructions as it can on anything but the 8 flops.
// Design:
//   * kRows = 4 query rows a thread, in registers (rows i = block base +
//     r * kThreads + thread, r < kRows): one broadcast 16-byte shared load
//     of a staged b row serves 4 pairs. 2 and 8 rows were measured once
//     (PERF.md) and moved the time by at most 3.3%: the 8 flops a pair,
//     not the shared loads, set it. 4 keeps twice 8's query blocks for the
//     smaller clouds of the path.
//   * A min-only inner loop: over a run of kRun staged rows (increasing j)
//     each of the 4 rows keeps the run's distances in registers and their
//     minimum (one fminf a pair). Only when a run's minimum is strictly
//     below the row's best does the thread look for the lowest j of the run
//     at that minimum among the registers. That is exact: runs are scanned
//     in increasing j, so a strict < between runs keeps the earlier, lower
//     j on a tie, and the in-run search takes the lowest j; d >= +0 is
//     never NaN (sentinel rows at 1e9 give about 3e18, below FLT_MAX). Each
//     row's best starts at the first row of its range, so a range all at
//     d = inf still names its lowest j, as the plain version does. The
//     diagonal test of exclude_self is compiled only into the code for the
//     runs that can hold a block's diagonal.
//   * b is staged through shared memory kStage rows at a time as (x, y, z,
//     j) records, the stage's tail padded to whole runs with +inf rows
//     (d = inf never beats a best).
//   * Split: a small cloud has few query blocks (61440 rows make 120 blocks
//     of 128 threads x 4 rows on 132 SMs), so b's rows are cut into S
//     balanced ranges (pcc::split_begin; S from ops/nn.py split_count, at most
//     the portable cluster size 8), one block each, and the S blocks of a
//     query block form a thread-block cluster. Each leaves its 4 x kThreads
//     partial (d, j) pairs in shared memory and the leader (rank 0) takes
//     the lexicographic minimum over the ranks through distributed shared
//     memory and writes the rows: one launch, no partial buffers in device
//     memory, no second kernel. The minimum is associative, so the result
//     equals the serial scan bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <cooperative_groups.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

using pcc::Rec;

constexpr int kThreads = 128;  // threads a block
constexpr int kRows = 4;       // query rows a thread (ops/nn.py ROWS)
constexpr int kRun = 8;        // b rows a run
constexpr int kStage = 1024;   // b rows a shared-memory stage (16 KB)
static_assert(kStage % kRun == 0, "a stage holds whole runs");

// One run of kRun staged rows, the first at row index j, against the
// thread's kRows query rows (qi: their indices; kSelf: the run may hold the
// diagonal of one of them).
template <bool kSelf>
__device__ __forceinline__ void scan_run(const Rec* run, int j,
                                         const float (&qx)[kRows],
                                         const float (&qy)[kRows],
                                         const float (&qz)[kRows],
                                         const int (&qi)[kRows],
                                         float (&best_d)[kRows],
                                         int (&best_i)[kRows]) {
  float dd[kRun][kRows];
  float rmin[kRows];
#pragma unroll
  for (int s = 0; s < kRun; ++s) {
    const Rec r = run[s];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float d = pcc::offset(r, qx[k], qy[k], qz[k]).d;
      if (kSelf && j + s == qi[k]) d = pcc::inf();
      dd[s][k] = d;
      rmin[k] = s == 0 ? d : fminf(rmin[k], d);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (rmin[k] < best_d[k]) {
      int at = kRun - 1;
#pragma unroll
      for (int s = kRun - 2; s >= 0; --s) at = dd[s][k] == rmin[k] ? s : at;
      best_d[k] = rmin[k];
      best_i[k] = j + at;
    }
  }
}

template <bool kExcludeSelf>
__global__ void __launch_bounds__(kThreads)
nn_brute_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int na, int nb, int splits, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  __shared__ Rec stage[kStage];
  __shared__ float part_d[kRows][kThreads];  // splits > 1: this split's rows
  __shared__ int part_i[kRows][kThreads];

  const int qb = blockIdx.x / splits;
  const int split = blockIdx.x - qb * splits;  // the block's cluster rank
  const int tid = threadIdx.x;
  const int base = qb * kThreads * kRows;  // the block's first query row
  const int j0 = pcc::split_begin(nb, split, splits);
  const int j1 = pcc::split_begin(nb, split + 1, splits);

  float qx[kRows], qy[kRows], qz[kRows], best_d[kRows];
  int qi[kRows], best_i[kRows];
  const Rec first{b[3 * static_cast<int64_t>(j0)],
                  b[3 * static_cast<int64_t>(j0) + 1],
                  b[3 * static_cast<int64_t>(j0) + 2], j0};
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    qi[k] = base + k * kThreads + tid;
    const int64_t src = 3 * static_cast<int64_t>(min(qi[k], na - 1));
    qx[k] = a[src];
    qy[k] = a[src + 1];
    qz[k] = a[src + 2];
    // The range's first row seeds the best, so later ties keep it.
    best_d[k] = kExcludeSelf && qi[k] == j0
                    ? pcc::inf()
                    : pcc::offset(first, qx[k], qy[k], qz[k]).d;
    best_i[k] = j0;
  }

  for (int t = j0; t < j1; t += kStage) {
    const int m = min(kStage, j1 - t);
    const int padded = (m + kRun - 1) / kRun * kRun;
    __syncthreads();  // every thread is done with the previous stage
    for (int s = tid; s < padded; s += kThreads) {
      if (s < m) {
        const int64_t src = 3 * static_cast<int64_t>(t + s);
        stage[s] = Rec{b[src], b[src + 1], b[src + 2], t + s};
      } else {
        stage[s] = Rec{pcc::inf(), pcc::inf(), pcc::inf(), INT_MAX};
      }
    }
    __syncthreads();
    for (int s = 0; s < padded; s += kRun) {
      const int j = t + s;
      // uniform per block: the run meets the block's query rows
      if (kExcludeSelf && j < base + kThreads * kRows && j + kRun > base) {
        scan_run<true>(stage + s, j, qx, qy, qz, qi, best_d, best_i);
      } else {
        scan_run<false>(stage + s, j, qx, qy, qz, qi, best_d, best_i);
      }
    }
  }

  if (splits > 1) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      part_d[k][tid] = best_d[k];
      part_i[k][tid] = best_i[k];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every split's partial rows are in its shared memory
    if (split == 0) {
      for (int r = 1; r < splits; ++r) {
        const float* od = cluster.map_shared_rank(&part_d[0][0], r);
        const int* oi = cluster.map_shared_rank(&part_i[0][0], r);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float d = od[k * kThreads + tid];
          const int i = oi[k * kThreads + tid];
          if (pcc::lex_less(d, i, best_d[k], best_i[k])) {
            best_d[k] = d;
            best_i[k] = i;
          }
        }
      }
    }
    cluster.sync();  // no block leaves while the leader reads its rows
    if (split != 0) return;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (qi[k] < na) {
      out_d[qi[k]] = best_d[k];
      out_i[qi[k]] = best_i[k];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. a (na, 3) and b (nb, 3) float32, out_d and
// out_i (na,). b's rows are cut into `splits` (1..8, at most nb) balanced
// ranges, one block each, clustered when above 1. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a bad split count.
extern "C" int pcc_nn_brute(const float* a, const float* b, float* out_d,
                            int* out_i, int na, int nb, int splits,
                            int exclude_self, void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits || splits > nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na <= 0 || nb <= 0) return 0;
  const int blocks = (na + kThreads * kRows - 1) / (kThreads * kRows);
  auto kernel = exclude_self ? &nn_brute_kernel<true>
                             : &nn_brute_kernel<false>;
  return pcc::launch_split_threads(kernel, blocks, splits, kThreads, 0,
                                   static_cast<cudaStream_t>(stream), a, b,
                                   na, nb, splits, out_d, out_i);
}

// ctypes entry: registers a thread and resident blocks an SM of K5; returns
// the CUDA error.
extern "C" int pcc_nn_brute_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(nn_brute_kernel<false>, kThreads, 0, regs, blocks);
}
