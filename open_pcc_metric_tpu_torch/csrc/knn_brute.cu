// K8: brute-force k-NN (k <= 32), the k lexicographically smallest (squared
// distance, row index) pairs of b for every row of a (Hopper).
//
// Replaces no TPU kernel: the JAX package runs its brute k-NN
// (open_pcc_metric_tpu/ops/knn.py knn) as plain XLA, a running top-k merge
// over tiles. The port's plain version (ops/knn.py knn_chunked) writes each
// (rows x Nb) distance block to device memory and stable-sorts every row in
// full to keep k columns: at 57344 rows that is 3.3e9 sorted elements for
// 1.7e6 kept, about 1000 times the card's bound. This kernel keeps nothing
// of the matrix outside registers.
//
// Semantics, those of knn_chunked bit for bit:
//   * Distance: pcc::offset (pcc_common.cuh), ((dx^2 + dy^2) + dz^2) with
//     every step rounded on its own, the order the plain version evaluates.
//   * Order: ascending in the total (d, j) order, ties to the lower row
//     index j, which is what the plain version's stable sort gives.
//   * exclude_self: the pair j == i reads FLT_MAX (torch.finfo(float32).max),
//     a candidate like any other, as in the plain version.
//   * Every row of b is a candidate, PAD_SENTINEL rows too (finite d), so a
//     search with fewer than k valid rows returns what the sort returns.
//   * The k smallest pairs of a total order do not depend on the order the
//     candidates are visited in, so the walk may start anywhere.
//
// Bound: the FP32 issue rate. Every pair costs 3 sub, 3 mul and 2 add
// (under -fmad=false none fuse) and a compare, Na * Nb pairs, while the bytes
// are (Na + Nb) * 12 in and Na * k * 8 out.
// Design:
//   * One warp holds kRows query rows. For each, lane l holds the l-th
//     smallest (d, j) pair found so far (a sorted list of 32 slots, empty
//     slots (+inf, INT_MAX)); every lane keeps the row's k-th pair, the
//     threshold, in registers. Each lane computes its candidate's distance
//     to each of the warp's rows: one candidate load serves kRows pairs.
//   * A candidate can enter only if d <= the threshold's d. One vote a 32
//     candidates says whether any lane's candidate can enter any row; only
//     then does the warp take, row by row, a ballot of those lanes and insert
//     them one at a time: re-check (d, j) <lex threshold (an earlier insert
//     may have lowered it), rank it by a ballot of the slots below it, shift
//     the slots above up by one lane (__shfl_up_sync) and re-read the k-th.
//   * Visit order: the block walks b's tiles starting near its own rows'
//     place in b (its first row scaled by Nb / Na, half a tile back) and
//     wraps around. The callers' clouds are in scan or Morton order, so the
//     first tiles hold most of each row's neighbours and set a threshold
//     that few later candidates beat; the result does not depend on it.
//   * kWarps warps a block share each tile of kTile rows of b, copied as it
//     is ((x, y, z) floats) into shared memory by 4-byte cp.async, double
//     buffered: tile n + 1 lands while tile n is scanned, one barrier a tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

#include <climits>

namespace {

constexpr int kWarps = 8;                // warps a block
constexpr int kThreads = 32 * kWarps;    // threads a block
constexpr int kRows = 4;                 // query rows a warp
constexpr int kBlockRows = kWarps * kRows;
constexpr int kTile = 1024;              // b rows a shared-memory tile (12 KB)
constexpr int kMaxK = 32;                // one slot a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float flt_max() { return __int_as_float(0x7f7fffff); }

// One row's sorted slot list, as lane `lane` holds it: slot (d, i), and the
// row's k-th pair (td, ti) in every lane.
struct Row {
  float d, td;
  int i, ti;
};

// Insert the candidates of the lanes in `mask` (distance cd of lane l, row
// index j0 + l) into the row's list.
__device__ __forceinline__ void insert(Row& row, unsigned mask, float cd,
                                       int j0, int k, int lane) {
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float d = __shfl_sync(kFull, cd, src);
    const int j = j0 + src;
    if (!pcc::lex_less(d, j, row.td, row.ti)) continue;  // warp-uniform
    const int pos =
        __popc(__ballot_sync(kFull, pcc::lex_less(row.d, row.i, d, j)));
    const float up_d = __shfl_up_sync(kFull, row.d, 1);
    const int up_i = __shfl_up_sync(kFull, row.i, 1);
    if (lane == pos) {
      row.d = d;
      row.i = j;
    } else if (lane > pos) {
      row.d = up_d;
      row.i = up_i;
    }
    row.td = __shfl_sync(kFull, row.d, k - 1);
    row.ti = __shfl_sync(kFull, row.i, k - 1);
  }
}

template <bool kExcludeSelf>
__global__ void __launch_bounds__(kThreads)
knn_brute_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int na, int nb, int k, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  __shared__ float tile[2][3 * kTile];

  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kBlockRows;  // the block's first query row
  const int row0 = base + (threadIdx.x >> 5) * kRows;

  float qx[kRows], qy[kRows], qz[kRows];
  Row rows[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t src = 3 * static_cast<int64_t>(min(row0 + r, na - 1));
    qx[r] = a[src];
    qy[r] = a[src + 1];
    qz[r] = a[src + 2];
    rows[r] = Row{pcc::inf(), pcc::inf(), INT_MAX, INT_MAX};
  }

  const int ntiles = (nb + kTile - 1) / kTile;
  // the walk's first tile: half a tile before the block's place in b
  const int64_t start = static_cast<int64_t>(base) * nb / na - kTile / 2;
  const int t0 = start <= 0 ? 0 : min(static_cast<int>(start / kTile),
                                      ntiles - 1);
  const auto copy_tile = [&](int t, int buf) {
    const int c0 = t * kTile;
    const int n3 = 3 * min(kTile, nb - c0);
    const float* src = b + 3 * static_cast<int64_t>(c0);
    for (int s = threadIdx.x; s < n3; s += kThreads) {
      pcc::nn::cp_async4(&tile[buf][s], src + s);
    }
    pcc::nn::cp_async_commit();
  };

  copy_tile(t0, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int t = t0 + n < ntiles ? t0 + n : t0 + n - ntiles;
    const int buf = n & 1;
    pcc::nn::cp_async_wait_all();  // this thread's copies of tile n landed
    __syncthreads();  // tile n is visible; every warp is done with tile n - 1
    if (n + 1 < ntiles) {
      const int next = t + 1 < ntiles ? t + 1 : 0;
      copy_tile(next, buf ^ 1);
    }
    const int c0 = t * kTile;
    const int m = min(kTile, nb - c0);
    for (int s = 0; s < m; s += 32) {
      const int c = s + lane;  // < kTile: in the buffer, stale past m
      const bool valid = c < m;
      const pcc::Rec cand{tile[buf][3 * c], tile[buf][3 * c + 1],
                          tile[buf][3 * c + 2], 0};
      const int j = c0 + c;
      float d[kRows];
      bool hit = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        d[r] = pcc::offset(cand, qx[r], qy[r], qz[r]).d;
        if (kExcludeSelf && j == row0 + r) d[r] = flt_max();
        hit |= d[r] <= rows[r].td;
      }
      if (__any_sync(kFull, valid && hit)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned mask =
              __ballot_sync(kFull, valid && d[r] <= rows[r].td);
          insert(rows[r], mask, d[r], c0 + s, k, lane);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < na && lane < k) {
      const int64_t dst = static_cast<int64_t>(row0 + r) * k + lane;
      out_d[dst] = rows[r].d;
      out_i[dst] = rows[r].i;
    }
  }
}

}  // namespace

// Plain C entry for ctypes. a (na, 3) and b (nb, 3) float32, out_d and
// out_i (na, k), 1 <= k <= min(32, nb). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a bad k.
extern "C" int pcc_knn_brute(const float* a, const float* b, float* out_d,
                             int* out_i, int na, int nb, int k,
                             int exclude_self, void* stream) {
  if (k < 1 || k > kMaxK || k > nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na <= 0) return 0;
  const int blocks = (na + kBlockRows - 1) / kBlockRows;
  auto kernel = exclude_self ? &knn_brute_kernel<true>
                             : &knn_brute_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, na, nb, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// ctypes entry: registers a thread and resident blocks an SM of K8; returns
// the CUDA error.
extern "C" int pcc_knn_brute_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(knn_brute_kernel<false>, kThreads, 0, regs, blocks);
}
