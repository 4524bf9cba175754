// K2b: fused bbox lower-bound count, the certificate counts of the pruned
// searches under prologue="select" (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/select_pallas.py:133
// (_count_kernel) and its entry point select_pallas.py:220
// (count_bbox_pallas). Semantics, not layout: for query tile t, the number
// of search chunks c whose bound, rounded down to the key resolution
// (bits(lb) & ~low, as K2a packs it), is at most thr[t] * factor, where
// factor = 1 + count_slack is exact in float32 and the product is rounded
// once (__fmul_rn): the float ops/select.py inflate computes. The (nta,
// ncb) bound matrix is never stored.
//
// Bound: FP32 ALU. The bytes are tiny (28 bytes per tile in, 4 out, 24 per
// chunk); each (tile, chunk) pair costs 17 operations for its bound
// (pcc::bbox_lb, the expression K2a selects with) plus a compare and an
// add: about 19 operations a pair against 67 TFLOP/s, of the pairs the
// group skip below cannot avoid on the data.
//
// Design: a block of 8 warps owns kTilesBlock query tiles, a warp
// kTilesWarp of them, each tile's box and count limit in registers.
//   * Staging: the block copies a run of up to kRun chunk boxes of its
//     chunk range into shared memory, a chunk a thread (16-byte loads of
//     the run measured slower), then reduces the box of each group of 32
//     consecutive chunks, 8 threads a group (4 chunks a thread, 3
//     shuffles). Lane j later reads chunk j's box at a stride of 3 words,
//     free of bank conflicts.
//   * Count limit: with th = thr * factor, a chunk counts iff its masked
//     bound is at most th; for th >= 0 that is bits(lb) <= (bits(th) &
//     high) | low as integers (lb >= +0, so its bits order as the float),
//     and for th < 0 or NaN no chunk counts (limit -1). One integer compare
//     a pair, no mask.
//   * Group skip: lane g bounds each of the warp's tiles against group g's
//     box. Every step of pcc::bbox_lb rounds monotonically and a member's
//     box lies inside its group's, so no member's bound is below the
//     group's: a group whose bound is above a tile's limit holds no chunk
//     that tile counts, and a group above all the warp's limits is
//     skipped, exactly. The warp evaluates the chunks of the other groups,
//     a chunk a lane, against all its tiles. A tile's threshold reaches a
//     few dozen of thousands of Morton-ordered chunks, and the warp's
//     tiles are Morton neighbours, so most groups are skipped.
//   * Sums: a warp-shuffle sum a tile, no barrier between tiles.
//   * Split: where ceil(nta / kTilesBlock) blocks would not fill the card
//     twice, ops/select.count_split cuts the chunk range over a cluster of
//     S <= 8 blocks (pcc::split_begin, pcc::launch_split) and the leader
//     adds the integer partials through distributed shared memory: exact
//     in any order, no memset, no atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesWarp = 4;  // tiles a warp, boxes and limits in registers
constexpr int kTilesBlock = kWarps * kTilesWarp;  // ops/select.COUNT_TILES
constexpr int kRun = 1024;  // chunk boxes staged a pass (24 KB)
constexpr int kGroups = kRun / 32;  // 32-chunk groups of a run, one a lane
static_assert(4 * kThreads == kRun, "stage_run: 4 chunks a thread");

// Every thread copies chunks tid, tid + 256, ... of [c0, c0 + n) into
// s_lo / s_hi; after a barrier, 8 threads reduce each group's box from
// shared memory, 4 chunks a thread and 3 shuffles. The caller synchronises
// before and after.
__device__ __forceinline__ void stage_run(float* s_lo, float* s_hi,
                                          float* g_lo, float* g_hi,
                                          const float* b_lo,
                                          const float* b_hi, int c0, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int64_t src = 3 * (static_cast<int64_t>(c0) + j);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_lo[3 * j + d] = b_lo[src + d];
      s_hi[3 * j + d] = b_hi[src + d];
    }
  }
  __syncthreads();
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = pcc::inf();
    hi[d] = -pcc::inf();
  }
  const int first = 4 * threadIdx.x;  // group threadIdx.x / 8
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (first + q < n) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], s_lo[3 * (first + q) + d]);
        hi[d] = fmaxf(hi[d], s_hi[3 * (first + q) + d]);
      }
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], o));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], o));
    }
  }
  if ((threadIdx.x & 7) == 0 && first < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g_lo[3 * (threadIdx.x >> 3) + d] = lo[d];
      g_hi[3 * (threadIdx.x >> 3) + d] = hi[d];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
count_bbox_kernel(const float* __restrict__ a_lo,
                  const float* __restrict__ a_hi,
                  const float* __restrict__ b_lo,
                  const float* __restrict__ b_hi,
                  const float* __restrict__ thr, int* __restrict__ out,
                  int nta, int ncb, unsigned high, float factor,
                  int splits) {
  __shared__ float s_lo[kRun * 3];
  __shared__ float s_hi[kRun * 3];
  __shared__ float g_lo[kGroups * 3];
  __shared__ float g_hi[kGroups * 3];
  __shared__ int part[kTilesBlock];  // this split's counts

  const int blk = blockIdx.x / splits;
  const int split = blockIdx.x - blk * splits;  // the block's cluster rank
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = blk * kTilesBlock + warp * kTilesWarp;

  float alo[kTilesWarp][3], ahi[kTilesWarp][3];
  int limit[kTilesWarp];
  int n[kTilesWarp];
#pragma unroll
  for (int k = 0; k < kTilesWarp; ++k) {
    const int64_t t = min(first + k, nta - 1);  // past nta: counted, unused
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      alo[k][d] = a_lo[t * 3 + d];
      ahi[k][d] = a_hi[t * 3 + d];
    }
    const float th = __fmul_rn(thr[t], factor);
    limit[k] = th >= 0.0f
                   ? static_cast<int>(
                         ((__float_as_uint(th) & 0x7fffffffu) & high) | ~high)
                   : -1;
    n[k] = 0;
  }

  const int end = pcc::split_begin(ncb, split + 1, splits);
  for (int c0 = pcc::split_begin(ncb, split, splits); c0 < end;
       c0 += kRun) {
    const int m = min(kRun, end - c0);
    __syncthreads();  // every warp is done with the previous run
    stage_run(s_lo, s_hi, g_lo, g_hi, b_lo, b_hi, c0, m);
    __syncthreads();
    // The groups near some tile of the warp, a chunk a lane (see above).
    const bool mine = lane < ((m + 31) >> 5);
    float glo[3], ghi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      glo[d] = mine ? g_lo[3 * lane + d] : 0.0f;
      ghi[d] = mine ? g_hi[3 * lane + d] : 0.0f;
    }
    unsigned todo = 0;
#pragma unroll
    for (int k = 0; k < kTilesWarp; ++k) {
      todo |= __ballot_sync(
          0xffffffffu,
          mine && __float_as_int(pcc::bbox_lb(alo[k], ahi[k], glo, ghi)) <=
                      limit[k]);
    }
    while (todo != 0) {
      const int j = 32 * (__ffs(todo) - 1) + lane;
      todo &= todo - 1;
      if (j < m) {
        const float blo[3] = {s_lo[3 * j], s_lo[3 * j + 1], s_lo[3 * j + 2]};
        const float bhi[3] = {s_hi[3 * j], s_hi[3 * j + 1], s_hi[3 * j + 2]};
#pragma unroll
        for (int k = 0; k < kTilesWarp; ++k) {
          const float lb = pcc::bbox_lb(alo[k], ahi[k], blo, bhi);
          n[k] += __float_as_int(lb) <= limit[k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTilesWarp; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      n[k] += __shfl_xor_sync(0xffffffffu, n[k], o);
    }
  }

  if (splits == 1) {
    if (lane < kTilesWarp && first + lane < nta) {
      int v = n[0];
#pragma unroll
      for (int k = 1; k < kTilesWarp; ++k) v = lane == k ? n[k] : v;
      out[first + lane] = v;
    }
    return;
  }
  namespace cg = cooperative_groups;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTilesWarp; ++k) part[warp * kTilesWarp + k] = n[k];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's counts are in its shared memory
  const int i = threadIdx.x;
  if (split == 0 && i < kTilesBlock && blk * kTilesBlock + i < nta) {
    int total = part[i];
    for (int r = 1; r < splits; ++r) {
      total += cluster.map_shared_rank(part, r)[i];
    }
    out[blk * kTilesBlock + i] = total;
  }
  cluster.sync();  // no block leaves while the leader reads its counts
}

}  // namespace

// Plain C entry for ctypes: boxes are (n, 3) float32, thr and out (nta,);
// ncb <= 2^bits; factor = 1 + count_slack (exact in float32). `splits`
// (1..8) blocks count each block's tiles over disjoint chunk ranges, as a
// cluster when above 1. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for bad
// sizes or a bad split count.
extern "C" int pcc_count_bbox(const float* a_lo, const float* a_hi,
                              const float* b_lo, const float* b_hi,
                              const float* thr, int* out, int nta, int ncb,
                              int bits, int splits, float factor,
                              void* stream) {
  if (ncb < 1 || bits < 1 || bits > 30 || ncb > (1 << bits) || splits < 1 ||
      splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nta <= 0) return 0;
  const unsigned high = ~((1u << bits) - 1u);
  const int blocks = (nta + kTilesBlock - 1) / kTilesBlock;
  return pcc::launch_split_threads(
      count_bbox_kernel, blocks, splits, kThreads, 0,
      static_cast<cudaStream_t>(stream), a_lo, a_hi, b_lo, b_hi, thr, out,
      nta, ncb, high, factor, splits);
}

// Registers a thread and resident blocks an SM of the kernel (0 = ok).
extern "C" int pcc_count_bbox_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(count_bbox_kernel, kThreads, 0, regs, blocks);
}
