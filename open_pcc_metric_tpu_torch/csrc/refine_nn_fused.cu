// K1c: K1b's function with the next step's candidate chunks copied
// asynchronously while the block scans this one (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:341
// (_nn_kernel_fused), its group refine_pallas.py:407 (_nn_group_fused) and
// its entry point refine_pallas.py:451 (refine_nn_pallas_fused): one grid
// step per tile with a manual double-buffered DMA of each candidate chunk
// from HBM and no skip gate. Semantics: K1b's (refine_nn_straight.cu), the
// lexicographic (squared distance, original id) minimum over every
// candidate chunk cand[t, s], s < w, with pcc::offset's rounding and
// exclude_self on global rows (tiles[t] * 256 + lane). Neither package has
// a caller of it: chip_smoke.py runs it beside K1b and K1 on the fixed
// schedule's stage-1 tables.
//
// Bound: FP32 ALU, as K1 and K1b: 9 operations a visited (query,
// candidate) pair, of the pairs the word skip cannot avoid on the data;
// global traffic is 4 KB per chunk per tile.
//
// Design: K1b's, through the pieces of pcc_nn.cuh, with the TPU kernel's
// DMA overlap done by cp.async. The first design (one block a tile, one
// chunk a step double-buffered by 16-byte cp.async, every record scanned)
// took 5x K1b on the same stage-1 table.
//   * Steps: pcc::nn::walk_async stages kAsyncDepth = 4 chunks a step in
//     one half of K1b's 8-chunk Staged buffer while the next step's 4
//     chunks land in the other half, so shared memory and blocks an SM
//     are K1b's. Each thread issues 4-byte cp.async.ca copies of its
//     record of each chunk straight into the Rec layout (no registers, no
//     alignment beyond 4 bytes), so the scan keeps its one 16-byte
//     broadcast a pair; after its copies land it reads its records back
//     and its warp reduces their word boxes by shuffles. One barrier a
//     step, against K1b's two.
//   * Word skip and fold: K1b's (pcc::nn::scan_chunk): a warp skips a word
//     whose box every row is bounded away from by more than its best d
//     (exact on any cloud); each chunk's (d, id) minimum folds into the
//     running best once.
//   * Split: ops/refine.split_count blocks a tile, one cluster, merged by
//     pcc::nn::merge_splits; 1 at stage-1 shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

namespace {

using pcc::kChunk;
namespace nn = pcc::nn;

__global__ void __launch_bounds__(kChunk)
refine_nn_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ b,
                       const int* __restrict__ b_orig,
                       const int* __restrict__ cand,
                       const int* __restrict__ tiles,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int w, int exclude_self, int splits) {
  __shared__ nn::Staged<false> st;  // two steps of nn::kAsyncDepth chunks
  __shared__ float part_d[kChunk];  // this split's partial rows
  __shared__ int part_i[kChunk];

  const int t = blockIdx.x / splits;
  const int split = blockIdx.x - t * splits;  // the block's cluster rank
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const nn::Query qq =
      nn::make_query(q[row * 3 + 0], q[row * 3 + 1], q[row * 3 + 2]);

  nn::Best best{pcc::inf(), INT_MAX, -1};
  nn::walk_async(st, b, b_orig, cand + static_cast<int64_t>(t) * w,
                 pcc::split_begin(w, split, splits),
                 pcc::split_begin(w, split + 1, splits),
                 exclude_self ? tile : -1, qq, lane, best);
  if (!nn::merge_splits(part_d, part_i, split, splits, lane, best)) return;
  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  out_d[o] = best.d;
  out_i[o] = best.i;
}

}  // namespace

// Plain C entry for ctypes. q (Pa, 3), b (Pb, 3) and b_orig (Pb,), cand
// (nt, w); tiles is a null pointer or (nt,). `splits` (1..8) blocks walk
// each tile's slots, as a cluster when above 1. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a bad split count.
extern "C" int pcc_refine_nn_fused(const float* q, const float* b,
                                   const int* b_orig, const int* cand,
                                   const int* tiles, float* out_d, int* out_i,
                                   int nt, int w, int exclude_self, int splits,
                                   void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  return pcc::launch_split(refine_nn_fused_kernel, nt, splits, 0,
                           static_cast<cudaStream_t>(stream), q, b, b_orig,
                           cand, tiles, out_d, out_i, w, exclude_self,
                           splits);
}

// Registers a thread and resident blocks an SM of the kernel (0 = ok).
extern "C" int pcc_refine_nn_fused_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(refine_nn_fused_kernel, kChunk, 0, regs, blocks);
}
