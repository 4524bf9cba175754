// K1b: ungated, unseeded 1-NN refine over Morton candidate chunks (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:77
// (_nn_kernel), its group refine_pallas.py:128 (_nn_group) and its entry
// point refine_pallas.py:178 (refine_nn_pallas). Semantics, not layout: for
// each 256-query tile t and each of its query rows, the lexicographic
// minimum of (squared distance, original id) over every candidate chunk
// cand[t, s], s < w, starting from (inf, INT32_MAX). No gate, no seed: the
// fixed-cap schedule's stage 1 (ops/nn_pruned.py).
//
//   * Distance: pcc::offset (pcc_common.cuh), K1's rounding, so K1b equals
//     K1 ungated and the plain version bit for bit.
//   * Ties: the lowest original id wins.
//   * exclude_self: the column whose global sorted row equals the query's
//     (tiles[t] * 256 + lane) counts as d = inf, as in the TPU kernel.
//   * The TPU kernel's g chunks a grid step (_nn_group) and its skip gate
//     (refine_pallas.py:100-120, which leaves a step's column update out
//     when no query improves) are TPU layout: they change no result and
//     have no counterpart here.
//
// Bound: FP32 ALU, as K1: 9 operations a visited (query, candidate) pair
// against a 16-byte shared-memory broadcast; global traffic is 4 KB per
// chunk per tile.
//
// Design: K1's (refine_nn.cu) without its gate and seed, through the
// pieces of pcc_nn.cuh. The first design (one block a tile, up to 8 chunks
// staged a step, every staged record scanned with a lexicographic compare
// a pair) took 3.5x K1 ungated on the same stage-1 table.
//   * Steps: up to 8 chunks staged between one pair of barriers; each
//     thread takes a chunk's (d, id) minimum and folds it into its running
//     best once.
//   * Word skip: a warp skips a staged word of 32 records whose box every
//     row is bounded away from by more than its best d (pcc::point_box_lb
//     never exceeds pcc::offset's d, so the skip is exact on any cloud).
//     K1b is unseeded, so a tile's first chunk skips nothing.
//   * Split: ops/refine.split_count gives a call of few tiles S blocks a
//     tile, one cluster, merged on chip by pcc::nn::merge_splits; at
//     stage-1 shapes (thousands of tiles) S = 1, one block a tile.
//   * K2c repeats column 0 on the rows of query tiles with no valid point,
//     so such a row visits one chunk several times: harmless, the
//     lexicographic minimum is idempotent.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

namespace {

using pcc::kChunk;
namespace nn = pcc::nn;

__global__ void __launch_bounds__(kChunk)
refine_nn_straight_kernel(const float* __restrict__ q,
                          const float* __restrict__ b,
                          const int* __restrict__ b_orig,
                          const int* __restrict__ cand,
                          const int* __restrict__ tiles,
                          float* __restrict__ out_d, int* __restrict__ out_i,
                          int w, int exclude_self, int splits) {
  __shared__ nn::Staged<false> st;
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
  const auto stage = [&](int s, int c) {
    nn::stage_points(st, s, b, b_orig, c, lane);
  };
  nn::walk<false, false>(st, stage, cand + static_cast<int64_t>(t) * w,
                         pcc::split_begin(w, split, splits),
                         pcc::split_begin(w, split + 1, splits),
                         exclude_self ? tile : -1, qq, lane, best);
  if (!nn::merge_splits(part_d, part_i, split, splits, lane, best)) return;
  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  out_d[o] = best.d;
  out_i[o] = best.i;
}

}  // namespace

// Plain C entry for ctypes. q (Pa, 3), b (Pb, 3), cand (nt, w); tiles is a
// null pointer or (nt,). `splits` (1..8) blocks walk each tile's slots, as
// a cluster when above 1. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a bad
// split count.
extern "C" int pcc_refine_nn_straight(const float* q, const float* b,
                                      const int* b_orig, const int* cand,
                                      const int* tiles, float* out_d,
                                      int* out_i, int nt, int w,
                                      int exclude_self, int splits,
                                      void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  return pcc::launch_split(refine_nn_straight_kernel, nt, splits, 0,
                           static_cast<cudaStream_t>(stream), q, b, b_orig,
                           cand, tiles, out_d, out_i, w, exclude_self,
                           splits);
}

// Registers a thread and resident blocks an SM of the kernel (0 = ok).
extern "C" int pcc_refine_nn_straight_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(refine_nn_straight_kernel, kChunk, 0, regs, blocks);
}
