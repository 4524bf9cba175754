// K1: count-gated, seeded 1-NN refine over Morton candidate chunks (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:575
// (_nn_kernel_t) and its entry point refine_pallas.py:728
// (refine_nn_pallas_t). Semantics, not layout: for each 256-query tile t
// and each of its query rows, keep the running lexicographic minimum of
// (squared distance, original id) over the candidate chunks cand[t, s],
// s < ncand[t], seeded from init when given, else (inf, INT32_MAX).
//
//   * Distance: pcc::offset (pcc_common.cuh), the one rounding K1, K3 and
//     K4 share; it equals the uncontracted eager PyTorch reference bit for
//     bit. With `expanded` (the TPU kernel's expanded=True,
//     refine_pallas.py:617-628) it is pcc::expanded instead: the query is
//     packed in registers as (-2x, -2y, -2z, |q|^2) and each staged record
//     carries |b|^2, so a pair costs one add and three FMAs. Only exact on
//     clouds that pass Cloud.mxu_exact; the caller gates it.
//   * Ties: the lowest original id wins.
//   * exclude_self: the column whose global sorted row equals the query's
//     global sorted row (tiles[t] * 256 + lane) counts as d = inf, as in the
//     TPU kernel. tiles[] carries global tile ids, so compacted tier calls
//     read their queries in place and still exclude the right column.
//
// Bound: FP32 ALU. Each (query, candidate) pair costs 8 flops (3 sub,
// 3 mul, 2 add; expanded: 1 add and 3 FMA, 7 flops) plus one
// compare-select, against 16 bytes of shared memory (expanded: 20) read as
// a warp-wide broadcast; global traffic is 4 KB per chunk per tile. Under
// -fmad=false the difference form emits no FMA, so its instruction ceiling
// is about half the published 67 TFLOP/s, which counts an FMA as two.
//
// Design: one query row per thread held in registers, 256 threads a block.
//   * Split: the tiers hand K1 a few tiles with hundreds of live slots each
//     (tier B: at most 32 tiles, up to ~800 slots), which one block per tile
//     would walk serially on a few of the 132 SMs. So the host picks a split
//     count S (ops/refine.py split_count, from nt and w only: 1 at probe
//     shapes, up to 8 in tier B) and block (t, s) walks the s-th of S
//     balanced parts of tile t's live range (pcc::split_begin; live is read
//     on the device, so no readback decides the launch). The S blocks of a
//     tile form one thread-block cluster: each leaves its 256 partial
//     (d, id) pairs in shared memory, the cluster synchronises, and the
//     leader (rank 0) takes the lexicographic minimum over the S partials
//     through distributed shared memory and writes the row. The minimum is
//     associative and commutative, so the result equals the serial walk
//     bit for bit, and the seed may enter every split (the minimum is
//     idempotent). A cluster keeps the merge in one launch, with no scratch
//     buffer, no atomics and no second kernel; 8 blocks (the portable
//     cluster size) a tile fill the card once tier B has 16 tiles, which
//     the schedules give it (ft2 >= 16).
//   * Steps: K1b's structure (refine_nn_straight.cu, 23% faster than the
//     one-chunk step ungated): each step stages up to 8 chunks' (x, y, z,
//     id) records between one pair of barriers (32 KB), every thread takes
//     each chunk's (d, lowest id) minimum and merges it into its running
//     best once. The per-tile ncand gate bounds the walk, so gated slots
//     cost nothing. The self test runs only on the one chunk that can hold
//     the query's own column. K1c (refine_nn_fused.cu) showed that
//     cp.async double buffering does not pay on this scan, so it is left
//     out.
//   * Word skip: staging leaves the box of each warp's 32 records (a word),
//     and a warp skips a word when each of its rows is bounded away from
//     the box by more than its best d (pcc::point_box_lb never exceeds a
//     record's d, so no skipped record could win). Words skip in seeded
//     passes and in a probe's later chunks. The expanded mode skips only
//     for rows whose best d is below pcc::nn::kSkipGuard (2^22), where
//     its rounding cannot reorder a skipped record (pcc_nn.cuh proves it).
//   * The step, the scan, the skip and the merge live in pcc_nn.cuh, shared
//     with K6 (refine_nn_payload.cu) and K7 (adaptive_refine.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

namespace {

using pcc::kChunk;
namespace nn = pcc::nn;

template <bool kExpanded>
__global__ void __launch_bounds__(kChunk)
refine_nn_kernel(const float* __restrict__ q, const float* __restrict__ b,
                 const int* __restrict__ b_orig, const int* __restrict__ cand,
                 const int* __restrict__ tiles, const int* __restrict__ ncand,
                 const float* __restrict__ init_d,
                 const int* __restrict__ init_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int w, int exclude_self,
                 int splits) {
  __shared__ nn::Staged<kExpanded> st;
  __shared__ float part_d[kChunk];  // this split's partial rows
  __shared__ int part_i[kChunk];

  const int t = blockIdx.x / splits;
  const int split = blockIdx.x - t * splits;  // the block's cluster rank
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const nn::Query qq =
      nn::make_query(q[row * 3 + 0], q[row * 3 + 1], q[row * 3 + 2]);

  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  nn::Best best{init_d != nullptr ? init_d[o] : pcc::inf(),
                init_i != nullptr ? init_i[o] : INT_MAX, -1};

  int live = w;
  if (ncand != nullptr) live = min(max(ncand[t], 0), w);  // uniform per block
  const auto stage = [&](int s, int c) {
    nn::stage_points(st, s, b, b_orig, c, lane);
  };
  nn::walk<kExpanded, false>(st, stage, cand + static_cast<int64_t>(t) * w,
                             pcc::split_begin(live, split, splits),
                             pcc::split_begin(live, split + 1, splits),
                             exclude_self ? tile : -1, qq, lane, best);
  if (!nn::merge_splits(part_d, part_i, split, splits, lane, best)) return;
  out_d[o] = best.d;
  out_i[o] = best.i;
}

}  // namespace

// Plain C entry for ctypes. Optional arrays are null pointers. `splits`
// (1..8) blocks walk each tile's live range, as a cluster when above 1.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 = ok), or cudaErrorInvalidValue for a bad split count.
extern "C" int pcc_refine_nn(const float* q, const float* b, const int* b_orig,
                             const int* cand, const int* tiles,
                             const int* ncand, const float* init_d,
                             const int* init_i, float* out_d, int* out_i,
                             int nt, int w, int exclude_self, int expanded,
                             int splits, void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  auto kernel = expanded ? &refine_nn_kernel<true> : &refine_nn_kernel<false>;
  return pcc::launch_split(kernel, nt, splits, 0,
                           static_cast<cudaStream_t>(stream), q, b, b_orig,
                           cand, tiles, ncand, init_d, init_i, out_d, out_i, w,
                           exclude_self, splits);
}
