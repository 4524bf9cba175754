// K7: the adaptive schedule's 1-NN refine over augmented candidate records,
// with expanded-norm distances (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_adaptive.py:76
// (_adaptive_kernel) and its entry point refine_adaptive.py:249
// (adaptive_refine). Semantics, not layout: for each row r, the tile
// tids[r] of the packed queries, keep the running lexicographic minimum of
// (squared distance, original id) over the first ncand[r] candidate chunks
// cand[r, s], seeded from init when given, else (inf, INT32_MAX).
//
//   * Inputs in the JAX package's coordinate-major layout
//     (ops/refine_adaptive.py pack_queries / pack_candidates): qhat (8, Pa)
//     = [-2x, -2y, -2z, |q|^2, 1, 0, 0, 0] and bhat (8, Pb) = [x, y, z, 1,
//     |b|^2, bitcast(original id), 0, 0]. A thread reads its query's four
//     rows and a chunk's five rows with neighbouring lanes on neighbouring
//     addresses; the id row is read as int bits, never as a float. The
//     query point, which the word bound needs, is -0.5 times the first
//     three rows (exact: a power of two).
//   * Distance: pcc::expanded (pcc_common.cuh), the one K1's expanded mode
//     uses: 1 add + 3 FMA a pair. The TPU kernel took the same sum as one
//     HIGHEST-precision contraction over the 8 rows; both are exact under
//     Cloud.mxu_exact, which the caller (nn_pruned.nn_pruned_sorted) gates.
//   * Ties: the lowest original id wins. The TPU kernel's gate on chunks
//     that improve no query changes no result and is left out.
//   * exclude_self: the pair whose global query row tids[r] * 256 + lane
//     equals the candidate's global row cand * 256 + col counts as d = inf.
//
// Bound: FP32 ALU. Each (query, candidate) pair costs 1 add and 3 FMA
// (7 flops) plus one compare-select, 8 operations against K1's 9, and 20
// bytes of shared memory read as a warp-wide broadcast; global traffic is
// 5 KB per chunk per row.
//
// Design: K1's (refine_nn.cu), through the pieces of pcc_nn.cuh. The first
// design gave each row one block that staged one chunk between two barriers
// and scanned every record; the adaptive schedule's tail pass (P3: a few
// dozen tiles of up to ~1400 live slots at 800k points) then walked each
// tile serially on a few of the 132 SMs, 320 times its bound.
//   * Split: block (r, s) walks the s-th of `splits` balanced parts of row
//     r's live range; the parts of a row form a thread-block cluster whose
//     leader takes the lexicographic minimum of their partial rows through
//     distributed shared memory. The host picks the count with
//     ops/refine.split_count (8 at P3's 64 rows, 1 at the probe's and the
//     extension's thousands). The seed enters every split: the minimum is
//     idempotent. The result equals the serial walk's bit for bit.
//   * Steps: up to 8 chunks staged between one pair of barriers, each as
//     (x, y, z, id) records with |b|^2 beside them (bhat rows 0-2, 5 as int
//     bits, and 4), every thread folding each chunk's minimum into its
//     running best once.
//   * Guarded word skip: staging leaves each warp's 32-record box, and a
//     warp skips a word when each of its rows is bounded away from the box
//     by more than its best d and that best is below pcc::nn::kSkipGuard
//     (2^22). The expanded form may round a far pair's d, but only for
//     pairs farther than 2^24 - 4 * 1600^2 = 6537216, and by at most 3,
//     which leaves them above the guard: pcc_nn.cuh gives the proof. So
//     the skip changes no valid row of an mxu_exact pair; rows whose best
//     is at or above the guard skip nothing.
//   * The schedule seeds P3 beyond the prefix that P1 and P2 refined
//     (ops/nn_pruned.nn_pruned_adaptive_sorted), so P3 walks count2 - cap
//     slots a tail tile instead of count2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_nn.cuh"

namespace {

using pcc::kChunk;
using pcc::Rec;
namespace nn = pcc::nn;

__global__ void __launch_bounds__(kChunk)
adaptive_refine_kernel(const float* __restrict__ qhat,
                       const float* __restrict__ bhat,
                       const int* __restrict__ cand,
                       const int* __restrict__ ncand,
                       const int* __restrict__ tids,
                       const float* __restrict__ init_d,
                       const int* __restrict__ init_i,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int slots, int64_t pa, int64_t pb, int exclude_self,
                       int splits) {
  __shared__ nn::Staged<true> st;
  __shared__ float part_d[kChunk];  // this split's partial rows
  __shared__ int part_i[kChunk];

  const int r = blockIdx.x / splits;
  const int split = blockIdx.x - r * splits;  // the block's cluster rank
  const int lane = threadIdx.x;
  const int tile = tids[r];
  const int64_t qrow = static_cast<int64_t>(tile) * kChunk + lane;
  const pcc::XQuery xq{qhat[qrow], qhat[pa + qrow], qhat[2 * pa + qrow],
                       qhat[3 * pa + qrow]};
  const nn::Query q{__fmul_rn(-0.5f, xq.x2), __fmul_rn(-0.5f, xq.y2),
                    __fmul_rn(-0.5f, xq.z2), xq};
  const int* bid = reinterpret_cast<const int*>(bhat + 5 * pb);

  const int64_t o = static_cast<int64_t>(r) * kChunk + lane;
  nn::Best best{init_d != nullptr ? init_d[o] : pcc::inf(),
                init_i != nullptr ? init_i[o] : INT_MAX, -1};
  const int live = min(max(ncand[r], 0), slots);  // uniform per block

  const auto stage = [&](int s, int c) {
    const int64_t col = static_cast<int64_t>(c) * kChunk + lane;
    const float x = bhat[col];
    const float y = bhat[pb + col];
    const float z = bhat[2 * pb + col];
    st.chunks[s][lane] = Rec{x, y, z, bid[col]};
    st.sq[s][lane] = bhat[4 * pb + col];
    pcc::store_word_box(st.boxes[s], x, y, z, lane);
  };
  nn::walk<true, false>(st, stage, cand + static_cast<int64_t>(r) * slots,
                        pcc::split_begin(live, split, splits),
                        pcc::split_begin(live, split + 1, splits),
                        exclude_self ? tile : -1, q, lane, best);
  if (!nn::merge_splits(part_d, part_i, split, splits, lane, best)) return;
  out_d[o] = best.d;
  out_i[o] = best.i;
}

}  // namespace

// Plain C entry for ctypes. init_d/init_i may be null pointers. `splits`
// (1..8) blocks walk each row's live range, as a cluster when above 1.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a bad split
// count.
extern "C" int pcc_adaptive_refine(const float* qhat, const float* bhat,
                                   const int* cand, const int* ncand,
                                   const int* tids, const float* init_d,
                                   const int* init_i, float* out_d,
                                   int* out_i, int rows, int slots, int pa,
                                   int pb, int exclude_self, int splits,
                                   void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  return pcc::launch_split(adaptive_refine_kernel, rows, splits, 0,
                           static_cast<cudaStream_t>(stream), qhat, bhat,
                           cand, ncand, tids, init_d, init_i, out_d, out_i,
                           slots, static_cast<int64_t>(pa),
                           static_cast<int64_t>(pb), exclude_self, splits);
}

// Registers a thread and resident blocks an SM of the kernel (0 = ok).
extern "C" int pcc_adaptive_refine_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(adaptive_refine_kernel, kChunk, 0, regs, blocks);
}
