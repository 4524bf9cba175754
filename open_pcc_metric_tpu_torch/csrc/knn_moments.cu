// K4: covariance moment sums of each query's exact k-NN set (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/refine_pallas.py:1330
// (_moments_kernel_t) and its entry point refine_pallas.py:1440
// (moments_pallas_t). For each 256-query tile t and each query row with
// k-th neighbour (rk, ik) from K3, walk the candidate chunks cand[t, s],
// s < ncand[t], and add up, over the members (d < rk) | (d == rk & id <= ik),
// the ten sums [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] of the
// query-relative offsets b - q, starting from init[t] when given, else 0.
// Centring on the query keeps the sums free of the cancellation a raw
// sum-of-squares form would have.
//
//   * Distance: pcc::offset (pcc_common.cuh), shared with K3, so the
//     membership test sees the d that K3 stored and a valid row counts
//     exactly k members.
//   * Sums: float32, per thread, in chunk-slot and then record order (the
//     TPU sums each chunk's 256 rows first; results differ by summation
//     order only).
//
// Bound: FP32 ALU: per visited pair 8 flops for the offset and distance
// and up to three compares; a member adds 6 multiplies and 10 adds.
// Members are k of the 256 * ncand pairs a row sees, so the distance and
// the test dominate, and only the pairs a row's threshold can reach need
// them.
//
// Design: one 256-thread block per tile (or per part of one, below), one
// query row per thread with its ten sums in registers, candidate chunks
// staged through shared memory. K4 is the one refine whose threshold is
// final on entry: rk is K3's k-th distance, and a record whose d exceeds
// it is never a member, whatever its id. Three skips follow from that,
// each exact, so every skipped record is a non-member and the members are
// added in the same order as without them:
//   * Slot skip, by the search grid's chunk boxes (c_lo, c_hi): each
//     window of 32 live slots is decided at once; a row marks the slots
//     whose box (pcc::point_box_lb; the boxes enclose all 256 records,
//     padding included) it is not bounded beyond rk from, each warp ORs its rows'
//     marks into shared memory, and the block stages only the marked
//     slots. K3b's skip (refine_knn_straight.cu), on the final threshold
//     from the first slot on.
//   * Steps: the marked slots are staged 8 chunks between one barrier
//     pair, with the box of each warp's 32 records (pcc::stage_chunk_boxed,
//     as K1 and K3 stage them).
//   * Word skip: a warp skips a 32-record word when each of its rows is
//     bounded beyond its rk from the word's box, strictly. A row whose rk
//     is +inf never lets its warp skip.
//   * Split: the tiers hand K4 a few tiles with hundreds of live slots each
//     (tier B: 32 tiles of up to ~700 slots), which one block a tile would
//     walk serially. So the host picks S = ops/refine.py split_count (1 at
//     stage-1 shapes, 3 in tier A, 8 in tier B), block (t, s) walks the
//     s-th of S balanced parts of tile t's live range (pcc::split_begin),
//     and the S blocks form one thread-block cluster (pcc::launch_split).
//     Each leaves its ten partial sums in shared memory; the leader (rank
//     0) adds the others' through distributed shared memory in rank order,
//     so the result does not depend on the schedule. The seed init enters
//     once, in the leader: a sum, unlike K1's minimum, is not idempotent.
// Numerics: at S = 1 the members are summed in the first design's order
// (chunk slot, then record), so the result equals it bit for bit. At S > 1
// only the order of the partial sums changes. Counts (channel 0, integers
// below 2^24) stay exact. The other nine channels differ from the plain
// version's by float32 summation order alone: on a row of at most k
// members within rtol 1e-6, atol 1e-4 (chip_smoke.py MOM_RTOL, MOM_ATOL;
// exact on the valid rows of integer clouds, whose offsets and products
// are small integers). A row of n > k members (a padded query row at 1e9,
// tied at d == rk with thousands of records a covered chunk range beyond
// K3's holds) is held to rtol n * 2^-23 instead, the worst-case gap between
// two float32 summation orders of n terms of one sign (its offsets b - q
// all lie at or below 0); chip_smoke.py and the tests take the same rule.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_knn.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using pcc::kChunk;
using pcc::Rec;
using pcc::knn::kStage;
using pcc::knn::kWords;
using pcc::knn::stage_step;

constexpr int kMomCh = 10;
constexpr int kWindow = 32;  // slots decided at once by the slot skip
constexpr int kWarps = kChunk / 32;

// Adds the members among the records of one staged chunk to acc. A warp
// skips a word (32 records, one box of `boxes`) when every row's bound to
// the box is above its rk: none of them could hold a member.
__device__ __forceinline__ void sum_chunk(const Rec* chunk,
                                          const float* boxes, float qx,
                                          float qy, float qz, float rk,
                                          int ik, float (&acc)[kMomCh]) {
#pragma unroll 1
  for (int wd = 0; wd < kWords; ++wd) {
    const float lb = pcc::point_box_lb(boxes + 6 * wd, qx, qy, qz);
    if (!__any_sync(0xffffffffu, !(lb > rk))) continue;
#pragma unroll 8
    for (int bit = 0; bit < 32; ++bit) {
      const Rec r = chunk[wd * 32 + bit];
      const pcc::Offset f = pcc::offset(r, qx, qy, qz);
      if (f.d < rk || (f.d == rk && r.id <= ik)) {
        acc[0] = __fadd_rn(acc[0], 1.0f);
        acc[1] = __fadd_rn(acc[1], f.dx);
        acc[2] = __fadd_rn(acc[2], f.dy);
        acc[3] = __fadd_rn(acc[3], f.dz);
        acc[4] = __fadd_rn(acc[4], __fmul_rn(f.dx, f.dx));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(f.dy, f.dy));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(f.dz, f.dz));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(f.dx, f.dy));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(f.dx, f.dz));
        acc[9] = __fadd_rn(acc[9], __fmul_rn(f.dy, f.dz));
      }
    }
  }
}

__global__ void __launch_bounds__(kChunk)
knn_moments_kernel(const float* __restrict__ q, const float* __restrict__ b,
                   const int* __restrict__ b_orig,
                   const int* __restrict__ cand,
                   const int* __restrict__ tiles,
                   const int* __restrict__ ncand,
                   const float* __restrict__ c_lo,
                   const float* __restrict__ c_hi,
                   const float* __restrict__ rk, const int* __restrict__ ik,
                   const float* __restrict__ init, float* __restrict__ out,
                   int w, int splits) {
  __shared__ Rec chunks[kStage][kChunk];
  __shared__ float boxes[kStage][kWords * 6];  // each word's box
  __shared__ unsigned marks[2][kWarps];  // slot skip: each warp's window OR
  __shared__ float part[kMomCh][kChunk];  // splits > 1: this split's sums

  const int t = blockIdx.x / splits;
  const int split = blockIdx.x - t * splits;  // the block's cluster rank
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];

  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  const float rkv = rk[o];
  const int ikv = ik[o];
  const bool seeded = init != nullptr && split == 0;  // the seed enters once
  float acc[kMomCh];
#pragma unroll
  for (int m = 0; m < kMomCh; ++m) {
    acc[m] = seeded ? init[o * kMomCh + m] : 0.0f;
  }

  const int live = min(max(ncand[t], 0), w);  // uniform per block
  const int begin = pcc::split_begin(live, split, splits);
  const int end = pcc::split_begin(live, split + 1, splits);
  const int* slots = cand + static_cast<int64_t>(t) * w;

  for (int w0 = begin, win = 0; w0 < end; w0 += kWindow, ++win) {
    const int n = min(kWindow, end - w0);
    unsigned mine = 0;
    for (int s = 0; s < n; ++s) {
      const int64_t c = slots[w0 + s];
      const float box[6] = {c_lo[3 * c], c_lo[3 * c + 1], c_lo[3 * c + 2],
                            c_hi[3 * c], c_hi[3 * c + 1], c_hi[3 * c + 2]};
      if (!(pcc::point_box_lb(box, qx, qy, qz) > rkv)) mine |= 1u << s;
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    // marks[win & 1] was last read two windows ago, before every thread
    // passed the previous window's barrier.
    if ((lane & 31) == 0) marks[win & 1][lane >> 5] = mine;
    __syncthreads();
    unsigned take = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) take |= marks[win & 1][i];
    while (take != 0) {  // uniform per block
      unsigned step = 0;  // the next (up to) kStage marked slots
      for (int i = 0; i < kStage && take != 0; ++i) {
        step |= take & (0u - take);
        take &= take - 1u;
      }
      const int m = stage_step(chunks, boxes, b, b_orig, slots + w0, n, lane,
                               step);
      for (int i = 0; i < m; ++i) {
        sum_chunk(chunks[i], boxes[i], qx, qy, qz, rkv, ikv, acc);
      }
    }
  }

  if (splits > 1) {
#pragma unroll
    for (int m = 0; m < kMomCh; ++m) part[m][lane] = acc[m];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every split's sums are in its shared memory
    if (split == 0) {
      for (int r = 1; r < splits; ++r) {  // in rank order: deterministic
        const float* other = cluster.map_shared_rank(&part[0][0], r);
#pragma unroll
        for (int m = 0; m < kMomCh; ++m) {
          acc[m] = __fadd_rn(acc[m], other[m * kChunk + lane]);
        }
      }
    }
    cluster.sync();  // no block leaves while the leader reads its sums
    if (split != 0) return;
  }
#pragma unroll
  for (int m = 0; m < kMomCh; ++m) out[o * kMomCh + m] = acc[m];
}

}  // namespace

// Plain C entry for ctypes. Arrays are row-major: q (Pa, 3), b (Pb, 3),
// cand (nt, w), ncand (nt,), rk and ik (nt, 256), init and out
// (nt, 256, 10), c_lo and c_hi the search grid's chunk boxes (Pb / 256,
// 3). tiles and init may be null pointers. `splits` (1..8) blocks walk each
// tile's live range, as a cluster when above 1. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a bad split count.
extern "C" int pcc_knn_moments(const float* q, const float* b,
                               const int* b_orig, const int* cand,
                               const int* tiles, const int* ncand,
                               const float* c_lo, const float* c_hi,
                               const float* rk, const int* ik,
                               const float* init, float* out, int nt, int w,
                               int splits, void* stream) {
  if (splits < 1 || splits > pcc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt <= 0) return 0;
  return pcc::launch_split(knn_moments_kernel, nt, splits, 0,
                           static_cast<cudaStream_t>(stream), q, b, b_orig,
                           cand, tiles, ncand, c_lo, c_hi, rk, ik, init, out,
                           w, splits);
}

// ctypes entry: registers a thread and resident blocks an SM of K4; returns
// the CUDA error.
extern "C" int pcc_knn_moments_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(knn_moments_kernel, kChunk, 0, regs, blocks);
}
