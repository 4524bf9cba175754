// The 1-NN refines' device pieces, shared by K1 (refine_nn.cu), the payload
// refine K6 (refine_nn_payload.cu), the adaptive refine K7
// (adaptive_refine.cu) and the fixed schedule's K1b (refine_nn_straight.cu)
// and K1c (refine_nn_fused.cu): the staged step of up to kStage chunks, the
// scan of one staged chunk that skips a warp's 32-record word by its box,
// the walk of a slot range in such steps (walk_async: K1c's, with the next
// step's chunks copied by cp.async while this one is scanned), and the
// cluster's lexicographic-minimum merge of a split tile. refine_nn.cu's
// note gives the design.
//
// The word skip. A warp skips a word when every one of its rows may skip
// it (may_skip): the row's bound to the word's box, pcc::point_box_lb, is
// above its best d so far, so no record of the word could win.
//   * Difference form (pcc::offset): point_box_lb rounds as offset does and
//     never exceeds a record's d, so the skip is exact on any cloud.
//   * Expanded form (pcc::expanded, K7 and K1's expanded mode): its d may
//     round, so a row also needs best < kSkipGuard = 2^22. Why that is
//     exact on the clouds the callers give it (Cloud.mxu_exact: integer
//     coordinates, |coord| <= 1600) for a record r of a skipped word, with
//     true squared distance D, an integer:
//       - D < T = 2^24 - 4 * 1600^2 = 6537216: no step of expanded rounds
//         (pcc_common.cuh), and no step of offset either (every partial sum
//         is an integer at most D < 2^24), so expanded d = offset d = D >=
//         point_box_lb > best.
//       - D >= T: |b|^2 + |q|^2 <= 6 * 1600^2 < 2^24 is exact, and each of
//         the three multiply-adds has an exact value below 2^25 (at most
//         3200^2 + 4 * 1600^2 after the first, D + two errors after the
//         last, D <= 3 * 3200^2), so each rounds by at most 1 and expanded
//         d >= D - 3 >= T - 3 > 2^22 > best.
//     Either way r's (d, id) is not below (best, id of best): the skip
//     changes no valid row. A row whose best is at or above the guard skips
//     nothing (an unseeded row's first chunk, sentinel query rows). Word
//     boxes that hold sentinel records (1e9) reach far and seldom skip;
//     such records' expanded d is ~3e18 from a valid query, above any best
//     below the guard.
#pragma once

#include "pcc_common.cuh"

#include <cooperative_groups.h>

#include <climits>

namespace pcc {
namespace nn {

constexpr int kStage = 8;  // chunks staged between one pair of barriers
constexpr int kWords = kChunk / 32;  // 32-record words of a chunk, one a warp
constexpr float kSkipGuard = 4194304.0f;  // 2^22: see the note above

// One step's staged chunks: (x, y, z, original id) records, each word's box
// (min x, y, z, then max x, y, z) and, for the expanded form, |b|^2.
template <bool kExpanded>
struct Staged {
  Rec chunks[kStage][kChunk];
  float boxes[kStage][kWords * 6];
  float sq[kExpanded ? kStage : 1][kChunk];
};

// A thread's query row: the point, and the point packed for pcc::expanded.
struct Query {
  float x, y, z;
  XQuery xq;
};

__device__ __forceinline__ Query make_query(float x, float y, float z) {
  return Query{x, y, z,
               XQuery{-2.0f * x, -2.0f * y, -2.0f * z, sq_norm(x, y, z)}};
}

// A row's running lexicographic (d, id) minimum and, for K6, the sorted row
// of its winner (-1 while no candidate won).
struct Best {
  float d;
  int i;
  int col;
};

// Thread `lane` stages record `lane` of chunk `c` of the (Pb, 3) points `b`
// (ids `b_orig`) into position s of the step, with its warp's word box and,
// in the expanded form, its |b|^2. The caller synchronises around the step.
template <bool kExpanded>
__device__ __forceinline__ void stage_points(Staged<kExpanded>& st, int s,
                                             const float* b,
                                             const int* b_orig, int c,
                                             int lane) {
  stage_chunk_boxed(st.chunks[s], st.boxes[s], b, b_orig, c, lane);
  if constexpr (kExpanded) {
    const Rec& r = st.chunks[s][lane];
    st.sq[s][lane] = sq_norm(r.x, r.y, r.z);
  }
}

// Whether a row bounded `lb` away from a word's box, with best d `best`
// so far, lets its warp skip the word (see the note above).
template <bool kExpanded>
__device__ __forceinline__ bool may_skip(float lb, float best) {
  if constexpr (kExpanded) {
    return best < kSkipGuard && lb > best;
  } else {
    return lb > best;
  }
}

// Folds the lexicographic (d, id) minimum of staged chunk s into (md, mi)
// and, with kCol, its column within the chunk into mj. kSelf: the chunk
// holds the query's own column (lane), which counts as inf. `best` is the
// row's best d before this chunk, which the word skip is held against.
template <bool kExpanded, bool kSelf, bool kCol>
__device__ __forceinline__ void scan_chunk(const Staged<kExpanded>& st, int s,
                                           const Query& q, int lane,
                                           float best, float& md, int& mi,
                                           int& mj) {
  const Rec* chunk = st.chunks[s];
#pragma unroll 1
  for (int wd = 0; wd < kWords; ++wd) {
    const float lb = point_box_lb(st.boxes[s] + 6 * wd, q.x, q.y, q.z);
    if (__all_sync(0xffffffffu, may_skip<kExpanded>(lb, best))) continue;
#pragma unroll 8
    for (int bit = 0; bit < 32; ++bit) {
      const int j = wd * 32 + bit;
      const Rec r = chunk[j];
      float d;
      if constexpr (kExpanded) {
        d = expanded(q.xq, r.x, r.y, r.z, st.sq[s][j]);
      } else {
        d = offset(r, q.x, q.y, q.z).d;
      }
      if (kSelf && j == lane) d = inf();
      if (lex_less(d, r.id, md, mi)) {
        md = d;
        mi = r.id;
        if (kCol) mj = j;
      }
    }
  }
}

// Walks the chunks slots[begin, end) into `best`, kStage chunks a step:
// `stage(s, c)`, called by every thread, stages chunk c into position s
// (stage_points or the caller's own layout), and every thread folds each
// staged chunk's minimum into its running best once. The chunk whose id is
// `self_chunk` (-1: none) holds the query's own column. With kCol the
// winner's sorted row, chunk * 256 + column, goes to best.col.
template <bool kExpanded, bool kCol, typename Stage>
__device__ __forceinline__ void walk(Staged<kExpanded>& st, Stage stage,
                                     const int* slots, int begin, int end,
                                     int self_chunk, const Query& q,
                                     int lane, Best& best) {
  for (int s0 = begin; s0 < end; s0 += kStage) {
    const int n = min(kStage, end - s0);
    __syncthreads();  // every thread is done with the previous step
    for (int s = 0; s < n; ++s) stage(s, slots[s0 + s]);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int c = slots[s0 + s];
      float md = inf();
      int mi = INT_MAX;
      int mj = 0;
      if (c == self_chunk) {
        scan_chunk<kExpanded, true, kCol>(st, s, q, lane, best.d, md, mi, mj);
      } else {
        scan_chunk<kExpanded, false, kCol>(st, s, q, lane, best.d, md, mi,
                                           mj);
      }
      if (lex_less(md, mi, best.d, best.i)) {
        best.d = md;
        best.i = mi;
        if (kCol) best.col = c * kChunk + mj;
      }
    }
  }
}

// Asynchronous 4-byte copy of global `gmem` to shared `smem` (cp.async.ca:
// through L1, no registers), and the group commit and wait around it.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Chunks a step of walk_async: two steps, the one scanned and the one in
// flight, fill Staged's kStage positions, so K1c's shared memory is K1b's.
constexpr int kAsyncDepth = kStage / 2;

// walk over slots[begin, end) with the difference form (no column), as
// walk does, but with each step's records copied by cp.async into one half
// of `st` while the block scans the other: thread `lane` copies record
// `lane` of each chunk of step k + 1 straight into the Rec layout, then
// scans step k. After its copies land (wait_group 0, the only group in
// flight), a thread reads its records back and its warp reduces their word
// boxes (store_word_box); one barrier a step then makes every record and
// box visible and also frees the other half, whose chunks every thread
// scanned before it, for the next step's copies.
__device__ __forceinline__ void walk_async(Staged<false>& st, const float* b,
                                           const int* b_orig,
                                           const int* slots, int begin,
                                           int end, int self_chunk,
                                           const Query& q, int lane,
                                           Best& best) {
  const auto copy_step = [&](int s0, int half) {
    const int n = min(kAsyncDepth, end - s0);
    for (int s = 0; s < n; ++s) {
      const int64_t src = static_cast<int64_t>(slots[s0 + s]) * kChunk + lane;
      Rec& r = st.chunks[half * kAsyncDepth + s][lane];
      cp_async4(&r.x, b + src * 3 + 0);
      cp_async4(&r.y, b + src * 3 + 1);
      cp_async4(&r.z, b + src * 3 + 2);
      cp_async4(&r.id, b_orig + src);
    }
    cp_async_commit();
  };
  if (begin < end) copy_step(begin, 0);
  int half = 0;
  for (int s0 = begin; s0 < end; s0 += kAsyncDepth, half ^= 1) {
    const int n = min(kAsyncDepth, end - s0);
    cp_async_wait_all();  // this thread's records of this step have landed
    for (int s = 0; s < n; ++s) {
      const int p = half * kAsyncDepth + s;
      const Rec r = st.chunks[p][lane];
      store_word_box(st.boxes[p], r.x, r.y, r.z, lane);
    }
    __syncthreads();  // the step is visible; the other half is free
    if (s0 + kAsyncDepth < end) copy_step(s0 + kAsyncDepth, half ^ 1);
    for (int s = 0; s < n; ++s) {
      const int c = slots[s0 + s];
      const int p = half * kAsyncDepth + s;
      float md = inf();
      int mi = INT_MAX;
      int mj = 0;
      if (c == self_chunk) {
        scan_chunk<false, true, false>(st, p, q, lane, best.d, md, mi, mj);
      } else {
        scan_chunk<false, false, false>(st, p, q, lane, best.d, md, mi, mj);
      }
      if (lex_less(md, mi, best.d, best.i)) {
        best.d = md;
        best.i = mi;
      }
    }
  }
}

// The merge of a tile split over a cluster of `splits` blocks: each block
// leaves its partial (d, id) in part_d / part_i (its shared memory), the
// cluster synchronises, and the leader (rank 0) takes the lexicographic
// minimum over the partials through distributed shared memory. The minimum
// is associative, commutative and idempotent, so the result equals the
// serial walk's bit for bit and a seed may enter every split. Every block
// of the cluster calls it; returns whether this block writes the row (the
// leader, or the only block).
__device__ __forceinline__ bool merge_splits(float* part_d, int* part_i,
                                             int split, int splits, int lane,
                                             Best& best) {
  if (splits == 1) return true;
  namespace cg = cooperative_groups;
  part_d[lane] = best.d;
  part_i[lane] = best.i;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in its shared memory
  if (split == 0) {
    for (int r = 1; r < splits; ++r) {
      const float d = cluster.map_shared_rank(part_d, r)[lane];
      const int i = cluster.map_shared_rank(part_i, r)[lane];
      if (lex_less(d, i, best.d, best.i)) {
        best.d = d;
        best.i = i;
      }
    }
  }
  cluster.sync();  // no block leaves while the leader reads its partial
  return split == 0;
}

}  // namespace nn
}  // namespace pcc
