// Block-wide selection pieces shared by the select prologue's K2a
// (select_bbox.cu) and the fixed-cap schedule's K2c (select_candidates.cu):
// an inclusive block scan, a radix select of the rank-th smallest 32-bit
// key, and a bitonic sort of a short array; and K2a's survivor select over
// keys held in shared memory (survivor_bound, compact_at_most,
// bitonic_sort_warps, write_ranked). Every function is called by all
// kThreads threads of the block (blockDim.x == kThreads) and synchronises
// the block itself, unless it says otherwise.
#pragma once

#include "pcc_common.cuh"

namespace pcc {

constexpr int kRadixBins = 256;  // 8 key bits per radix pass

// Shared scratch of radix_select and block_inclusive_scan.
template <int kThreads>
struct RadixScratch {
  int hist[kRadixBins];
  int warp_sums[kThreads / 32];
  unsigned prefix;
  int rank;
};

// Inclusive scan of one int per thread over the block; *total (when
// given) receives the block's sum. Two barriers; warp_sums is free again
// on return.
template <int kThreads>
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total = nullptr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int base = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = warp_sums[w];
    base += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums is free again
  if (total != nullptr) *total = all;
  return v + base;
}

// The rank-th smallest (1-based, 1 <= rank <= n) of the n keys key(0),
// ..., key(n - 1): 4 passes of 8 bits from the top, each a 256-bin
// histogram in shared memory over the keys that match the prefix so far
// (warp-aggregated atomics: most keys share their high bytes) and a block
// scan to pick the bin. Returns the key T; *ties (when given) receives how
// many keys equal to T belong to the rank smallest, so exactly rank - *ties
// keys are below T. `key` is called with the same argument in every pass
// and must return the same key each time.
template <int kThreads, typename KeyFn>
__device__ __forceinline__ unsigned radix_select(int n, int rank, KeyFn key,
                                                 RadixScratch<kThreads>& s,
                                                 int* ties = nullptr) {
  static_assert(kThreads == kRadixBins, "one thread per histogram bin");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  unsigned prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    s.hist[tid] = 0;
    __syncthreads();
    // Every lane runs the same trip count, so the warp stays whole for
    // __match_any_sync.
    for (int base = 0; base < n; base += kThreads) {
      const int c = base + tid;
      int bin = -1;
      if (c < n) {
        const unsigned k = key(c);
        if ((k & pmask) == prefix) {
          bin = static_cast<int>((k >> shift) & 0xFF);
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&s.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    const int h = s.hist[tid];
    const int incl = block_inclusive_scan<kThreads>(h, s.warp_sums);
    if (incl >= rank && incl - h < rank) {  // exactly one thread: bin tid
      s.prefix = prefix | (static_cast<unsigned>(tid) << shift);
      s.rank = rank - (incl - h);
    }
    __syncthreads();
    prefix = s.prefix;
    rank = s.rank;
    pmask |= 0xFFu << shift;
  }
  if (ties != nullptr) *ties = rank;
  return prefix;
}

// Sorts a[0, n) ascending in place by operator<, in shared or global
// memory: a bitonic network over n padded virtually to a power of two with
// entries above every key (a comparator that reaches one changes nothing),
// every comparator ascending. The caller synchronises before (a[] is
// written); the last step ends with a barrier.
template <int kThreads, typename T>
__device__ __forceinline__ void bitonic_sort(T* a, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < (n2 >> 1); p += kThreads) {
        const int blk = p / stride, off = p % stride;
        int i, j;
        if (stride == (size >> 1)) {  // merge two sorted halves: mirror
          i = blk * size + off;
          j = blk * size + size - 1 - off;
        } else {  // half-cleaner
          i = blk * 2 * stride + off;
          j = i + stride;
        }
        if (j < n) {
          const T x = a[i], y = a[j];
          if (y < x) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// K2a's survivor select. The keys are unique, below 2^31, and held in
// shared memory. Radix passes over bits 30..23, 22..15, 14..7 and 7..0, each
// a 256-bin histogram of the keys that match the prefix so far, stop as
// soon as the keys at or below the bin that holds the rank-th key number at
// most `room`: those keys (the survivors) are the rank smallest and at most
// room - rank more. A row whose rank-th key sits in a sparse bin stops
// after the first pass, one barrier pair; a row whose keys crowd one bin
// (a tile without a valid point: every bound +inf) takes more passes. The
// last pass leaves exactly `rank` survivors, so room >= rank always stops.
struct __align__(16) SurvivorScratch {
  int hist[2][kRadixBins];  // one pass's histogram, the next pass's zeroed
  int bin;     // the bin that holds the rank-th key among the matching ones
  int below;   // matching keys in lower bins
  int inbin;   // matching keys in that bin
  int fill;    // compact_at_most's output count
};

// Warp 0 finds the bin of hist[0, 256) (16-byte aligned) that holds the
// rank-th key (1 <= rank <= the histogram's total) and leaves it in s; the
// block then synchronises, after which every thread may read s.bin,
// s.below, s.inbin.
__device__ __forceinline__ void pick_bin(SurvivorScratch& s, const int* hist,
                                         int rank) {
  static_assert(kRadixBins == 8 * 32, "8 bins a lane");
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    // the lane's 8 bins as two 16-byte loads (hist is 16-byte aligned)
    const int4 lo = reinterpret_cast<const int4*>(hist)[2 * lane];
    const int4 hi = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
    const int h[kRadixBins / 32] = {lo.x, lo.y, lo.z, lo.w,
                                    hi.x, hi.y, hi.z, hi.w};
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kRadixBins / 32; ++i) sum += h[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    int acc = incl - sum;
    if (acc < rank && rank <= incl) {  // exactly one lane
#pragma unroll
      for (int i = 0; i < kRadixBins / 32; ++i) {
        if (acc < rank && rank <= acc + h[i]) {
          s.bin = lane * (kRadixBins / 32) + i;
          s.below = acc;
          s.inbin = h[i];
        }
        acc += h[i];
      }
    }
  }
  __syncthreads();
}

// The survivor bound T of the n keys keys[0, n): the keys <= T are the rank
// smallest (1 <= rank <= n) and at most room - rank more (room >= rank).
// The caller has zeroed s.hist[1] and filled s.hist[0] with the first
// pass's histogram of bits 30..23, (key >> 23) of every key, and
// synchronised. Returns with s.hist[*] free for reuse after a barrier.
template <int kThreads>
__device__ __forceinline__ unsigned survivor_bound(const unsigned* keys,
                                                   int n, int rank, int room,
                                                   SurvivorScratch& s) {
  unsigned prefix = 0;  // the key bits at and above `fixed` found so far
  int taken = 0;        // keys below the prefix's range: all survivors
  int shift = 23, fixed = 31;
  for (int pass = 0;; ++pass) {
    pick_bin(s, s.hist[pass & 1], rank);
    const unsigned top = prefix | (static_cast<unsigned>(s.bin) << shift);
    const int below = s.below;
    if (taken + below + s.inbin <= room || shift == 0) {
      return top | ((1u << shift) - 1u);
    }
    prefix = top;
    taken += below;
    rank -= below;
    fixed = shift;
    shift = shift > 8 ? shift - 8 : 0;
    int* hist = s.hist[(pass + 1) & 1];
    // s.hist[pass & 1] was last read by warp 0 before pick_bin's barrier.
    s.hist[pass & 1][threadIdx.x] = 0;
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const unsigned k = keys[c];
      if ((k >> fixed) == (prefix >> fixed)) {
        atomicAdd(&hist[(k >> shift) & 0xFFu], 1);
      }
    }
    __syncthreads();
  }
}

// Copies the keys of keys[0, n) that are <= bound into out[0, m), in no
// order, and returns m (every thread). One shared atomic a warp and step.
// The caller has set s.fill to 0 and synchronised since.
template <int kThreads>
__device__ __forceinline__ int compact_at_most(const unsigned* keys, int n,
                                               unsigned bound, unsigned* out,
                                               SurvivorScratch& s) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += kThreads) {
    const int c = base + threadIdx.x;
    const unsigned k = c < n ? keys[c] : 0u;
    const bool take = c < n && k <= bound;
    const unsigned mask = __ballot_sync(0xffffffffu, take);
    if (mask == 0u) continue;
    const int leader = __ffs(mask) - 1;
    int pos = 0;
    if (lane == leader) pos = atomicAdd(&s.fill, __popc(mask));
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (take) out[pos + __popc(mask & ((1u << lane) - 1u))] = k;
  }
  __syncthreads();
  return s.fill;
}

// Sorts a[0, n) ascending in place in shared memory: bitonic_sort's
// network (padded virtually to a power of two, every comparator
// ascending), with its indices from shifts instead of divisions, and a
// block barrier only around stages of stride above 32. A stage of stride
// s <= 32 keeps each warp's comparators within 64-entry blocks that the
// warp owns alone (comparator p of p = 32 w + 256 r + lane spans entries
// [2 p - 2 (p % s), + 2 s)), so __syncwarp orders it. The caller
// synchronises before (a[] is written); the sort ends with a barrier.
template <int kThreads>
__device__ __forceinline__ void bitonic_sort_warps(unsigned* a, int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  const int half = (1 << lg) >> 1;
  bool wide_before = false;
  for (int ls = 1; ls <= lg; ++ls) {
    for (int lt = ls - 1; lt >= 0; --lt) {
      const bool wide = lt > 5;  // stride 2^lt above 32
      if (wide || wide_before) {
        __syncthreads();
      } else {
        __syncwarp();
      }
      wide_before = wide;
      const int stride = 1 << lt;
      for (int p = threadIdx.x; p < half; p += kThreads) {
        const int i = ((p >> lt) << (lt + 1)) + (p & (stride - 1));
        // the first stage of a merge mirrors; the others are half-cleaners
        const int j = lt == ls - 1 ? i + 2 * (stride - (p & (stride - 1))) - 1
                                   : i + stride;
        if (j < n) {
          const unsigned x = a[i], y = a[j];
          if (y < x) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
    }
  }
  __syncthreads();
}

// Writes the `cap` smallest of the m unique keys a[0, m) (cap <= m) in
// ascending order: put(j, key) for j < cap. For m <= kThreads, thread i
// ranks a[i] by counting the keys below it (m broadcast reads, no barrier);
// else bitonic_sort_warps sorts a[] in place. The caller synchronises
// before (a[] is written).
template <int kThreads, typename Put>
__device__ __forceinline__ void write_ranked(unsigned* a, int m, int cap,
                                             Put put) {
  if (m <= kThreads) {
    if (static_cast<int>(threadIdx.x) < m) {
      const unsigned x = a[threadIdx.x];
      int r = 0;
      for (int j = 0; j < m; ++j) r += a[j] < x;
      if (r < cap) put(r, x);
    }
    return;
  }
  bitonic_sort_warps<kThreads>(a, m);
  for (int j = threadIdx.x; j < cap; j += kThreads) put(j, a[j]);
}

}  // namespace pcc
