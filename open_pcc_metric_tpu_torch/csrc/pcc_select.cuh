// Block-wide selection pieces shared by the select prologue's K2a
// (select_bbox.cu) and the fixed-cap schedule's K2c (select_candidates.cu):
// an inclusive block scan, a radix select of the rank-th smallest 32-bit
// key, and a bitonic sort of a short array. Every function is called by
// all kThreads threads of the block (blockDim.x == kThreads) and
// synchronises the block itself.
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

}  // namespace pcc
