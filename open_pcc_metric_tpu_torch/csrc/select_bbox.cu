// K2a: fused bbox lower-bound select, the candidate prologue of the pruned
// searches under prologue="select" (Hopper).
//
// Replaces the TPU kernel open_pcc_metric_tpu/ops/select_pallas.py:117
// (_select_kernel) and its entry point select_pallas.py:170
// (select_bbox_pallas). Semantics, not layout: for query tile t, the bound
// lb(t, c) to every search chunk c (pcc::bbox_lb), packed into the unique
// key (bits(lb) & ~low) | c with low = 2^bits - 1; the row's `cap` smallest
// keys in ascending order, written as cand = min(key & low, ncb - 1) and
// lb_sel = the float of key & ~low (the bound rounded down). The (nta, ncb)
// bound matrix is never stored.
//
// Bound: the selection work. The bytes are tiny (24 bytes per box in, 8
// per selected slot out); each (tile, chunk) pair costs 17 FP32 operations
// for its bound and a key pack, and the selection has to look at every
// pair at least once (about 19 operations a pair against 67 TFLOP/s).
//
// Design: one block of 256 threads a tile, the tile's box in registers,
// the chunk boxes read through L1/L2 (24 bytes a chunk, shared by every
// block). The first design recomputed every bound in each of five passes
// (four 8-bit radix passes of pcc::radix_select, each a histogram, a block
// scan and several barriers, then a fill pass) and sorted the cap keys in
// global memory with a barrier a comparator stage (15 at cap 32, 55 at cap
// 1024): 49x its bound at 800k. Now (pcc_select.cuh's survivor pieces):
//   * One pass computes each key once into shared memory (4 bytes a chunk)
//     and histograms its bits 30..23, the bound's exponent (bit 31 is 0:
//     the bound is never negative).
//   * Warp 0 finds the bin that holds the cap-th key (one barrier). If the
//     keys at or below that bin (the survivors) number at most
//     room = min(ncb, max(256, 2 cap)), the select is done; else further
//     8-bit passes over the shared keys narrow the bin (a tile without a
//     valid point, whose keys are all +inf, takes three).
//   * The survivors are compacted into a shared buffer of `room` keys (one
//     atomic a warp and step) and written in order: at most 256 of them are
//     ranked by counting (each thread one key, no barrier), more are sorted
//     by a bitonic sort in shared memory whose stages of stride <= 32 need
//     only __syncwarp (pcc::bitonic_sort_warps).
//   At cap 32 a row costs four barriers, where the first design paid some
//   twenty plus fifteen sorting stages in global memory. The histograms
//   take plain shared atomics, simpler than a warp-aggregated count
//   (__match_any_sync), which was no faster.
//   * The first pass's six 4-byte loads of a chunk's box at a 12-byte
//     stride cost three L1 wavefronts a warp and load; the boxes as six
//     rows of ncb would cost one, but a transpose in the wrapper adds a
//     torch call to the host-bound 800k path: that layout belongs to the
//     grid, which K2b could share.
//   * Keys and buffer take 4 * (ncb + room) bytes of dynamic shared memory,
//     at most 8 * ncb, so ncb <= kSharedMaxChunks (28672, a search cloud of
//     7.3M points) fits any cap. Wider rows take the first design
//     (select_bbox_recompute): the branch is chosen from ncb alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"
#include "pcc_select.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // one block per query tile
constexpr int kMinRoom = 256;  // survivors ranked without a sort
// The widest row whose keys and survivors fit the opt-in shared memory of
// one block (227 KB) beside the static scratch: 8 bytes a chunk at most.
constexpr int kSharedMaxChunks = 28672;

// Packed key of chunk c for the tile box (alo, ahi).
__device__ __forceinline__ unsigned key_of(const float* alo, const float* ahi,
                                           const float* b_lo,
                                           const float* b_hi, int c,
                                           unsigned high) {
  const float lb = pcc::bbox_lb(alo, ahi, b_lo + 3 * static_cast<int64_t>(c),
                                b_hi + 3 * static_cast<int64_t>(c));
  return (__float_as_uint(lb) & high) | static_cast<unsigned>(c);
}

// Writes slot j of tile t's row from its key.
struct PutRow {
  int* cand;
  float* lb_sel;
  unsigned low;
  int ncb;
  __device__ __forceinline__ void operator()(int j, unsigned key) const {
    lb_sel[j] = __uint_as_float(key & ~low);
    cand[j] = min(static_cast<int>(key & low), ncb - 1);
  }
};

// The shared-key design (see the note above); room survivors at most.
__global__ void __launch_bounds__(kThreads)
select_bbox_shared(const float* __restrict__ a_lo,
                   const float* __restrict__ a_hi,
                   const float* __restrict__ b_lo,
                   const float* __restrict__ b_hi, int ncb, int cap, int room,
                   unsigned low, int* __restrict__ cand,
                   float* __restrict__ lb_sel) {
  extern __shared__ unsigned keys[];  // ncb keys, then room survivors
  __shared__ pcc::SurvivorScratch scratch;
  static_assert(kThreads == pcc::kRadixBins, "one thread a histogram bin");

  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned high = ~low;
  float alo[3], ahi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    alo[d] = a_lo[t * 3 + d];
    ahi[d] = a_hi[t * 3 + d];
  }
  scratch.hist[0][tid] = 0;
  scratch.hist[1][tid] = 0;
  if (tid == 0) scratch.fill = 0;
  __syncthreads();
  for (int c = tid; c < ncb; c += kThreads) {
    const unsigned key = key_of(alo, ahi, b_lo, b_hi, c, high);
    keys[c] = key;
    atomicAdd(&scratch.hist[0][key >> 23], 1);
  }
  __syncthreads();
  const unsigned bound =
      pcc::survivor_bound<kThreads>(keys, ncb, cap, room, scratch);
  unsigned* survivors = keys + ncb;
  const int m =
      pcc::compact_at_most<kThreads>(keys, ncb, bound, survivors, scratch);
  pcc::write_ranked<kThreads>(survivors, m, cap,
                              PutRow{cand + t * cap, lb_sel + t * cap, low,
                                     ncb});
}

// The first design, for rows wider than kSharedMaxChunks: the cap-th
// smallest key by pcc::radix_select with every bound recomputed in each
// pass, a fifth pass writing the cap keys at or below it into the output
// row in arrival order, and a bitonic sort of the row in place in global
// memory (padded virtually with +inf to a power of two), so no shared
// array caps ncb or cap.
__global__ void __launch_bounds__(kThreads)
select_bbox_recompute(const float* __restrict__ a_lo,
                      const float* __restrict__ a_hi,
                      const float* __restrict__ b_lo,
                      const float* __restrict__ b_hi, int ncb, int cap,
                      unsigned low, int* cand, float* lb_sel) {
  __shared__ pcc::RadixScratch<kThreads> scratch;
  __shared__ int s_fill;

  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned high = ~low;
  float alo[3], ahi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    alo[d] = a_lo[t * 3 + d];
    ahi[d] = a_hi[t * 3 + d];
  }

  // The cap-th smallest key itself (keys are unique).
  const unsigned kth = pcc::radix_select<kThreads>(
      ncb, cap,
      [&](int c) { return key_of(alo, ahi, b_lo, b_hi, c, high); }, scratch);

  // The cap keys <= kth, in arrival order, into the output row.
  int* row = cand + t * cap;
  if (tid == 0) s_fill = 0;
  __syncthreads();
  for (int c = tid; c < ncb; c += kThreads) {
    const unsigned key = key_of(alo, ahi, b_lo, b_hi, c, high);
    if (key <= kth) row[atomicAdd(&s_fill, 1)] = static_cast<int>(key);
  }
  __syncthreads();
  pcc::bitonic_sort<kThreads>(row, cap);

  const PutRow put{row, lb_sel + t * cap, low, ncb};
  for (int s = tid; s < cap; s += kThreads) {
    put(s, static_cast<unsigned>(row[s]));
  }
}

// Survivors a shared-key row may hold, and its dynamic shared bytes (0:
// the row is too wide and takes select_bbox_recompute).
int survivor_room(int ncb, int cap) {
  return std::min(ncb, std::max(kMinRoom, 2 * cap));
}

size_t shared_bytes(int ncb, int cap) {
  if (ncb > kSharedMaxChunks) return 0;
  return static_cast<size_t>(ncb + survivor_room(ncb, cap)) *
         sizeof(unsigned);
}

}  // namespace

// Plain C entry for ctypes: boxes are (n, 3) float32, cand and lb_sel
// (nta, cap); 1 <= cap <= ncb <= 2^bits. Rows of at most kSharedMaxChunks
// chunks take the shared-key design, wider ones the first. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int pcc_select_bbox(const float* a_lo, const float* a_hi,
                               const float* b_lo, const float* b_hi,
                               int* cand, float* lb_sel, int nta, int ncb,
                               int cap, int bits, void* stream) {
  if (nta <= 0) return 0;
  if (cap < 1 || cap > ncb || bits < 1 || bits > 30 || ncb > (1 << bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned low = (1u << bits) - 1u;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = shared_bytes(ncb, cap);
  if (bytes == 0) {
    select_bbox_recompute<<<nta, kThreads, 0, st>>>(a_lo, a_hi, b_lo, b_hi,
                                                     ncb, cap, low, cand,
                                                     lb_sel);
    return static_cast<int>(cudaGetLastError());
  }
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_bbox_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_bbox_shared<<<nta, kThreads, bytes, st>>>(
      a_lo, a_hi, b_lo, b_hi, ncb, cap, survivor_room(ncb, cap), low, cand,
      lb_sel);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, resident blocks an SM and dynamic shared bytes of the
// kernel a call of (ncb, cap) takes (0 = ok).
extern "C" int pcc_select_bbox_occupancy(int ncb, int cap, int* regs,
                                         int* blocks, int* smem) {
  const size_t bytes = shared_bytes(ncb, cap);
  *smem = static_cast<int>(bytes);
  if (bytes == 0) {
    return pcc::occupancy(select_bbox_recompute, kThreads, 0, regs, blocks);
  }
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_bbox_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return pcc::occupancy(select_bbox_shared, kThreads, bytes, regs, blocks);
}
