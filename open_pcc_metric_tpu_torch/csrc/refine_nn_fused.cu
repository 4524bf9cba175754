// K1c: K1b's function with each candidate chunk double-buffered in shared
// memory by asynchronous copies (Hopper).
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
// Bound: FP32 ALU, as K1 and K1b (8 flops and a compare per pair); global
// traffic is 4 KB per chunk per tile.
// Design: one block of 256 threads per tile, one query row per thread in
// registers. A chunk of the sorted search cloud is a contiguous 3072-byte
// run of (x, y, z) floats plus a 1024-byte run of original ids, each
// 16-byte aligned (the wrapper checks the base pointers). That is 256
// pieces of 16 bytes: each thread issues one `cp.async.cg` of its piece
// into one of two shared buffers, so chunk j + 1 is in flight while the
// block scans chunk j, the TPU kernel's DMA overlap. No thread spends
// registers on the staging loads that K1 and K1b route through registers.
// A barrier after the wait makes every thread's piece visible; a barrier
// after the scan frees the buffer for chunk j + 2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

#include <climits>

namespace {

using pcc::kChunk;
using pcc::Rec;

constexpr int kXyzPieces = kChunk * 3 * 4 / 16;  // 192 pieces of (x, y, z)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Thread `lane` copies the lane-th 16-byte piece of chunk c: pieces 0-191
// of its (x, y, z) run, then pieces 0-63 of its id run, as one group.
__device__ __forceinline__ void copy_chunk(float* xyz, int* ids,
                                           const float* b, const int* b_orig,
                                           int c, int lane) {
  const int64_t first = static_cast<int64_t>(c) * kChunk;
  if (lane < kXyzPieces) {
    cp_async16(xyz + lane * 4, b + first * 3 + lane * 4);
  } else {
    const int p = lane - kXyzPieces;
    cp_async16(ids + p * 4, b_orig + first + p * 4);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kChunk)
refine_nn_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ b,
                       const int* __restrict__ b_orig,
                       const int* __restrict__ cand,
                       const int* __restrict__ tiles,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int w, int exclude_self) {
  __shared__ __align__(16) float xyz[2][kChunk * 3];
  __shared__ __align__(16) int ids[2][kChunk];

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile = tiles != nullptr ? tiles[t] : t;
  const int64_t row = static_cast<int64_t>(tile) * kChunk + lane;
  const float qx = q[row * 3 + 0];
  const float qy = q[row * 3 + 1];
  const float qz = q[row * 3 + 2];
  const int* slots = cand + static_cast<int64_t>(t) * w;

  float best_d = pcc::inf();
  int best_i = INT_MAX;
  if (w > 0) copy_chunk(xyz[0], ids[0], b, b_orig, slots[0], lane);
  for (int s = 0; s < w; ++s) {
    const int buf = s & 1;
    if (s + 1 < w) {
      copy_chunk(xyz[buf ^ 1], ids[buf ^ 1], b, b_orig, slots[s + 1], lane);
      cp_async_wait<1>();  // this thread's piece of chunk s has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's piece of chunk s has landed
    const int self_j = (exclude_self && slots[s] == tile) ? lane : -1;
    const float* cx = xyz[buf];
    const int* ci = ids[buf];
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const Rec r{cx[3 * j + 0], cx[3 * j + 1], cx[3 * j + 2], ci[j]};
      float d = pcc::offset(r, qx, qy, qz).d;
      if (j == self_j) d = pcc::inf();
      if (pcc::lex_less(d, r.id, best_d, best_i)) {
        best_d = d;
        best_i = r.id;
      }
    }
    __syncthreads();  // every thread is done with buffer buf
  }
  const int64_t o = static_cast<int64_t>(t) * kChunk + lane;
  out_d[o] = best_d;
  out_i[o] = best_i;
}

}  // namespace

// Plain C entry for ctypes. q (Pa, 3), b (Pb, 3) and b_orig (Pb,) with b
// and b_orig 16-byte aligned, cand (nt, w); tiles is a null pointer or
// (nt,). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = ok).
extern "C" int pcc_refine_nn_fused(const float* q, const float* b,
                                   const int* b_orig, const int* cand,
                                   const int* tiles, float* out_d, int* out_i,
                                   int nt, int w, int exclude_self,
                                   void* stream) {
  if (nt <= 0) return 0;
  refine_nn_fused_kernel<<<nt, kChunk, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, b, b_orig, cand, tiles, out_d, out_i, w, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
