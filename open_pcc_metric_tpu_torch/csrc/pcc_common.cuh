// Pieces shared by the package's kernels: the refines K1 (refine_nn.cu),
// K3 (refine_knn.cu) and K4 (knn_moments.cu), the brute force K5
// (nn_brute.cu) and the select prologue K2a (select_bbox.cu) and K2b
// (count_bbox.cu).
//
// The refine kernels must see bit-identical squared distances: K4 decides
// whether a candidate belongs to a query's k-NN set by comparing its
// distance with the k-th distance that K3 stored. So the distance is
// defined once, here, with every step rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn; the sources are also built with
// -fmad=false): d = ((dx*dx + dy*dy) + dz*dz), dx = b - q. That is the
// uncontracted expression the plain PyTorch versions evaluate. K2a and K2b
// likewise share one box lower bound (bbox_lb), so a select-space count is
// taken over the very bounds the selection ordered. K1's expanded mode and
// the adaptive refine K7 (adaptive_refine.cu) share the expanded-norm
// distance (expanded), and the payload refine K6 (refine_nn_payload.cu)
// uses offset as K1 does. So do the fixed-cap schedule's refines K1b
// (refine_nn_straight.cu), K1c (refine_nn_fused.cu) and K3b
// (refine_knn_straight.cu), which must equal K1 and K3 ungated; its
// candidate select K2c (select_candidates.cu) shares lex_less. K1, K3 and
// K4 share the split of a tile's slot range over a thread-block cluster
// (split_begin, launch_split) and the skip of 32-record words by their box
// (stage_chunk_boxed, point_box_lb); K5 splits b's rows the same way
// (launch_split_threads, at its own block size), and K2b its chunk range.
// K1b, K1c, K2b, K3, K3b, K4, K5, K6 and K7 report their registers and
// resident blocks through occupancy. The 1-NN refines K1, K1b, K1c, K6 and
// K7 take their step, scan, skip and merge from pcc_nn.cuh, the k-NN
// refines theirs from pcc_knn.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pcc {

constexpr int kChunk = 256;  // points per Morton chunk = queries per tile
constexpr int kMaxSplits = 8;  // the portable thread-block cluster size

struct __align__(16) Rec {
  float x, y, z;
  int id;  // original row id of the candidate point
};

struct Offset {
  float dx, dy, dz;  // candidate minus query
  float d;           // squared distance
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ Offset offset(const Rec& r, float qx, float qy,
                                         float qz) {
  Offset o;
  o.dx = __fsub_rn(r.x, qx);
  o.dy = __fsub_rn(r.y, qy);
  o.dz = __fsub_rn(r.z, qz);
  o.d = __fadd_rn(__fadd_rn(__fmul_rn(o.dx, o.dx), __fmul_rn(o.dy, o.dy)),
                  __fmul_rn(o.dz, o.dz));
  return o;
}

// ((x*x + y*y) + z*z), each step rounded on its own.
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// A query packed for the expanded-norm distance: (-2x, -2y, -2z, |q|^2).
struct XQuery {
  float x2, y2, z2, sq;
};

// Expanded-norm squared distance from query q to the candidate (bx, by, bz)
// with |b|^2 = bsq, in this order:
//   d = fma(bz, -2qz, fma(by, -2qy, fma(bx, -2qx, |b|^2 + |q|^2)))
// one add and three fused multiply-adds (__fmaf_rn), against offset's eight
// operations. The plain versions evaluate the same order with every step
// rounded on its own. Exact on clouds that pass Cloud.mxu_exact (integer
// coordinates, |coord| <= 1600): every product is an integer, |b|^2 + |q|^2
// <= 6 * 1600^2 < 2^24, and each later partial sum is at most
// d + 4 * 1600^2, so for d < 2^24 - 4 * 1600^2 (points
// closer than 2557 units) no step rounds, and d equals offset's d and the
// plain chain's bit for bit. A farther pair's d may round, by a few units,
// and still never displaces a nearer winner. Sentinel rows (1e9) round:
// compare valid rows only.
__device__ __forceinline__ float expanded(const XQuery& q, float bx, float by,
                                          float bz, float bsq) {
  float d = __fadd_rn(bsq, q.sq);
  d = __fmaf_rn(bx, q.x2, d);
  d = __fmaf_rn(by, q.y2, d);
  return __fmaf_rn(bz, q.z2, d);
}

// Lexicographic (distance, original id) order: ties go to the lower id.
__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Thread `lane` of a 256-thread block copies record `lane` of chunk `c`
// into shared memory. The caller synchronises before and after.
__device__ __forceinline__ void stage_chunk(Rec* chunk, const float* b,
                                            const int* b_orig, int c,
                                            int lane) {
  const int64_t src = static_cast<int64_t>(c) * kChunk + lane;
  chunk[lane] = Rec{b[src * 3 + 0], b[src * 3 + 1], b[src * 3 + 2],
                    b_orig[src]};
}

// Squared-distance lower bound between the box (alo, ahi) and the box
// (blo, bhi), three floats per corner: per axis, x then y then z, gap =
// max(max(alo - bhi, blo - ahi), 0), and lb = ((gx*gx + gy*gy) + gz*gz),
// each step rounded on its own: ops/grid.py bbox_lower_bounds bit for bit.
// A gap of -0 squares to +0, so lb is never -0 and its bits order as an
// integer; boxes at +-FLT_MAX (tiles with no valid row) give lb = +inf.
__device__ __forceinline__ float bbox_lb(const float* alo, const float* ahi,
                                         const float* blo, const float* bhi) {
  float lb = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float g =
        fmaxf(fmaxf(__fsub_rn(alo[d], bhi[d]), __fsub_rn(blo[d], ahi[d])),
              0.0f);
    const float sq = __fmul_rn(g, g);
    lb = d == 0 ? sq : __fadd_rn(lb, sq);
  }
  return lb;
}

// Lane 0 of each warp w writes to boxes[6 * w, 6 * w + 6) the box (min x,
// y, z, then max x, y, z) of the 32 points (x, y, z) its threads hold:
// records [32 * w, 32 * w + 32) of a staged chunk. Every thread of the warp
// calls it.
__device__ __forceinline__ void store_word_box(float* boxes, float x, float y,
                                               float z, int lane) {
  float lo[3] = {x, y, z};
  float hi[3] = {x, y, z};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int off = 16 >> i;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if ((lane & 31) == 0) {
    float* o = boxes + 6 * (lane >> 5);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = lo[a];
      o[3 + a] = hi[a];
    }
  }
}

// Thread `lane` stages record `lane` of chunk `c`, as stage_chunk does, and
// stores its warp's word box (store_word_box). The caller synchronises
// before and after.
__device__ __forceinline__ void stage_chunk_boxed(Rec* chunk, float* boxes,
                                                  const float* b,
                                                  const int* b_orig, int c,
                                                  int lane) {
  stage_chunk(chunk, b, b_orig, c, lane);
  const Rec r = chunk[lane];
  store_word_box(boxes, r.x, r.y, r.z, lane);
}

// A lower bound of offset(r, q).d over every record r in `box` (min x, y,
// z, then max x, y, z): bbox_lb of the point box (q, q). Each of its steps
// rounds as offset's does and rounding is monotone, so for r in the box
// each |gap| <= |r - q| per axis after rounding and the bound never exceeds
// d: a row whose bound to a box is above its threshold d can take no
// record of that box.
__device__ __forceinline__ float point_box_lb(const float* box, float qx,
                                              float qy, float qz) {
  const float q[3] = {qx, qy, qz};
  return bbox_lb(q, q, box, box + 3);
}

// First slot of split s of a tile's live slot range [0, live) cut into
// `splits` parts: floor(s * live / splits), so split s walks
// [split_begin(s), split_begin(s + 1)). The parts are disjoint, cover the
// range, differ in length by at most one, and none is empty when live >=
// splits. ops/refine.py split_ranges is the same rule.
__host__ __device__ __forceinline__ int split_begin(int live, int s,
                                                    int splits) {
  return static_cast<int>(static_cast<int64_t>(s) * live / splits);
}

// Launch `kernel` on nt * splits blocks of `threads` threads (kChunk unless
// given). With splits > 1 the blocks of one tile form a thread-block
// cluster of `splits` blocks (block rank = blockIdx.x % splits), so they
// can merge through distributed shared memory; with splits == 1 it is a
// plain launch. Returns the launch's error (0 = ok): a refused cluster
// launch is reported, never replaced by another launch.
template <typename... Params, typename... Args>
inline int launch_split_threads(void (*kernel)(Params...), int nt,
                                int splits, int threads, size_t smem,
                                cudaStream_t stream, Args... args) {
  if (splits == 1) {
    kernel<<<nt, threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nt) * splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename... Params, typename... Args>
inline int launch_split(void (*kernel)(Params...), int nt, int splits,
                        size_t smem, cudaStream_t stream, Args... args) {
  return launch_split_threads(kernel, nt, splits, kChunk, smem, stream,
                              args...);
}

// Registers a thread and resident blocks an SM of `kernel` at `threads`
// threads a block and `smem` bytes of dynamic shared memory; returns the
// CUDA error (0 = ok).
template <typename Kernel>
inline int occupancy(Kernel kernel, int threads, size_t smem, int* regs,
                     int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      threads, smem);
  return static_cast<int>(err);
}

}  // namespace pcc

// ctypes entry: the text of a code returned by a pcc_* launch function.
extern "C" const char* pcc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
