// Pieces shared by the package's refine kernels: K1 (refine_nn.cu), K3
// (refine_knn.cu) and K4 (knn_moments.cu).
//
// The three kernels must see bit-identical squared distances: K4 decides
// whether a candidate belongs to a query's k-NN set by comparing its
// distance with the k-th distance that K3 stored. So the distance is
// defined once, here, with every step rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn; the sources are also built with
// -fmad=false): d = ((dx*dx + dy*dy) + dz*dz), dx = b - q. That is the
// uncontracted expression the plain PyTorch versions evaluate.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pcc {

constexpr int kChunk = 256;  // points per Morton chunk = queries per tile

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

}  // namespace pcc

// ctypes entry: the text of a code returned by a pcc_* launch function.
extern "C" const char* pcc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
