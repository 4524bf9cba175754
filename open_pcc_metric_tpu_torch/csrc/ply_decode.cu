// K9: decode a binary little-endian PLY's vertex records on the card into a
// cloud's padded float32 points, colours and normals (Hopper).
//
// Replaces no TPU kernel: the JAX package (and the port's host path,
// io/loaders.py _read_ply + cloud.py Cloud.from_numpy) splits the records
// into float64 columns on the host, scales the colours, runs the thin
// upload's checks, pads every array and uploads it. Here the host reads the
// records into page-locked memory and uploads them untouched; this kernel
// does the rest in one pass (io/ply_decode.py).
//
// Semantics, the host path's on a CUDA device (thin upload) bit for bit:
//   * Each field is read as its PLY type and widened to double, exactly.
//   * Colours: the first channel's type picks the scale, as the host's
//     _assemble_ply_cloud does: uchar -> v / 255, ushort -> v / 65535 in
//     double (__ddiv_rn, the host's IEEE division; for uchar the very
//     value of cloud.py's 256-entry table), anything else unscaled.
//   * Every double goes to float32 by __double2float_rn, the host's cast.
//     Points past n are PAD_SENTINEL, colours and normals past n 0.
//   * Flags, or-ed over the valid rows into flags[0]: kNotMxu (a coordinate
//     not an integer with |c| <= MXU_EXACT_MAX_COORD, Cloud.mxu_exact's
//     test), kNotF32 (a coordinate float32 cannot hold), kNotI16 / kNotU8
//     (the thin upload's int16 and uint8 tests fail: cloud.py
//     _as_int16_points, _as_uint8_colors), kPointNegZero / kColorNegZero
//     (a -0.0 coordinate / colour).
//   * The thin upload turns -0.0 into +0.0 where its narrow array is taken
//     (int16 and uint8 hold no -0): the last block to finish reads the
//     flags and clears those signs. That pass runs only for files with
//     -0.0 in them.
//
// Bound: bytes. Each record is read once (n * stride bytes) and 12 bytes a
// row written for each of the (P, 3) outputs.
// Design:
//   * A block decodes kThreads consecutive records (fewer when a record is
//     wide: records_a_block keeps a block's records within 47 KB of shared
//     memory and a multiple of 16, so every block's records start 16-byte
//     aligned). The block copies them into shared memory with 16-byte
//     loads, coalesced, then each thread reads its record's fields from
//     there byte by byte (records are packed, so fields are unaligned).
//   * Flags: one warp reduction (__reduce_or_sync), one atomicOr a warp
//     with a bit set. flags[1] counts finished blocks (the last one runs
//     the -0.0 pass). The entry clears both first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include "pcc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 47 * 1024;  // beside the static flag, under 48 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadSentinel = 1.0e9f;  // cloud.PAD_SENTINEL
constexpr double kMxuMax = 1600.0;      // cloud.MXU_EXACT_MAX_COORD
constexpr double kI16Max = 32766.0;     // cloud.THIN_I16_MAX

// Field types, as io/ply_decode.py codes them: (offset << 3) | type.
enum Type { kI1, kU1, kI2, kU2, kI4, kU4, kF4, kF8 };
// Colour scales.
enum Scale { kNone, kBy255, kBy65535 };

enum Flag : unsigned {
  kNotMxu = 1u,
  kNotF32 = 2u,
  kNotI16 = 4u,
  kNotU8 = 8u,
  kPointNegZero = 16u,
  kColorNegZero = 32u,
};

struct Fields {
  int code[9];  // x, y, z, red, green, blue, nx, ny, nz; -1 where absent
};

__device__ __forceinline__ unsigned load_u32(const unsigned char* p) {
  return unsigned(p[0]) | unsigned(p[1]) << 8 | unsigned(p[2]) << 16 |
         unsigned(p[3]) << 24;
}

__device__ __forceinline__ double field(const unsigned char* rec, int code) {
  const unsigned char* p = rec + (code >> 3);
  switch (code & 7) {
    case kI1:
      return double(static_cast<signed char>(p[0]));
    case kU1:
      return double(p[0]);
    case kI2:
      return double(static_cast<short>(p[0] | p[1] << 8));
    case kU2:
      return double(static_cast<unsigned short>(p[0] | p[1] << 8));
    case kI4:
      return double(static_cast<int>(load_u32(p)));
    case kU4:
      return double(load_u32(p));
    case kF4:
      return double(__uint_as_float(load_u32(p)));
    default: {
      const unsigned long long lo = load_u32(p), hi = load_u32(p + 4);
      return __longlong_as_double(static_cast<long long>(lo | hi << 32));
    }
  }
}

__device__ __forceinline__ bool neg_zero(float v) {
  return v == 0.0f && signbit(v);
}

__global__ void __launch_bounds__(kThreads)
    ply_decode_kernel(const unsigned char* __restrict__ records, Fields f,
                      int scale, int n, int pad, int stride,
                      int records_a_block, float* __restrict__ points,
                      float* __restrict__ colors, float* __restrict__ normals,
                      unsigned* flags) {
  extern __shared__ uint4 staged4[];
  const unsigned char* staged = reinterpret_cast<const unsigned char*>(staged4);
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * records_a_block;
  const int live = max(0, min(records_a_block, n - row0));

  // The block's records, 16 bytes a load; the device buffer is rounded up
  // to 16 bytes, so the last word stays inside it.
  const uint4* src = reinterpret_cast<const uint4*>(
      records + static_cast<size_t>(row0) * stride);
  const int words = (live * stride + 15) / 16;
  for (int w = t; w < words; w += kThreads) staged4[w] = src[w];
  __syncthreads();

  unsigned bits = 0;
  const int row = row0 + t;
  if (t < records_a_block && row < pad) {
    const size_t o = static_cast<size_t>(row) * 3;
    if (row < n) {
      const unsigned char* rec = staged + t * stride;
      for (int c = 0; c < 3; ++c) {
        const double v = field(rec, f.code[c]);
        const float v32 = __double2float_rn(v);
        const bool integer = rint(v) == v;
        bits |= (integer && fabs(v) <= kMxuMax) ? 0u : kNotMxu;
        bits |= double(v32) == v ? 0u : kNotF32;
        bits |= (integer && fabs(v) <= kI16Max) ? 0u : kNotI16;
        bits |= neg_zero(v32) ? kPointNegZero : 0u;
        points[o + c] = v32;
      }
      if (colors != nullptr) {
        for (int c = 0; c < 3; ++c) {
          double v = field(rec, f.code[3 + c]);
          if (scale == kBy255) v = __ddiv_rn(v, 255.0);
          if (scale == kBy65535) v = __ddiv_rn(v, 65535.0);
          const float v32 = __double2float_rn(v);
          const double r = rint(__dmul_rn(v, 255.0));
          bits |= (!(r < 0.0) && !(r > 255.0) && __ddiv_rn(r, 255.0) == v)
                      ? 0u
                      : kNotU8;
          bits |= neg_zero(v32) ? kColorNegZero : 0u;
          colors[o + c] = v32;
        }
      }
      if (normals != nullptr) {
        for (int c = 0; c < 3; ++c) {
          normals[o + c] = __double2float_rn(field(rec, f.code[6 + c]));
        }
      }
    } else {
      for (int c = 0; c < 3; ++c) {
        points[o + c] = kPadSentinel;
        if (colors != nullptr) colors[o + c] = 0.0f;
        if (normals != nullptr) normals[o + c] = 0.0f;
      }
    }
  }
  bits = __reduce_or_sync(kFull, bits);
  if ((t & 31) == 0 && bits != 0u) atomicOr(flags, bits);

  // The last block to finish sees every block's rows and flags.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(flags + 1, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned all = atomicOr(flags, 0u);
  const bool points_zero = !(all & kNotI16) && (all & kPointNegZero);
  const bool colors_zero = !(all & kNotU8) && (all & kColorNegZero);
  const size_t values = static_cast<size_t>(n) * 3;
  for (size_t i = t; (points_zero || colors_zero) && i < values;
       i += kThreads) {
    if (points_zero && neg_zero(points[i])) points[i] = 0.0f;
    if (colors_zero && neg_zero(colors[i])) colors[i] = 0.0f;
  }
}

// Records a block: kThreads, or as many as fit kSharedBytes, a multiple of
// 16 (0: a record too wide for the kernel). io/ply_decode.records_a_block
// is its Python copy, which sends such files to the host path.
inline int records_a_block(int stride) {
  const int fit = kSharedBytes / stride / 16 * 16;
  return fit < kThreads ? fit : kThreads;
}

}  // namespace

// ctypes entry: decode n records of `stride` bytes (a device buffer of at
// least n * stride rounded up to 16 bytes) into (pad, 3) float32 points,
// colours and normals (colours / normals may be null: not decoded), and
// the flags word pair (flags[0] the or-ed Flag bits). Field codes are
// (byte offset << 3) | Type, -1 where absent; `scale` a Scale. Returns the
// CUDA error.
extern "C" int pcc_ply_decode(const unsigned char* records, float* points,
                              float* colors, float* normals, unsigned* flags,
                              int x, int y, int z, int red, int green,
                              int blue, int nx, int ny, int nz, int scale,
                              int n, int pad, int stride, void* stream) {
  const int per_block = stride > 0 ? records_a_block(stride) : 0;
  if (n <= 0 || pad < n || per_block == 0 || x < 0 || y < 0 || z < 0 ||
      ((colors != nullptr) && (red < 0 || green < 0 || blue < 0)) ||
      ((normals != nullptr) && (nx < 0 || ny < 0 || nz < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Fields f{{x, y, z, red, green, blue, nx, ny, nz}};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (pad + per_block - 1) / per_block;
  ply_decode_kernel<<<blocks, kThreads, per_block * stride, s>>>(
      records, f, scale, n, pad, stride, per_block, points, colors, normals,
      flags);
  return static_cast<int>(cudaGetLastError());
}

// ctypes entry: registers a thread and resident blocks an SM of K9 at the
// most shared memory a block takes; returns the CUDA error.
extern "C" int pcc_ply_decode_occupancy(int* regs, int* blocks) {
  return pcc::occupancy(ply_decode_kernel, kThreads, kSharedBytes, regs,
                        blocks);
}
