// Native host-side hot loops for the IO / preprocessing layer.
//
// Role parity: the reference delegates all parsing and tree-building to
// Open3D's C++ core (SURVEY §2.2). Here the accelerator does the O(N*M) work, and
// the host-side loops that remain hot at 1M-point scale are implemented in
// C++ and bound via ctypes (no pybind11 in this environment):
//
//   * pcc_parse_floats  — ASCII PLY/XYZ/PCD number scanning (np.loadtxt is
//     ~50x slower on 1M-line files),
//   * pcc_radix_argsort_u32 — stable LSD radix argsort for 30-bit Morton
//     codes (beats comparison argsort for grid builds at load time),
//   * pcc_gather_rows_f64 — permutation gather for the sorted point buffer.
//
// Build: native/__init__.py beside this file compiles it with g++ on
// first use; every caller falls back to numpy when no compiler is present.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Parse up to `count` whitespace-separated decimal numbers from data[0..len).
// Returns the number parsed.
//
// Fast path: <= 18 significant digits, |decimal exponent| <= 22 — mantissa
// accumulates exactly in int64 and one multiply/divide by an exactly-
// representable power of ten gives the correctly-rounded double (the classic
// Clinger fast path). Anything longer or weirder falls back to strtod.
long pcc_parse_floats(const char *data, long len, double *out, long count) {
  const char *p = data;
  const char *end = data + len;
  long i = 0;
  while (i < count && p < end) {
    while (p < end &&
           (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) {
      ++p;
    }
    if (p >= end) break;

    const char *start = p;
    bool neg = false;
    if (*p == '-' || *p == '+') {
      neg = (*p == '-');
      ++p;
    }
    uint64_t mant = 0;
    int digits = 0;
    int frac = 0;
    bool ok = true;
    while (p < end && *p >= '0' && *p <= '9') {
      if (digits < 18) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        ++digits;
      } else {
        ok = false;  // too many digits for the exact path
      }
      ++p;
    }
    if (p < end && *p == '.') {
      ++p;
      while (p < end && *p >= '0' && *p <= '9') {
        if (digits < 18) {
          mant = mant * 10 + static_cast<uint64_t>(*p - '0');
          ++digits;
          ++frac;
        } else {
          ok = false;
        }
        ++p;
      }
    }
    int exp10 = 0;
    bool has_exp = false;
    if (p < end && (*p == 'e' || *p == 'E')) {
      has_exp = true;
      ++p;
      bool eneg = false;
      if (p < end && (*p == '-' || *p == '+')) {
        eneg = (*p == '-');
        ++p;
      }
      int e = 0;
      int edigits = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        e = e * 10 + (*p - '0');
        ++edigits;
        ++p;
      }
      if (edigits == 0 || e > 400) ok = false;
      exp10 = eneg ? -e : e;
    }
    if (p == start || (digits == 0 && !has_exp)) {
      // Not a number (inf/nan/garbage): let strtod decide, else skip a byte.
      char *next = nullptr;
      double v = strtod(start, &next);
      if (next == start) {
        ++p;
        continue;
      }
      out[i++] = v;
      p = next;
      continue;
    }
    int net = exp10 - frac;
    // Exactness needs the mantissa representable in a double: <= 15 digits.
    if (ok && digits <= 15 && net >= -22 && net <= 22) {
      double v = static_cast<double>(mant);
      v = net >= 0 ? v * kPow10[net] : v / kPow10[-net];
      out[i++] = neg ? -v : v;
    } else {
      char *next = nullptr;
      out[i++] = strtod(start, &next);
      p = (next > start) ? next : p;
    }
  }
  return i;
}

// Stable LSD radix argsort of uint32 keys (4 x 8-bit passes).
// perm[out rank] = original index; ties keep original order.
// Returns 0 on success, 1 when scratch allocation fails (perm untouched).
int pcc_radix_argsort_u32(const uint32_t *keys, long n, int32_t *perm) {
  int32_t *cur = perm;
  int32_t *tmp = static_cast<int32_t *>(malloc(sizeof(int32_t) * n));
  if (!tmp) return 1;
  for (long i = 0; i < n; ++i) cur[i] = static_cast<int32_t>(i);

  long counts[256];
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    memset(counts, 0, sizeof(counts));
    for (long i = 0; i < n; ++i) {
      ++counts[(keys[cur[i]] >> shift) & 0xFF];
    }
    long total = 0;
    for (int b = 0; b < 256; ++b) {
      long c = counts[b];
      counts[b] = total;
      total += c;
    }
    for (long i = 0; i < n; ++i) {
      tmp[counts[(keys[cur[i]] >> shift) & 0xFF]++] = cur[i];
    }
    int32_t *swap = cur;
    cur = tmp;
    tmp = swap;
  }
  // 4 passes (even): result already in perm.
  free(tmp);
  return 0;
}

// out[i, :] = src[perm[i], :] for (n, cols) float64 matrices.
void pcc_gather_rows_f64(const double *src, const int32_t *perm, long n,
                         long cols, double *out) {
  for (long i = 0; i < n; ++i) {
    memcpy(out + i * cols, src + static_cast<long>(perm[i]) * cols,
           sizeof(double) * cols);
  }
}

}  // extern "C"
