// ASCII PLY body formatter for hpmvs_tpu_torch/io/ply.py::write_ext_ply.
//
// Writes the same text as the Python writer's f-strings: each float32 value
// as repr(float(x)) (the shortest digits that round-trip the float64 it
// widens to, in Python's layout), colours and visibility lists as decimal
// integers, every line ending in a space and a newline. One call formats a
// block of rows into a caller's buffer and returns the bytes it wrote.
//
// Built into the port's native library beside octree_core.cpp
// (hpmvs_tpu_torch/core/native.py); needs C++17 (std::to_chars of double).

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// repr(float(x)) of a float32: std::to_chars gives the shortest digits,
// then Python's layout (float_repr_style 'short', format code 'r'): fixed
// notation when the decimal point falls in (-4, 16], with ".0" on whole
// numbers, else d.ddde+XX; nan, inf and -0.0 spelt as Python spells them.
char* put_float(char* p, float f) {
  double x = static_cast<double>(f);
  if (std::isnan(x)) {
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::signbit(x)) {
    *p++ = '-';
    x = -x;
  }
  if (std::isinf(x)) {
    std::memcpy(p, "inf", 3);
    return p + 3;
  }
  if (x == 0.0) {
    std::memcpy(p, "0.0", 3);
    return p + 3;
  }
  // the shortest digits in scientific form, "d[.ddd]e[+-]XX", which is
  // already Python's exponent layout
  char* e = std::to_chars(p, p + 32, x, std::chars_format::scientific).ptr;
  char* m = e - 1;
  while (*m != 'e') --m;
  int exp10 = 0;
  for (const char* q = m + 2; q < e; ++q) exp10 = 10 * exp10 + (*q - '0');
  if (m[1] == '-') exp10 = -exp10;
  if (exp10 < -4 || exp10 > 15) return e;
  // fixed: the digits d0 d1 ... (the point after d0 in p) moved so that
  // the point falls after digit exp10 + 1
  int nd = m - p - (m - p > 1);    // digits without the point
  if (nd > 1) std::memmove(p + 1, p + 2, nd - 1);
  if (exp10 < 0) {
    int shift = 1 - exp10;         // "0." and -exp10 - 1 zeros
    std::memmove(p + shift, p, nd);
    p[0] = '0';
    p[1] = '.';
    for (int i = 2; i < shift; ++i) p[i] = '0';
    return p + shift + nd;
  }
  int decpt = exp10 + 1;
  if (decpt < nd) {
    std::memmove(p + decpt + 1, p + decpt, nd - decpt);
    p[decpt] = '.';
    return p + nd + 1;
  }
  for (int i = nd; i < decpt; ++i) p[i] = '0';
  p[decpt] = '.';
  p[decpt + 1] = '0';
  return p + decpt + 2;
}

template <typename T>
char* put_int(char* p, T v) {
  return std::to_chars(p, p + 16, v).ptr;
}

}  // namespace

extern "C" {

// Vertex rows i0..i1-1: "x y z [nx ny nz ]r g b [s ]\n". centers and
// normals are (N, 3), colors (N, 3) uint8, scales (N,); at most
// 3 + 3 * normal + scale floats of <= 24 bytes and 3 colours of <= 3
// bytes, each with its space, and the newline: 256 bytes a row.
int64_t ply_format_vertices(int64_t i0, int64_t i1, const float* centers,
                            const float* normals, const uint8_t* colors,
                            const float* scales, int64_t normal,
                            int64_t scale, char* out) {
  char* p = out;
  for (int64_t i = i0; i < i1; ++i) {
    for (int j = 0; j < 3; ++j) {
      p = put_float(p, centers[3 * i + j]);
      *p++ = ' ';
    }
    if (normal) {
      for (int j = 0; j < 3; ++j) {
        p = put_float(p, normals[3 * i + j]);
        *p++ = ' ';
      }
    }
    for (int j = 0; j < 3; ++j) {
      p = put_int(p, static_cast<unsigned>(colors[3 * i + j]));
      *p++ = ' ';
    }
    if (scale) {
      p = put_float(p, scales[i]);
      *p++ = ' ';
    }
    *p++ = '\n';
  }
  return p - out;
}

// Visibility rows i0..i1-1: "k v0 ... vk-1 \n" (k = 0 gives "0  \n"), the
// first nviews[i] entries of row i of views (N, K); 12 * (K + 1) + 2
// bytes a row at most.
int64_t ply_format_visibility(int64_t i0, int64_t i1, int64_t K,
                              const int32_t* views, const int32_t* nviews,
                              char* out) {
  char* p = out;
  for (int64_t i = i0; i < i1; ++i) {
    int32_t k = nviews[i];
    p = put_int(p, k);
    *p++ = ' ';
    const int32_t* row = views + i * K;
    for (int32_t j = 0; j < k; ++j) {
      if (j) *p++ = ' ';
      p = put_int(p, row[j]);
    }
    *p++ = ' ';
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
