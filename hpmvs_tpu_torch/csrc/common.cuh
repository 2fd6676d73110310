// Device helpers shared by the score (B2) and Gauss-Newton (B4) kernels:
// 4-tap bilinear sampling of a cached (W, W, 3) window, the same sample with
// its partials d/dgx and d/dgy, Patch2d normalisation and its tangent.
//
// Counterparts of hpmvs_tpu/ops/pallas_gn.py:79-185 (hat_sample_ch,
// hat_sample_grad_ch, normalize_ch, normalize_grad_ch). The TPU kernels
// evaluate bilinear sampling as a sum of hat weights over all W window
// columns and rows, because the TPU has no cheap gather. For a coordinate
// clipped to [0, W-1] only two hat weights per axis are non-zero, so here
// each sample reads its 4 taps directly; the two weights are the same
// expressions max(0, 1 - |g - i|) and the taps are summed in the same order,
// so a sample equals the hat sum up to fused multiply-adds. The partials
// reproduce the hat subgradient hat'(u) = -sign(u) on |u| < 1 and 0 at the
// kinks: at an integer coordinate (and at the clipped upper edge) the
// partial along that axis is exactly 0.
#pragma once

#include <cuda_runtime.h>

namespace hpmvs {

constexpr int kP = 7;            // patch grid side (Patch2d.hpp:88)
constexpr int kP2 = kP * kP;     // texels per channel
constexpr int kNT = kP2 * 3;     // texels over all channels

struct Taps {
  int i0;        // first tap index, in [0, W-2]
  float w0, w1;  // hat weights of taps i0 and i0+1
  bool active;   // coordinate strictly between the two taps
};

// g must already be clipped to [0, W-1].
__device__ __forceinline__ Taps taps(float g, int W) {
  Taps t;
  int i = static_cast<int>(floorf(g));
  i = min(max(i, 0), W - 2);
  const float u = g - static_cast<float>(i);
  t.i0 = i;
  t.w0 = 1.0f - fabsf(u);
  t.w1 = 1.0f - fabsf(g - static_cast<float>(i + 1));
  t.active = (u > 0.0f) && (u < 1.0f);
  return t;
}

// win: one (W, W, 3) window, row-major (y, x, channel).
__device__ __forceinline__ void bilinear3(const float* __restrict__ win, int W,
                                          const Taps& tx, const Taps& ty,
                                          float v[3]) {
  const float* r0 = win + (ty.i0 * W + tx.i0) * 3;
  const float* r1 = r0 + W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = tx.w0 * r0[c] + tx.w1 * r0[3 + c];
    const float t1 = tx.w0 * r1[c] + tx.w1 * r1[3 + c];
    v[c] = ty.w0 * t0 + ty.w1 * t1;
  }
}

// bilinear3 plus exact partials along the sample coordinates:
// gx = d v / d gx, gy = d v / d gy.
__device__ __forceinline__ void bilinear3_grad(const float* __restrict__ win,
                                               int W, const Taps& tx,
                                               const Taps& ty, float v[3],
                                               float gx[3], float gy[3]) {
  const float* r0 = win + (ty.i0 * W + tx.i0) * 3;
  const float* r1 = r0 + W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = r0[c], b = r0[3 + c], cc = r1[c], d = r1[3 + c];
    const float t0 = tx.w0 * a + tx.w1 * b;    // row y0 after the x stage
    const float t1 = tx.w0 * cc + tx.w1 * d;   // row y1
    v[c] = ty.w0 * t0 + ty.w1 * t1;
    gy[c] = ty.active ? (t1 - t0) : 0.0f;
    const float s0 = ty.w0 * a + ty.w1 * cc;   // column x0 after the y stage
    const float s1 = ty.w0 * b + ty.w1 * d;    // column x1
    gx[c] = tx.active ? (s1 - s0) : 0.0f;
  }
}

// Patch2d::normalize (Patch2d.hpp:46-84) in place on tex[c][t]: subtract the
// per-channel mean, multiply by 1/std over all channels (1 when std is 0).
// Returns inv = 1/std for the tangent below. Sums run in texel order, then
// channel order (the plain twins sum in the same order). The texel loops
// unroll by one grid row (see gn.cu).
__device__ __forceinline__ float normalize_patch(float tex[3][kP2]) {
  float var = 0.0f;
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll 7
    for (int t = 0; t < kP2; ++t) s += tex[c][t];
    const float mc = s / kP2;
    float v = 0.0f;
#pragma unroll 7
    for (int t = 0; t < kP2; ++t) {
      const float u = tex[c][t] - mc;
      tex[c][t] = u;
      v += u * u;
    }
    var += v;
  }
  const float sd = sqrtf(var / (kP2 * 3.0f));
  const float inv = (sd == 0.0f) ? 1.0f : 1.0f / sd;
  for (int c = 0; c < 3; ++c)
#pragma unroll 7
    for (int t = 0; t < kP2; ++t) tex[c][t] *= inv;
  return inv;
}

}  // namespace hpmvs
