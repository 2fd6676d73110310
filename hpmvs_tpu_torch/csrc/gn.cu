// B4/B5: Levenberg patch refinement. Replaces
// hpmvs_tpu/ops/pallas_gn.py::gn_refine_pallas (kernel _kernel, :197-595),
// reached from gn_refine_batch (:727-763), in all three of its modes, each a
// separate instantiation of one kernel template (Mode below):
//   kExact  -- the analytic-Jacobian loop (exact_j, :475-522);
//   kFD     -- finite-difference Jacobian refresh + Broyden trials (:524-595);
//   kDebugJ -- rho and the analytic J at x0, no refinement (:466-473).
// kFD only ever runs value passes, so its instantiation carries none of the
// tangent scratch (the gx/gy partials and the reference tangents) and none of
// the exact mode's register pressure.
//
// Computes, per patch: x = (depth along the reference ray, two normal angles
// in units of pi/48) minimising the mean robust iNCC r/(1+3r) of views
// 1..K-1 against the reference view 0 (2.0 when the reference sample fails
// or fewer than MIN_IMAGES-1 views are valid), sampled from the cached
// windows. Each iteration is one pass that yields the objective and its
// analytic Jacobian (chain through centre shift, normal rotation, patch
// axes, projection, bilinear sampling and Patch2d normalisation); a damped
// 3x3 Gauss-Newton step (Cramer's rule, |det| > 1e-30 guard, non-finite
// components zeroed) is clamped to LM_STEP_CLAMP*h and to the angle box,
// and accepted when f drops (lambda x0.5, else x4). The loop runs while
// i < iters-1 and fewer than 2 consecutive rounds improved any patch of the
// block by more than ftol; a final value-only trial follows.
//
// kFD: one value pass at x0, then at most ceil(iters / inner) rounds. A
// round refreshes J by forward differences (3 value passes at x + e_i h_i hs,
// column (rho_i - rho) / (h_i hs)) and runs `inner` trials whose steps are
// not clamped (only the angle box applies), each followed by the Broyden rank-1 update
// J += dx (rho_t - rho - J dx) / |dx|^2 (guarded by |dx|^2 > 1e-20) whether
// or not the trial is accepted; hs shrinks by h_shrink after the round. The
// block stops after the first round in which no patch's f fell by more
// than ftol (no two-round hysteresis).
//
// Block semantics: the TPU kernel decides the early stop over its 128-lane
// block, so a patch's result depends on which 128 patches share its block.
// Here one CUDA block is the same 128 consecutive patches (one thread per
// patch) and takes the block-wide max of the improvement through shared
// memory every iteration; the wrapper pads B to a multiple of 128 exactly
// as the plain twin does, so both compute the same thing.
//
// Rounding: this file compiles without fused multiply-adds (kernels.py,
// SOURCE_FLAGS) and every sum runs in loop order, which the twin reproduces
// on CUDA tensors (ops/score.py::seq_sum, div), so kernel and twin agree bit
// for bit. The FD mode needs that: its trajectories are chaotic (the twin
// moved by 1e-6 at x0 ends far from itself on a third of the patches), so
// a kernel that rounded differently could only be held to its twin
// statistically.
//
// Bound: latency. Per patch and pass the kernel samples K views x 147
// texels with partials (~40k flops) in a serial dependence chain; the
// per-patch arrays (reference texture and its 3 tangents, the current view's
// samples and partials: ~4 KB) live in thread-local memory, which the
// compiler interleaves across threads so those accesses coalesce and stay in
// L1/L2. Design: simple and right first -- B/128 blocks of 128 threads
// (16 blocks at B=2048) leave most SMs idle; splitting a block's patches
// across a thread block cluster is the obvious next step.
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

using hpmvs::kP;
using hpmvs::kP2;

constexpr int kBlock = 128;   // patches per early-stop block
constexpr int kMaxK = 6;      // MAX_IMAGES_PER_PATCH cap on the view slots

enum class Mode { kExact, kFD, kDebugJ };

struct Statics {
  int W, K, Kw, iters, inner;
  float angle_scale, cos_max, min_images, angle_bound, lam0, ftol,
      step_clamp, h_shrink;
};

struct Patch {   // per-patch constant inputs
  float rc[3], rr[3], e0[3], e1[3], e2[3], scale;
  const float *pc, *pr, *p9, *camc, *lim, *org, *mask, *win;
};

struct Value {   // result of one value pass
  float rho[kMaxK];
  float n, ref_ok;
};

struct Pass : Value {   // result of one grad pass
  float J[3][kMaxK];
};

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float rn = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x *= rn; y *= rn; z *= rn;
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// Scratch of one thread for value passes: reference texture, current view.
struct ValueScratch {
  float cenr[3][kP2];
  float tex[3][kP2];
};

// ... and for grad passes: plus the reference tangents and the partials.
struct GradScratch : ValueScratch {
  float dcenr[3][3][kP2];
  float gx[3][kP2];
  float gy[3][kP2];
};

// One objective pass at x (kGrad: with the Jacobian, into a Pass through a
// GradScratch). Mirrors grad_pass of pallas_gn.py:219-415.
template <bool kGrad, class S, class Out>
__device__ void objective(const Statics& st, const Patch& p, const float x[3],
                          S& s, Out& out) {
  // The texel loops unroll by 7 (one grid row). Fully unrolled, the
  // 147-float textures claim registers and spill (255 registers and 1-2.5 KB
  // of spills in every mode); rolled, every texel access goes to local
  // memory and the FD mode runs about twice as long. By 7, no mode spills.
  const float sA = st.angle_scale;
  const float W1 = st.W - 1.0f;
  const float half = 0.5f * kP;
  const float c[3] = {p.rc[0] + x[0] * p.rr[0], p.rc[1] + x[0] * p.rr[1],
                      p.rc[2] + x[0] * p.rr[2]};
  const float a1 = x[1] * sA, a2 = x[2] * sA;
  const float sa1 = sinf(a1), ca1 = cosf(a1), sa2 = sinf(a2), ca2 = cosf(a2);
  auto world = [&](float fx, float fy, float fz, float o[3]) {
    o[0] = p.e0[0] * fx + p.e1[0] * fy + p.e2[0] * fz;
    o[1] = p.e0[1] * fx + p.e1[1] * fy + p.e2[1] * fz;
    o[2] = p.e0[2] * fx + p.e1[2] * fy + p.e2[2] * fz;
  };
  float z[3];
  world(sa1 * ca2, sa2, -ca1 * ca2, z);
  norm3(z[0], z[1], z[2]);
  float dz[3][3];   // [param][xyz]; param 0 unused (depth moves the centre)
  world(ca1 * ca2 * sA, 0.0f, sa1 * ca2 * sA, dz[1]);
  world(-sa1 * sa2 * sA, ca2 * sA, ca1 * sa2 * sA, dz[2]);
  for (int q = 1; q < 3; ++q) {
    const float d = dz[q][0] * z[0] + dz[q][1] * z[1] + dz[q][2] * z[2];
    for (int i = 0; i < 3; ++i) dz[q][i] -= z[i] * d;
  }
  float u[3];
  cross3(z, p.e0, u);
  const float rnu =
      rsqrtf(fmaxf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2], 1e-24f));
  const float y[3] = {u[0] * rnu, u[1] * rnu, u[2] * rnu};
  float v[3];
  cross3(y, z, v);
  norm3(v[0], v[1], v[2]);
  const float xax[3] = {v[0] * p.scale, v[1] * p.scale, v[2] * p.scale};
  const float ydot =
      (y[0] * p.e1[0] + y[1] * p.e1[1] + y[2] * p.e1[2]) * p.scale;
  const float yax[3] = {y[0] * ydot, y[1] * ydot, y[2] * ydot};

  float dxax[3][3] = {}, dyax[3][3] = {};
  if constexpr (kGrad) {
    for (int q = 1; q < 3; ++q) {
      float dup[3];
      cross3(dz[q], p.e0, dup);
      const float ydu = y[0] * dup[0] + y[1] * dup[1] + y[2] * dup[2];
      float dyp[3];
      for (int i = 0; i < 3; ++i) dyp[i] = (dup[i] - y[i] * ydu) * rnu;
      float t1[3], t2[3], dv[3];
      cross3(dyp, z, t1);
      cross3(y, dz[q], t2);
      for (int i = 0; i < 3; ++i) dv[i] = t1[i] + t2[i];
      const float vdv = v[0] * dv[0] + v[1] * dv[1] + v[2] * dv[2];
      for (int i = 0; i < 3; ++i) dxax[q][i] = (dv[i] - v[i] * vdv) * p.scale;
      const float de1 =
          (dyp[0] * p.e1[0] + dyp[1] * p.e1[1] + dyp[2] * p.e1[2]) * p.scale;
      for (int i = 0; i < 3; ++i) dyax[q][i] = dyp[i] * ydot + y[i] * de1;
    }
  }

  out.n = 0.0f;
  out.ref_ok = 0.0f;
  for (int k = 0; k < kMaxK; ++k) {
    out.rho[k] = 0.0f;
    if constexpr (kGrad)
      for (int q = 0; q < 3; ++q) out.J[q][k] = 0.0f;
  }

  for (int k = 0; k < st.K; ++k) {
    const float* pc = p.pc + 3 * k;
    const float* pr = p.pr + 3 * k;
    const float* p9 = p.p9 + 9 * k;
    const float* cc = p.camc + 3 * k;
    const float* lim = p.lim + 2 * k;
    const float* org = p.org + 2 * k;
    auto pmul = [&](const float w3[3], int i) {
      return p9[3 * i] * w3[0] + p9[3 * i + 1] * w3[1] + p9[3 * i + 2] * w3[2];
    };
    float phc[3], phx[3], phy[3];
    for (int i = 0; i < 3; ++i) phc[i] = pc[i] + x[0] * pr[i];
    for (int i = 0; i < 3; ++i) phx[i] = phc[i] + pmul(xax, i);
    for (int i = 0; i < 3; ++i) phy[i] = phc[i] + pmul(yax, i);
    const bool front = phc[2] > 0.0f;
    const float rwc = 1.0f / (front ? phc[2] : 1.0f);
    const float c2x = phc[0] * rwc, c2y = phc[1] * rwc;
    const float rwx = 1.0f / (phx[2] != 0.0f ? phx[2] : 1.0f);
    const float xx2 = phx[0] * rwx, xy2 = phx[1] * rwx;
    const float dxx = xx2 - c2x, dxy = xy2 - c2y;
    const float rwy = 1.0f / (phy[2] != 0.0f ? phy[2] : 1.0f);
    const float yx2 = phy[0] * rwy, yy2 = phy[1] * rwy;
    const float dyx = yx2 - c2x, dyy = yy2 - c2y;

    float r[3] = {cc[0] - c[0], cc[1] - c[1], cc[2] - c[2]};
    norm3(r[0], r[1], r[2]);
    const bool angle_ok = r[0] * z[0] + r[1] * z[1] + r[2] * z[2] >= st.cos_max;
    const float adx = half * (fabsf(dxx) + fabsf(dyx));
    const float ady = half * (fabsf(dxy) + fabsf(dyy));
    const float mnx = c2x - adx, mxx = c2x + adx;
    const float mny = c2y - ady, mxy = c2y + ady;
    const bool bounds_ok = (mnx >= 3.0f) && (mny >= 3.0f) &&
                           (mxx < lim[0] - 3.0f) && (mxy < lim[1] - 3.0f);
    const float oxf = org[0], oyf = org[1];
    const bool cover_ok = (mnx - oxf >= 0.0f) && (mny - oyf >= 0.0f) &&
                          (mxx - oxf <= W1) && (mxy - oyf <= W1);
    const bool valid = front && angle_ok && bounds_ok && cover_ok &&
                       (p.mask[k] > 0.0f);
    if (k == 0) out.ref_ok = valid ? 1.0f : 0.0f;
    // an invalid view k >= 1 contributes nothing; the reference view is
    // always sampled (its texture enters every other view's score)
    if (k > 0 && !valid) continue;

    const float tlx = c2x - half * (dxx + dyx) - oxf;
    const float tly = c2y - half * (dxy + dyy) - oyf;
    const float* w = p.win + static_cast<size_t>(k) * st.W * st.W * 3;
#pragma unroll 7
    for (int t = 0; t < kP2; ++t) {
      const float ix = static_cast<float>(t % kP);
      const float iy = static_cast<float>(t / kP);
      const float gx = fminf(fmaxf(tlx + ix * dxx + iy * dyx, 0.0f), W1);
      const float gy = fminf(fmaxf(tly + ix * dxy + iy * dyy, 0.0f), W1);
      float val[3];
      const hpmvs::Taps tx = hpmvs::taps(gx, st.W);
      const hpmvs::Taps ty = hpmvs::taps(gy, st.W);
      if constexpr (kGrad) {
        float ggx[3], ggy[3];
        hpmvs::bilinear3_grad(w, st.W, tx, ty, val, ggx, ggy);
        for (int ch = 0; ch < 3; ++ch) {
          s.gx[ch][t] = ggx[ch];
          s.gy[ch][t] = ggy[ch];
        }
      } else {
        hpmvs::bilinear3(w, st.W, tx, ty, val);
      }
      for (int ch = 0; ch < 3; ++ch) s.tex[ch][t] = val[ch];
    }
    [[maybe_unused]] const float inv =
        hpmvs::normalize_patch(s.tex);   // s.tex := cen

    float dot = 0.0f;
    if (k == 0) {
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll 7
        for (int t = 0; t < kP2; ++t) s.cenr[ch][t] = s.tex[ch][t];
    } else {
      for (int ch = 0; ch < 3; ++ch) {
        float a = 0.0f;
#pragma unroll 7
        for (int t = 0; t < kP2; ++t) a += s.cenr[ch][t] * s.tex[ch][t];
        dot += a;
      }
    }
    const float incc = 1.0f - dot / (kP2 * 3.0f);
    if (k > 0) {
      out.rho[k] = incc / (1.0f + 3.0f * incc);
      out.n += 1.0f;
    }
    if constexpr (kGrad) {
      // tangents of (c2, du, dv) per parameter (pallas_gn.py:337-355)
      float dc2x[3], dc2y[3], ddxx[3], ddxy[3], ddyx[3], ddyy[3];
      dc2x[0] = (pr[0] - c2x * pr[2]) * rwc;
      dc2y[0] = (pr[1] - c2y * pr[2]) * rwc;
      ddxx[0] = (pr[0] - xx2 * pr[2]) * rwx - dc2x[0];
      ddxy[0] = (pr[1] - xy2 * pr[2]) * rwx - dc2y[0];
      ddyx[0] = (pr[0] - yx2 * pr[2]) * rwy - dc2x[0];
      ddyy[0] = (pr[1] - yy2 * pr[2]) * rwy - dc2y[0];
      for (int q = 1; q < 3; ++q) {
        const float a0 = pmul(dxax[q], 0), a1_ = pmul(dxax[q], 1),
                    a2_ = pmul(dxax[q], 2);
        const float b0 = pmul(dyax[q], 0), b1 = pmul(dyax[q], 1),
                    b2 = pmul(dyax[q], 2);
        dc2x[q] = 0.0f;
        dc2y[q] = 0.0f;
        ddxx[q] = (a0 - xx2 * a2_) * rwx;
        ddxy[q] = (a1_ - xy2 * a2_) * rwx;
        ddyx[q] = (b0 - yx2 * b2) * rwy;
        ddyy[q] = (b1 - yy2 * b2) * rwy;
      }
      const float dr = 1.0f / ((1.0f + 3.0f * incc) * (1.0f + 3.0f * incc));
      for (int q = 0; q < 3; ++q) {
        const float dtlx = dc2x[q] - half * (ddxx[q] + ddyx[q]);
        const float dtly = dc2y[q] - half * (ddxy[q] + ddyy[q]);
        auto dtex = [&](int ch, int t) {
          const float ix = static_cast<float>(t % kP);
          const float iy = static_cast<float>(t / kP);
          const float dgx = dtlx + ix * ddxx[q] + iy * ddyx[q];
          const float dgy = dtly + ix * ddxy[q] + iy * ddyy[q];
          return s.gx[ch][t] * dgx + s.gy[ch][t] * dgy;
        };
        // normalize_grad_ch (pallas_gn.py:174-185)
        float dm[3];
        float ds = 0.0f;
        for (int ch = 0; ch < 3; ++ch) {
          float sm = 0.0f, sc = 0.0f;
          for (int t = 0; t < kP2; ++t) {
            const float d = dtex(ch, t);
            sm += d;
            sc += s.tex[ch][t] * d;
          }
          dm[ch] = sm / kP2;
          ds += sc;
        }
        ds = ds / (kP2 * 3.0f);
        float ddot = 0.0f;
        for (int ch = 0; ch < 3; ++ch) {
          float a = 0.0f;
          for (int t = 0; t < kP2; ++t) {
            const float dc = (dtex(ch, t) - dm[ch]) * inv - s.tex[ch][t] * (ds * inv);
            if (k == 0)
              s.dcenr[q][ch][t] = dc;
            else
              a += s.dcenr[q][ch][t] * s.tex[ch][t] + s.cenr[ch][t] * dc;
          }
          ddot += a;
        }
        if (k > 0) out.J[q][k] = -ddot / (kP2 * 3.0f) * dr;
      }
    }
  }
}

__device__ __forceinline__ float mean_or_2(const Statics& st, const Value& ps) {
  float sum = 0.0f;
  for (int k = 0; k < st.K; ++k) sum += ps.rho[k];
  const float mean = sum / fmaxf(ps.n, 1.0f);
  const bool good = (ps.ref_ok > 0.0f) && (ps.n >= st.min_images - 1.0f);
  return good ? mean : 2.0f;
}

// Damped GN step (pallas_gn.py:435-464) from residuals ps and Jacobian
// columns J (the analytic J of a grad pass, or the FD/Broyden columns).
__device__ void newton_step(const Statics& st, const Value& ps,
                            const float J[3][kMaxK], float lam,
                            float step[3]) {
  const float nf = fmaxf(ps.n, 1.0f);
  float g[3], H[3][3];
  for (int i = 0; i < 3; ++i) {
    float a = 0.0f;
    for (int k = 0; k < st.K; ++k) a += J[i][k];
    g[i] = a / nf;
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = i; j < 3; ++j) {
      float a = 0.0f;
      for (int k = 0; k < st.K; ++k) {
        const float wgt = 0.5f / (ps.rho[k] + 1e-5f);
        a += J[i][k] * wgt * J[j][k];
      }
      H[i][j] = a / nf;
    }
  }
  const float d = 1e-6f;
  const float h00 = H[0][0] + lam * fmaxf(fabsf(H[0][0]), d);
  const float h11 = H[1][1] + lam * fmaxf(fabsf(H[1][1]), d);
  const float h22 = H[2][2] + lam * fmaxf(fabsf(H[2][2]), d);
  const float h01 = H[0][1], h02 = H[0][2], h12 = H[1][2];
  const float c00 = h11 * h22 - h12 * h12;
  const float c01 = h02 * h12 - h01 * h22;
  const float c02 = h01 * h12 - h02 * h11;
  const float c11 = h00 * h22 - h02 * h02;
  const float c12 = h01 * h02 - h00 * h12;
  const float c22 = h00 * h11 - h01 * h01;
  const float det = h00 * c00 + h01 * c01 + h02 * c02;
  const float rdet = (fabsf(det) > 1e-30f) ? 1.0f / det : 0.0f;
  step[0] = -(c00 * g[0] + c01 * g[1] + c02 * g[2]) * rdet;
  step[1] = -(c01 * g[0] + c11 * g[1] + c12 * g[2]) * rdet;
  step[2] = -(c02 * g[0] + c12 * g[1] + c22 * g[2]) * rdet;
  for (int i = 0; i < 3; ++i)
    if (!isfinite(step[i])) step[i] = 0.0f;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                 // red[] free from the previous call
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < kBlock / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The exact-Jacobian loop (pallas_gn.py:475-522): x in/out, returns f.
__device__ float refine_exact(const Statics& st, const Patch& p,
                              const float h[3], const float lo[3],
                              const float hi[3], float x[3], float* red) {
  GradScratch s;
  float cl[3];
  for (int i = 0; i < 3; ++i) cl[i] = h[i] * st.step_clamp;
  Pass cur, trial;
  objective<true>(st, p, x, s, cur);
  float f = mean_or_2(st, cur);
  float lam = st.lam0;
  int dry = 0;
  for (int i = 0; i < st.iters - 1 && dry < 2; ++i) {   // uniform per block
    float step[3], xt[3];
    newton_step(st, cur, cur.J, lam, step);
    for (int j = 0; j < 3; ++j)
      xt[j] = clip(x[j] + clip(step[j], -cl[j], cl[j]), lo[j], hi[j]);
    objective<true>(st, p, xt, s, trial);
    const float ft = mean_or_2(st, trial);
    const bool acc = ft < f;
    const float improved = block_max(acc ? f - ft : 0.0f, red);
    if (acc) {
      for (int j = 0; j < 3; ++j) x[j] = xt[j];
      cur = trial;
      f = ft;
    }
    lam = clip(acc ? lam * 0.5f : lam * 4.0f, 1e-7f, 1e7f);
    dry = (improved > st.ftol) ? 0 : dry + 1;
  }
  if (st.iters > 0) {   // final trial: value only
    float step[3], xt[3];
    newton_step(st, cur, cur.J, lam, step);
    for (int j = 0; j < 3; ++j)
      xt[j] = clip(x[j] + clip(step[j], -cl[j], cl[j]), lo[j], hi[j]);
    Value tv;
    objective<false>(st, p, xt, s, tv);
    const float ft = mean_or_2(st, tv);
    if (ft < f) {
      for (int j = 0; j < 3; ++j) x[j] = xt[j];
      f = ft;
    }
  }
  return f;
}

// The FD/Broyden loop (pallas_gn.py:524-595): value passes only.
__device__ float refine_fd(const Statics& st, const Patch& p,
                           const float h[3], const float lo[3],
                           const float hi[3], float x[3], float* red) {
  ValueScratch s;
  Value cur, trial;
  objective<false>(st, p, x, s, cur);
  float f = mean_or_2(st, cur);
  float lam = st.lam0;
  float hs = 1.0f;
  const int outer = (st.iters + st.inner - 1) / st.inner;
  bool go = true;
  for (int i = 0; i < outer && go; ++i) {   // uniform per block
    const float f_before = f;
    float J[3][kMaxK] = {};
    for (int q = 0; q < 3; ++q) {   // forward-difference refresh
      const float hq = h[q] * hs;
      float xp[3] = {x[0], x[1], x[2]};
      xp[q] = x[q] + hq;
      objective<false>(st, p, xp, s, trial);
      for (int k = 0; k < st.K; ++k) J[q][k] = (trial.rho[k] - cur.rho[k]) / hq;
    }
    for (int t = 0; t < st.inner; ++t) {   // Broyden trials
      float step[3], xn[3], dx[3];
      newton_step(st, cur, J, lam, step);
      for (int j = 0; j < 3; ++j) {
        xn[j] = clip(x[j] + step[j], lo[j], hi[j]);
        dx[j] = xn[j] - x[j];
      }
      objective<false>(st, p, xn, s, trial);
      const float dd = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
      if (dd > 1e-20f) {
        for (int k = 0; k < st.K; ++k) {
          const float pred = J[0][k] * dx[0] + J[1][k] * dx[1] + J[2][k] * dx[2];
          const float resb = (trial.rho[k] - cur.rho[k] - pred) / dd;
          for (int q = 0; q < 3; ++q) J[q][k] += dx[q] * resb;
        }
      }
      const float ft = mean_or_2(st, trial);
      const bool acc = ft < f;
      if (acc) {
        for (int j = 0; j < 3; ++j) x[j] = xn[j];
        cur = trial;
        f = ft;
      }
      lam = clip(acc ? lam * 0.5f : lam * 4.0f, 1e-7f, 1e7f);
    }
    // accepted trials only lower f; the round helped if ANY patch moved
    go = block_max(f_before - f, red) > st.ftol;
    hs *= st.h_shrink;
  }
  return f;
}

template <Mode M>
__global__ void __launch_bounds__(kBlock)
gn_refine_kernel(Statics st, const float* __restrict__ x0,
                 const float* __restrict__ h, const float* __restrict__ ref,
                 const float* __restrict__ scale, const float* pc,
                 const float* pr, const float* p9, const float* camc,
                 const float* lim, const float* org, const float* mask,
                 const float* win, float* __restrict__ xout,
                 float* __restrict__ fout, float* __restrict__ jout,
                 float* __restrict__ rhoout) {
  __shared__ float red[kBlock / 32];
  const int b = blockIdx.x * kBlock + threadIdx.x;   // B % 128 == 0
  const int K = st.K;
  Patch p;
  for (int i = 0; i < 3; ++i) {
    p.rc[i] = ref[b * 15 + 0 + i];
    p.rr[i] = ref[b * 15 + 3 + i];
    p.e0[i] = ref[b * 15 + 6 + i];
    p.e1[i] = ref[b * 15 + 9 + i];
    p.e2[i] = ref[b * 15 + 12 + i];
  }
  p.scale = scale[b];
  p.pc = pc + static_cast<size_t>(b) * K * 3;
  p.pr = pr + static_cast<size_t>(b) * K * 3;
  p.p9 = p9 + static_cast<size_t>(b) * K * 9;
  p.camc = camc + static_cast<size_t>(b) * K * 3;
  p.lim = lim + static_cast<size_t>(b) * K * 2;
  p.org = org + static_cast<size_t>(b) * K * 2;
  p.mask = mask + static_cast<size_t>(b) * K;
  p.win = win + static_cast<size_t>(b) * st.Kw * st.W * st.W * 3;

  float x[3], hb[3], lo[3], hi[3];
  for (int i = 0; i < 3; ++i) {
    x[i] = x0[b * 3 + i];
    hb[i] = h[b * 3 + i];
    lo[i] = (i == 0) ? -1e9f : -st.angle_bound;
    hi[i] = (i == 0) ? 1e9f : st.angle_bound;
  }
  float f;
  if constexpr (M == Mode::kExact) {
    f = refine_exact(st, p, hb, lo, hi, x, red);
  } else if constexpr (M == Mode::kFD) {
    f = refine_fd(st, p, hb, lo, hi, x, red);
  } else {   // kDebugJ: one grad pass at x0; J (B, 3, K), rho (B, K)
    GradScratch s;
    Pass ps;
    objective<true>(st, p, x, s, ps);
    f = mean_or_2(st, ps);
    for (int k = 0; k < K; ++k) {
      rhoout[static_cast<size_t>(b) * K + k] = ps.rho[k];
      for (int q = 0; q < 3; ++q)
        jout[(static_cast<size_t>(b) * 3 + q) * K + k] = ps.J[q][k];
    }
  }
  for (int j = 0; j < 3; ++j) xout[b * 3 + j] = x[j];
  fout[b] = f;
}

template <Mode M>
int launch(const float* x0, const float* h, const float* ref,
           const float* scale, const float* pc, const float* pr,
           const float* p9, const float* camc, const float* lim,
           const float* org, const float* mask, const float* win, float* xout,
           float* fout, float* jout, float* rhoout, int B, const Statics& st,
           cudaStream_t stream) {
  if (st.K > kMaxK || B % kBlock != 0 || st.inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    gn_refine_kernel<M><<<B / kBlock, kBlock, 0, stream>>>(
        st, x0, h, ref, scale, pc, pr, p9, camc, lim, org, mask, win, xout,
        fout, jout, rhoout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The three C entry points share the input layout: x0/h (B, 3), ref (B, 5,
// 3), scale (B,), pc/pr/camc (B, K, 3), p9 (B, K, 9), lim/org (B, K, 2),
// mask (B, K), win (B, Kw, W, W, 3); outputs x (B, 3), f (B,).
extern "C" int hpmvs_gn_refine(const float* x0, const float* h,
                               const float* ref, const float* scale,
                               const float* pc, const float* pr,
                               const float* p9, const float* camc,
                               const float* lim, const float* org,
                               const float* mask, const float* win,
                               float* xout, float* fout, int B, int K, int Kw,
                               int W, int iters, float angle_scale,
                               float cos_max, float min_images,
                               float angle_bound, float lam0, float ftol,
                               float step_clamp, cudaStream_t stream) {
  const Statics st{W, K, Kw, iters, 1, angle_scale, cos_max, min_images,
                   angle_bound, lam0, ftol, step_clamp, 1.0f};
  return launch<Mode::kExact>(x0, h, ref, scale, pc, pr, p9, camc, lim, org,
                              mask, win, xout, fout, nullptr, nullptr, B, st,
                              stream);
}

extern "C" int hpmvs_gn_refine_fd(const float* x0, const float* h,
                                  const float* ref, const float* scale,
                                  const float* pc, const float* pr,
                                  const float* p9, const float* camc,
                                  const float* lim, const float* org,
                                  const float* mask, const float* win,
                                  float* xout, float* fout, int B, int K,
                                  int Kw, int W, int iters, int inner,
                                  float angle_scale, float cos_max,
                                  float min_images, float angle_bound,
                                  float lam0, float ftol, float h_shrink,
                                  cudaStream_t stream) {
  const Statics st{W, K, Kw, iters, inner, angle_scale, cos_max, min_images,
                   angle_bound, lam0, ftol, 0.0f, h_shrink};
  return launch<Mode::kFD>(x0, h, ref, scale, pc, pr, p9, camc, lim, org,
                           mask, win, xout, fout, nullptr, nullptr, B, st,
                           stream);
}

// jout (B, 3, K) and rhoout (B, K): the analytic J and rho at x0.
extern "C" int hpmvs_gn_debug_j(const float* x0, const float* h,
                                const float* ref, const float* scale,
                                const float* pc, const float* pr,
                                const float* p9, const float* camc,
                                const float* lim, const float* org,
                                const float* mask, const float* win,
                                float* xout, float* fout, float* jout,
                                float* rhoout, int B, int K, int Kw, int W,
                                float angle_scale, float cos_max,
                                float min_images, cudaStream_t stream) {
  const Statics st{W, K, Kw, 0, 1, angle_scale, cos_max, min_images,
                   0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  return launch<Mode::kDebugJ>(x0, h, ref, scale, pc, pr, p9, camc, lim, org,
                               mask, win, xout, fout, jout, rhoout, B, st,
                               stream);
}
