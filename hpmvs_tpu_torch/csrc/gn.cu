// B4/B5: Levenberg patch refinement, one warp per patch. Replaces
// hpmvs_tpu/ops/pallas_gn.py::gn_refine_pallas (body _kernel, :197-595),
// reached from gn_refine_batch (:727-763), in all three of its modes, each a
// separate instantiation of one kernel template (Mode below):
//   kExact  -- the analytic-Jacobian loop (exact_j, :475-522);
//   kFD     -- finite-difference Jacobian refresh + Broyden trials (:524-595);
//   kDebugJ -- rho and the analytic J at x0, no refinement (:466-473).
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
// not clamped (only the angle box applies), each followed by the Broyden
// rank-1 update J += dx (rho_t - rho - J dx) / |dx|^2 (guarded by |dx|^2 >
// 1e-20) whether or not the trial is accepted; hs shrinks by h_shrink after
// the round. The block stops after the first round in which no patch's f
// fell by more than ftol (no two-round hysteresis).
//
// Bound on the H100: latency. The work is small (~1 GFLOP per exact-mode
// call at B=2048, 20 us at the float32 peak) but every pass is a long
// dependent chain: per view the projection and gates, 147 bilinear samples,
// the normalisation and NCC sums, in exact mode three tangent passes with
// sums of their own; view k > 0 needs the reference view's texture, each
// iteration the previous accept test. What sets the time is how short each
// chain is and how many run at once.
//
// Design:
// - One warp per patch, the 7x7 texels across the lanes: lane l owns texel
//   l and, for l < 17, texel l + 32. Every per-texel quantity (the sample
//   and its partials, the centred texture, the reference view's centred
//   texture) stays in the lane's registers; the reference view's three
//   tangents sit in shared memory, lane-minor (kTangents). A sum over
//   texels is the lane's pair, then an xor butterfly (lane_sums): a chain
//   of 6 adds and 5 shuffles instead of 49 serial adds, every lane ending
//   with the same bits, and the channels' sums share their shuffles. Per-patch
//   scalars (frame, normal, per-view projection and gates, Newton step,
//   lambda, accept test) are computed alike in every lane, so they need no
//   broadcast. View k's residual and Jacobian column are kept by lane k;
//   the sums over views shuffle them to every lane in view order. The view
//   loop stays serial (view 0 first).
// - The 128-patch early-stop block is a thread block cluster: 8 CTAs of 16
//   warps, each CTA 16 consecutive patches. Every iteration (exact) or
//   round (FD) the cluster takes the max improvement over its 128 patches
//   through distributed shared memory (cluster_max). At B=2048: 128 CTAs of
//   512 threads, against 16 CTAs of 128 threads for one thread per patch.
//   Each CTA fills an SM's registers, so a cluster takes 8 whole SMs, and
//   an H100 holds 15 clusters at once: B=2048's 16 blocks take two waves.
// - The windows stay in device memory and are read through L1 (4 taps per
//   sample; 6 x 12x12x3 float32 = 10.4 KB per patch).
//
// Block semantics: the TPU kernel decides the early stop over its 128-lane
// block, so a patch's result depends on which 128 patches share its block.
// Here one cluster holds the same 128 consecutive patches; the wrapper pads
// B to a multiple of 128 exactly as the plain twin does.
//
// Rounding: this file compiles without fused multiply-adds (kernels.py,
// SOURCE_FLAGS); texel sums run in the lane order above and the sums over
// channels and views in index order, which the twin reproduces on CUDA
// tensors (ops/gn.py::lane_sum, ops/score.py::seq_sum, div), so kernel and
// twin agree bit for bit. The FD mode needs that: its trajectories are
// chaotic (the twin moved by 1e-6 at x0 ends far from itself on a third of
// the patches), so a kernel that rounded differently could only be held to
// its twin statistically.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using hpmvs::kP;
using hpmvs::kP2;

constexpr int kBlock = 128;                 // patches per early-stop block
constexpr int kWarps = 16;                  // patches (warps) per CTA
constexpr int kCluster = kBlock / kWarps;   // CTAs per cluster (one block)
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = kP2 - 32;            // lanes owning a second texel
constexpr int kMaxK = 32;                   // view k's results in lane k
constexpr unsigned kFull = 0xffffffffu;
static_assert(kP2 > 32 && kP2 <= 64, "two texels per lane");
static_assert(kCluster * 4 == 32 && kWarps == 4 * (32 / kCluster),
              "cluster_max: each lane reads 4 entries of one CTA");

enum class Mode { kExact, kFD, kDebugJ };

struct Statics {
  int W, K, Kw, iters, inner;
  float angle_scale, cos_max, min_images, angle_bound, lam0, ftol,
      step_clamp, h_shrink;
};

struct Inputs {   // the C entry points' arrays (layouts at the bottom)
  const float *x0, *h, *ref, *scale, *pc, *pr, *p9, *camc, *lim, *org,
      *mask, *win;
  float *xout, *fout, *jout, *rhoout;
};

// The lane's texels: slot 0 is texel `lane`, slot 1 texel `lane + 32` when
// two (lanes < 17); the other lanes repeat slot 0 and never add it.
struct Lane {
  int lane;
  bool two;
  float ix[2], iy[2];   // grid column and row of each slot
};

// Result of one value pass: rho is view `lane`'s residual (0 in lanes >= K
// and for the reference view); n and ref_ok are the same in every lane.
struct Value {
  float rho, n, ref_ok;
};

struct Pass : Value {   // ... of one grad pass: plus view `lane`'s J column
  float J[3];
};

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// A sum over the 49 texels starts with the lane's pair: texel l + texel
// l+32 for l < 17; the other lanes add no zero.
__device__ __forceinline__ float pair(float a, float b, bool two) {
  return two ? a + b : a;
}

// N texel sums at once (N a power of 2, unused slots zero), from the
// lanes' pairs v[i]; on return v[i] is sum i in every lane. Each sum is the
// xor butterfly over offsets 16, 8, 4, 2, 1 of the pairs: at every step
// lane l adds lane l^o's partial sum (IEEE addition commutes, so the two
// lanes of a pair get the same bits). While a lane still holds several
// sums it keeps half of them and trades the other half with its partner (a
// reduce-scatter: the same additions of the same partial sums), and a
// shuffle from the lane that ends with sum i brings it to every lane: N - 1
// + 5 - log2(N) + N shuffles instead of 5N. The twin reproduces the order
// (ops/gn.py::lane_sum).
template <int N>
__device__ __forceinline__ void lane_sums(float (&v)[N], int lane) {
  constexpr int kL = ilog2(N);
  static_assert((1 << kL) == N && N <= 32, "N: a power of 2 up to 32");
#pragma unroll
  for (int step = 0; step < kL; ++step) {   // reduce-scatter
    const int o = 16 >> step, n = N >> step;
    const bool up = lane & o;   // keeps the upper half of its sums
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = up ? v[i + n / 2] : v[i];
      const float send = up ? v[i] : v[i + n / 2];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float t = v[0];   // sum (lane >> (5 - kL)) from here on
#pragma unroll
  for (int o = 16 >> kL; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __shfl_sync(kFull, t, i << (5 - kL));
}

// Patch2d::normalize (Patch2d.hpp:46-84) of the warp's texels, in place:
// subtract the per-channel mean, multiply by 1/std over all channels (1 when
// std is 0). Texel sums by lane_sums, channel sums in channel order.
// Returns inv = 1/std for the tangents. (common.cuh::normalize_patch is the
// one-thread form that score.cu uses.)
__device__ __forceinline__ float normalize_lanes(float c[3][2], bool two,
                                                 int lane) {
  float m[4] = {pair(c[0][0], c[0][1], two), pair(c[1][0], c[1][1], two),
                pair(c[2][0], c[2][1], two), 0.0f};
  lane_sums(m, lane);
  float v[4] = {};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float mc = m[ch] / kP2;
    c[ch][0] -= mc;
    c[ch][1] -= mc;
    v[ch] = pair(c[ch][0] * c[ch][0], c[ch][1] * c[ch][1], two);
  }
  lane_sums(v, lane);
  const float var = v[0] + v[1] + v[2];
  const float sd = sqrtf(var / (kP2 * 3.0f));
  const float inv = (sd == 0.0f) ? 1.0f : 1.0f / sd;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    c[ch][0] *= inv;
    c[ch][1] *= inv;
  }
  return inv;
}

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

// The reference view's tangents (3 params x 3 channels x 2 slots) of one
// warp live in shared memory, lane-minor: in registers they pushed the
// exact mode past the 128 registers a thread of a 512-thread CTA may have.
constexpr int kTangents = 3 * 3 * 2;

// One objective pass of patch b at x (kGrad: with the Jacobian, into a
// Pass; dcenr: the warp's tangent scratch + lane). Mirrors grad_pass of
// pallas_gn.py:219-415.
template <bool kGrad, class Out>
__device__ __forceinline__ void objective(const Statics& st,
                                          const Inputs& in, int b,
                                          const Lane& L, const float x[3],
                                          float* dcenr, Out& out) {
  const float sA = st.angle_scale;
  const float W1 = st.W - 1.0f;
  const float half = 0.5f * kP;
  const float* rf = in.ref + b * 15;
  float rc[3], rr[3], e0[3], e1[3], e2[3];
  for (int i = 0; i < 3; ++i) {
    rc[i] = rf[i];
    rr[i] = rf[3 + i];
    e0[i] = rf[6 + i];
    e1[i] = rf[9 + i];
    e2[i] = rf[12 + i];
  }
  const float scale = in.scale[b];
  const float c[3] = {rc[0] + x[0] * rr[0], rc[1] + x[0] * rr[1],
                      rc[2] + x[0] * rr[2]};
  const float a1 = x[1] * sA, a2 = x[2] * sA;
  const float sa1 = sinf(a1), ca1 = cosf(a1), sa2 = sinf(a2), ca2 = cosf(a2);
  auto world = [&](float fx, float fy, float fz, float o[3]) {
    o[0] = e0[0] * fx + e1[0] * fy + e2[0] * fz;
    o[1] = e0[1] * fx + e1[1] * fy + e2[1] * fz;
    o[2] = e0[2] * fx + e1[2] * fy + e2[2] * fz;
  };
  float z[3];
  world(sa1 * ca2, sa2, -ca1 * ca2, z);
  norm3(z[0], z[1], z[2]);
  float u[3];
  cross3(z, e0, u);
  const float rnu =
      rsqrtf(fmaxf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2], 1e-24f));
  const float y[3] = {u[0] * rnu, u[1] * rnu, u[2] * rnu};
  float v[3];
  cross3(y, z, v);
  norm3(v[0], v[1], v[2]);
  const float xax[3] = {v[0] * scale, v[1] * scale, v[2] * scale};
  const float ydot = (y[0] * e1[0] + y[1] * e1[1] + y[2] * e1[2]) * scale;
  const float yax[3] = {y[0] * ydot, y[1] * ydot, y[2] * ydot};

  float dxax[3][3] = {}, dyax[3][3] = {};   // [param][xyz]; param 0 unused
  if constexpr (kGrad) {
    float dz[3][3];   // param 0 unused (depth moves the centre)
    world(ca1 * ca2 * sA, 0.0f, sa1 * ca2 * sA, dz[1]);
    world(-sa1 * sa2 * sA, ca2 * sA, ca1 * sa2 * sA, dz[2]);
    for (int q = 1; q < 3; ++q) {
      const float d = dz[q][0] * z[0] + dz[q][1] * z[1] + dz[q][2] * z[2];
      for (int i = 0; i < 3; ++i) dz[q][i] -= z[i] * d;
    }
    for (int q = 1; q < 3; ++q) {
      float dup[3];
      cross3(dz[q], e0, dup);
      const float ydu = y[0] * dup[0] + y[1] * dup[1] + y[2] * dup[2];
      float dyp[3];
      for (int i = 0; i < 3; ++i) dyp[i] = (dup[i] - y[i] * ydu) * rnu;
      float t1[3], t2[3], dv[3];
      cross3(dyp, z, t1);
      cross3(y, dz[q], t2);
      for (int i = 0; i < 3; ++i) dv[i] = t1[i] + t2[i];
      const float vdv = v[0] * dv[0] + v[1] * dv[1] + v[2] * dv[2];
      for (int i = 0; i < 3; ++i) dxax[q][i] = (dv[i] - v[i] * vdv) * scale;
      const float de1 =
          (dyp[0] * e1[0] + dyp[1] * e1[1] + dyp[2] * e1[2]) * scale;
      for (int i = 0; i < 3; ++i) dyax[q][i] = dyp[i] * ydot + y[i] * de1;
    }
  }

  out.n = 0.0f;
  out.ref_ok = 0.0f;
  out.rho = 0.0f;
  if constexpr (kGrad)
    for (int q = 0; q < 3; ++q) out.J[q] = 0.0f;

  float cenr[3][2];   // reference view, normalised
  const int K = st.K;
  for (int k = 0; k < K; ++k) {   // uniform per warp
    const size_t bk = static_cast<size_t>(b) * K + k;
    const float* pc = in.pc + 3 * bk;
    const float* pr = in.pr + 3 * bk;
    const float* p9 = in.p9 + 9 * bk;
    const float* cc = in.camc + 3 * bk;
    const float* lim = in.lim + 2 * bk;
    const float* org = in.org + 2 * bk;
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
                       (in.mask[bk] > 0.0f);
    if (k == 0) out.ref_ok = valid ? 1.0f : 0.0f;
    // an invalid view k >= 1 contributes nothing; the reference view is
    // always sampled (its texture enters every other view's score)
    if (k > 0 && !valid) continue;

    const float tlx = c2x - half * (dxx + dyx) - oxf;
    const float tly = c2y - half * (dxy + dyy) - oyf;
    const float* w =
        in.win + (static_cast<size_t>(b) * st.Kw + k) * st.W * st.W * 3;
    float cen[3][2];
    [[maybe_unused]] float gx[3][2], gy[3][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float sx =
          fminf(fmaxf(tlx + L.ix[s] * dxx + L.iy[s] * dyx, 0.0f), W1);
      const float sy =
          fminf(fmaxf(tly + L.ix[s] * dxy + L.iy[s] * dyy, 0.0f), W1);
      const hpmvs::Taps tx = hpmvs::taps(sx, st.W);
      const hpmvs::Taps ty = hpmvs::taps(sy, st.W);
      float val[3];
      if constexpr (kGrad) {
        float ggx[3], ggy[3];
        hpmvs::bilinear3_grad(w, st.W, tx, ty, val, ggx, ggy);
        for (int ch = 0; ch < 3; ++ch) {
          gx[ch][s] = ggx[ch];
          gy[ch][s] = ggy[ch];
        }
      } else {
        hpmvs::bilinear3(w, st.W, tx, ty, val);
      }
      for (int ch = 0; ch < 3; ++ch) cen[ch][s] = val[ch];
    }
    [[maybe_unused]] const float inv = normalize_lanes(cen, L.two, L.lane);

    float dot = 0.0f;
    if (k == 0) {
      for (int ch = 0; ch < 3; ++ch)
        for (int s = 0; s < 2; ++s) cenr[ch][s] = cen[ch][s];
    } else {
      float d[4] = {};
      for (int ch = 0; ch < 3; ++ch)
        d[ch] = pair(cenr[ch][0] * cen[ch][0], cenr[ch][1] * cen[ch][1],
                     L.two);
      lane_sums(d, L.lane);
      dot = d[0] + d[1] + d[2];
    }
    const float incc = 1.0f - dot / (kP2 * 3.0f);
    if (k > 0) {
      const float rho = incc / (1.0f + 3.0f * incc);
      if (L.lane == k) out.rho = rho;
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
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float dtlx = dc2x[q] - half * (ddxx[q] + ddyx[q]);
        const float dtly = dc2y[q] - half * (ddxy[q] + ddyy[q]);
        float dtex[3][2];
        for (int s = 0; s < 2; ++s) {
          const float dgx = dtlx + L.ix[s] * ddxx[q] + L.iy[s] * ddyx[q];
          const float dgy = dtly + L.ix[s] * ddxy[q] + L.iy[s] * ddyy[q];
          for (int ch = 0; ch < 3; ++ch)
            dtex[ch][s] = gx[ch][s] * dgx + gy[ch][s] * dgy;
        }
        // normalize_grad_ch (pallas_gn.py:174-185): sums of dtex and of
        // cen * dtex per channel, 6 sums in one lane_sums
        float sm[8] = {};
        for (int ch = 0; ch < 3; ++ch) {
          sm[ch] = pair(dtex[ch][0], dtex[ch][1], L.two);
          sm[3 + ch] = pair(cen[ch][0] * dtex[ch][0],
                            cen[ch][1] * dtex[ch][1], L.two);
        }
        lane_sums(sm, L.lane);
        const float ds = (sm[3] + sm[4] + sm[5]) / (kP2 * 3.0f);
        float term[4] = {};
        for (int ch = 0; ch < 3; ++ch) {
          const float dm = sm[ch] / kP2;
          float t[2];
          for (int s = 0; s < 2; ++s) {
            const float dc =
                (dtex[ch][s] - dm) * inv - cen[ch][s] * (ds * inv);
            float& dr_ = dcenr[32 * ((q * 3 + ch) * 2 + s)];
            if (k == 0)
              dr_ = dc;
            else
              t[s] = dr_ * cen[ch][s] + cenr[ch][s] * dc;
          }
          if (k > 0) term[ch] = pair(t[0], t[1], L.two);
        }
        if (k > 0) {
          lane_sums(term, L.lane);
          const float ddot = term[0] + term[1] + term[2];
          if (L.lane == k) out.J[q] = -ddot / (kP2 * 3.0f) * dr;
        }
      }
    }
  }
}

// Mean residual over the views (in view order), or 2 when the reference
// sample failed or too few views are valid.
__device__ __forceinline__ float mean_or_2(const Statics& st,
                                           const Value& ps) {
  float sum = 0.0f;
  for (int k = 0; k < st.K; ++k) sum += __shfl_sync(kFull, ps.rho, k);
  const float mean = sum / fmaxf(ps.n, 1.0f);
  const bool good = (ps.ref_ok > 0.0f) && (ps.n >= st.min_images - 1.0f);
  return good ? mean : 2.0f;
}

// Damped GN step (pallas_gn.py:435-464) from residuals ps and the lane's
// Jacobian column J (view `lane`: the analytic J of a grad pass, or the
// FD/Broyden column). Every sum over views runs in view order.
__device__ __forceinline__ void newton_step(const Statics& st,
                                            const Value& ps,
                                            const float J[3], float lam,
                                            float step[3]) {
  const float nf = fmaxf(ps.n, 1.0f);
  const float wgt = 0.5f / (ps.rho + 1e-5f);
  float g[3], H[3][3];
  for (int i = 0; i < 3; ++i) {
    float a = 0.0f;
    for (int k = 0; k < st.K; ++k) a += __shfl_sync(kFull, J[i], k);
    g[i] = a / nf;
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = i; j < 3; ++j) {
      const float term = J[i] * wgt * J[j];
      float a = 0.0f;
      for (int k = 0; k < st.K; ++k) a += __shfl_sync(kFull, term, k);
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

// Max of v over the cluster's 128 patches (v is the same in every lane of a
// warp): each warp posts v in its CTA's red[], and after a cluster barrier
// lane l reads 4 entries of CTA l % 8 through distributed shared memory; a
// butterfly gives every lane the max. The second barrier keeps red[] until
// every CTA has read it. Every thread of the cluster must call it.
__device__ __forceinline__ float cluster_max(float v, float* red) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  cluster.sync();
  const float* r =
      cluster.map_shared_rank(red, lane % kCluster) + 4 * (lane / kCluster);
  float m = fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  cluster.sync();
  return m;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The exact-Jacobian loop (pallas_gn.py:475-522): x in/out, returns f.
__device__ __forceinline__ float refine_exact(
    const Statics& st, const Inputs& in, int b, const Lane& L,
    const float h[3], const float lo[3], const float hi[3], float x[3],
    float* dcenr, float* red) {
  float cl[3];
  for (int i = 0; i < 3; ++i) cl[i] = h[i] * st.step_clamp;
  Pass cur, trial;
  objective<true>(st, in, b, L, x, dcenr, cur);
  float f = mean_or_2(st, cur);
  float lam = st.lam0;
  int dry = 0;
  for (int i = 0; i < st.iters - 1 && dry < 2; ++i) {   // uniform per block
    float step[3], xt[3];
    newton_step(st, cur, cur.J, lam, step);
    for (int j = 0; j < 3; ++j)
      xt[j] = clip(x[j] + clip(step[j], -cl[j], cl[j]), lo[j], hi[j]);
    objective<true>(st, in, b, L, xt, dcenr, trial);
    const float ft = mean_or_2(st, trial);
    const bool acc = ft < f;
    const float improved = cluster_max(acc ? f - ft : 0.0f, red);
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
    objective<false>(st, in, b, L, xt, dcenr, tv);
    const float ft = mean_or_2(st, tv);
    if (ft < f) {
      for (int j = 0; j < 3; ++j) x[j] = xt[j];
      f = ft;
    }
  }
  return f;
}

// The FD/Broyden loop (pallas_gn.py:524-595): value passes only. Lane k
// keeps view k's column of J.
__device__ __forceinline__ float refine_fd(
    const Statics& st, const Inputs& in, int b, const Lane& L,
    const float h[3], const float lo[3], const float hi[3], float x[3],
    float* red) {
  Value cur, trial;
  objective<false>(st, in, b, L, x, nullptr, cur);
  float f = mean_or_2(st, cur);
  float lam = st.lam0;
  float hs = 1.0f;
  const int outer = (st.iters + st.inner - 1) / st.inner;
  bool go = true;
  for (int i = 0; i < outer && go; ++i) {   // uniform per block
    const float f_before = f;
    float J[3] = {};
#pragma unroll 1
    for (int q = 0; q < 3; ++q) {   // forward-difference refresh
      // selects, not x[q]: a runtime index would put the arrays in local
      // memory
      const float hq = (q == 0 ? h[0] : q == 1 ? h[1] : h[2]) * hs;
      float xp[3];
      for (int j = 0; j < 3; ++j) xp[j] = (j == q) ? x[j] + hq : x[j];
      objective<false>(st, in, b, L, xp, nullptr, trial);
      const float col = (trial.rho - cur.rho) / hq;
      for (int j = 0; j < 3; ++j) J[j] = (j == q) ? col : J[j];
    }
    for (int t = 0; t < st.inner; ++t) {   // Broyden trials
      float step[3], xn[3], dx[3];
      newton_step(st, cur, J, lam, step);
      for (int j = 0; j < 3; ++j) {
        xn[j] = clip(x[j] + step[j], lo[j], hi[j]);
        dx[j] = xn[j] - x[j];
      }
      objective<false>(st, in, b, L, xn, nullptr, trial);
      const float dd = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
      if (dd > 1e-20f) {
        const float pred = J[0] * dx[0] + J[1] * dx[1] + J[2] * dx[2];
        const float resb = (trial.rho - cur.rho - pred) / dd;
        for (int q = 0; q < 3; ++q) J[q] += dx[q] * resb;
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
    go = cluster_max(f_before - f, red) > st.ftol;
    hs *= st.h_shrink;
  }
  return f;
}

// One warp per patch b = blockIdx.x * 16 + warp; one cluster per 128-patch
// block (B % 128 == 0).
template <Mode M>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
gn_refine_kernel(const __grid_constant__ Statics st,
                 const __grid_constant__ Inputs in) {
  __shared__ float red[kWarps];
  // grad passes: the reference tangents, [warp][param][channel][slot][lane]
  __shared__ float tangents[M == Mode::kFD ? 1 : kWarps * kTangents * 32];
  Lane L;
  L.lane = threadIdx.x & 31;
  L.two = L.lane < kPairs;
  const int t1 = L.two ? L.lane + 32 : L.lane;
  L.ix[0] = static_cast<float>(L.lane % kP);
  L.iy[0] = static_cast<float>(L.lane / kP);
  L.ix[1] = static_cast<float>(t1 % kP);
  L.iy[1] = static_cast<float>(t1 / kP);
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  float* dcenr =
      M == Mode::kFD ? nullptr : tangents + warp * kTangents * 32 + L.lane;

  float x[3], hb[3], lo[3], hi[3];
  for (int i = 0; i < 3; ++i) {
    x[i] = in.x0[b * 3 + i];
    hb[i] = in.h[b * 3 + i];
    lo[i] = (i == 0) ? -1e9f : -st.angle_bound;
    hi[i] = (i == 0) ? 1e9f : st.angle_bound;
  }
  float f;
  if constexpr (M == Mode::kExact) {
    f = refine_exact(st, in, b, L, hb, lo, hi, x, dcenr, red);
  } else if constexpr (M == Mode::kFD) {
    f = refine_fd(st, in, b, L, hb, lo, hi, x, red);
  } else {   // kDebugJ: one grad pass at x0; J (B, 3, K), rho (B, K)
    Pass ps;
    objective<true>(st, in, b, L, x, dcenr, ps);
    f = mean_or_2(st, ps);
    if (L.lane < st.K) {
      const size_t bk = static_cast<size_t>(b) * st.K;
      in.rhoout[bk + L.lane] = ps.rho;
      for (int q = 0; q < 3; ++q) in.jout[3 * bk + q * st.K + L.lane] = ps.J[q];
    }
  }
  if (L.lane < 3)
    in.xout[b * 3 + L.lane] = L.lane == 0 ? x[0] : L.lane == 1 ? x[1] : x[2];
  if (L.lane == 0) in.fout[b] = f;
}

template <Mode M>
int launch(const Inputs& in, int B, const Statics& st, cudaStream_t stream) {
  if (st.K > kMaxK || B % kBlock != 0 || st.inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    gn_refine_kernel<M><<<B / kWarps, kThreads, 0, stream>>>(st, in);
  return static_cast<int>(cudaGetLastError());
}

// The launch of B patches and the compiled kernel's resources, as the
// runtime reports them (see hpmvs_gn_launch_info).
template <Mode M>
int launch_info(int B, int* out) {
  const void* fn = reinterpret_cast<const void*>(&gn_refine_kernel<M>);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / kWarps);
  cfg.blockDim = dim3(kThreads);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  out[0] = B / kWarps;
  out[1] = kThreads;
  out[2] = kCluster;
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = clusters;
  return static_cast<int>(err);
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
  const Inputs in{x0, h, ref, scale, pc, pr, p9, camc, lim, org, mask, win,
                  xout, fout, nullptr, nullptr};
  return launch<Mode::kExact>(in, B, st, stream);
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
  const Inputs in{x0, h, ref, scale, pc, pr, p9, camc, lim, org, mask, win,
                  xout, fout, nullptr, nullptr};
  return launch<Mode::kFD>(in, B, st, stream);
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
  const Inputs in{x0, h, ref, scale, pc, pr, p9, camc, lim, org, mask, win,
                  xout, fout, jout, rhoout};
  return launch<Mode::kDebugJ>(in, B, st, stream);
}

// mode 0 exact, 1 FD, 2 debug_j. out[7]: CTAs for B patches, threads per
// CTA, CTAs per cluster, static shared memory per CTA (bytes), registers
// per thread, local memory per thread (bytes: stack and spills), and the
// most clusters the card holds at once.
extern "C" int hpmvs_gn_launch_info(int mode, int B, int* out) {
  switch (mode) {
    case 0: return launch_info<Mode::kExact>(B, out);
    case 1: return launch_info<Mode::kFD>(B, out);
    case 2: return launch_info<Mode::kDebugJ>(B, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
