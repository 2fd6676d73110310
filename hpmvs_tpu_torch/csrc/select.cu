// View selection of the batched stage pipelines (ops/optimizer.py): the
// per-patch logic that picks and orders each patch's view slots. Replaces no
// TPU kernel: on the TPU these stages are XLA fusions, in the port they were
// chains of plain PyTorch ops, some 590 launches per optimize call, whose
// host enqueue held the card idle. Two entry points, one thread per patch:
//
//   add_views_kernel  -- addImages (PatchOptimizer.cpp:225-258), the twin
//     ops/optimizer.py::_add_images_twin: walk the C covisible candidates of
//     the reference view, accept those not yet in the K slots that pass the
//     ray/normal angle, the pyramid level and the image-bounds tests, append
//     them after the valid slots (stable), keep the first K.
//   sort_views_kernel -- filterImagesNCC(NCC_ALPHA_1), sortImages and
//     assureImageAngles (PatchOptimizer.cpp:105-123, 138-152, 183-223) on the
//     NCCs of the pre stage, the twin ops/optimizer.py::_sort_views_twin:
//     the NCC keep mask and its stable compaction (order o1), the greedy
//     suppression sort (order o2, argmin ties to the lowest slot, NaN first),
//     the pairwise angle test, and the composed slot order o1[o2] that the
//     window permute takes.
//
// Bound: latency. A patch reads ~0.2 KB of tables and writes 9 K bytes; the
// work is a few thousand float operations in a K-round loop. One thread per
// patch keeps every slot array in registers and local memory; blocks of one
// warp spread a batch of 2048 over 64 SMs.
//
// Each float operation rounds as the twin's torch op does on CUDA (this file
// compiles without FMA contraction, kernels.SOURCE_FLAGS): sums and 2-norms
// over 3 in torch's reduction order, (x0 + x2) + x1 (two lanes, the second
// element joining last); the projection and pairwise ray dots in the order of
// the cuBLAS kernels the twin's einsums run at the main path's shapes (see
// proj_row); log2f, exp2f, acosf, sqrtf, rintf and IEEE division as torch's
// CUDA ops call them; clamps, minima and maxima that keep NaN as torch does;
// f2i's saturating NaN-to-0 conversion.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 32;     // K and C limit (the wrapper checks)
constexpr float kBig = 1e9f;      // optimizer.BIG

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]));
}

// torch.clamp / maximum / minimum: NaN in, NaN out.
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// camera.f2i: NaN -> 0, saturate, truncate.
__device__ __forceinline__ int f2i(float v) {
  if (isnan(v)) return 0;
  return static_cast<int>(fminf(fmaxf(v, -2147483648.0f), 2147483520.0f));
}

// sampling.normalize3 of cam_center[ci] - c; fz is the norm before the clamp
// (camera.get_level/get_scale's |c - cam_center|, the same squares).
__device__ __forceinline__ void ray_to(const float* __restrict__ cam_center,
                                       int ci, const float c[3], float r[3],
                                       float& fz) {
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = cam_center[ci * 3 + i] - c[i];
  fz = norm3(d);
  const float n = clamp_min_nan(fz, 1e-12f);
  for (int i = 0; i < 3; ++i) r[i] = d[i] / n;
}

__device__ __forceinline__ void normalize(const float v[3], float r[3]) {
  const float n = clamp_min_nan(norm3(v), 1e-12f);
  for (int i = 0; i < 3; ++i) r[i] = v[i] / n;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// One row of camera.mult's einsum, P[0..3] . (x, y, z, 1): a batched
// (3,4) x (4,1) product that cuBLAS runs as gemv, two lanes of two fused
// terms each. Which terms a lane takes depends on the batch: (0,2)(1,3) at
// the main path's 2048 lanes x 8-16 candidates, (0,1)(2,3) at others (an
// H100 with CUDA 12.8, PERF.md section 6), so this order matches torch's
// there and elsewhere may differ by an ulp (kernel_check.check_select's
// rule for the lanes that then differ).
__device__ __forceinline__ float proj_row(const float* __restrict__ P,
                                          const float c[3]) {
  return fmaf(P[2], c[2], P[0] * c[0]) + (P[1] * c[1] + P[3]);
}

// One entry of _pair_angles' einsum (a batched (K,3) x (3,K) product that
// cuBLAS runs as one fused chain; a batch of one patch runs unfused).
__device__ __forceinline__ float pair_dot(const float a[3], const float b[3]) {
  float acc = a[0] * b[0];
  acc = fmaf(a[1], b[1], acc);
  return fmaf(a[2], b[2], acc);
}

__global__ void add_views_kernel(
    const int* __restrict__ views, const float* __restrict__ center,
    const float* __restrict__ normal, const float* __restrict__ scale,
    const int* __restrict__ covis, const float* __restrict__ cam_center,
    const float* __restrict__ fsum, const float* __restrict__ P,
    const int* __restrict__ width, const int* __restrict__ height, int B,
    int K, int C, int nlev, float cos_max, int minlevel, int maxlevel,
    int min_images, int* __restrict__ out_views, bool* __restrict__ ok) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* v = views + b * K;
  int* out = out_views + b * K;
  const float c[3] = {center[b * 3], center[b * 3 + 1], center[b * 3 + 2]};
  const float n[3] = {normal[b * 3], normal[b * 3 + 1], normal[b * 3 + 2]};
  float nz[3];
  normalize(n, nz);
  const float sc = scale[b];
  const int ref = v[0];
  const bool ref_valid = ref >= 0;
  const int* cov = covis + max(ref, 0) * C;

  int cnt = 0;
  for (int k = 0; k < K; ++k)
    if (v[k] >= 0) out[cnt++] = v[k];
  for (int j = 0; j < C && cnt < K && ref_valid; ++j) {
    const int cand = cov[j];
    if (cand < 0) continue;
    bool present = false;
    for (int k = 0; k < K; ++k) present |= v[k] == cand;
    if (present) continue;
    float ray[3], fz;
    ray_to(cam_center, cand, c, ray, fz);
    if (!(dot3(ray, nz) >= cos_max)) continue;
    const int lvl = f2i(rintf(log2f((sc * fsum[cand]) / (2.0f * fz))));
    if (!(lvl >= minlevel && lvl < maxlevel - 2)) continue;
    const int lc = min(max(lvl, 0), maxlevel);
    const float* Pm = P + (cand * nlev + lc) * 12;
    const float w = proj_row(Pm + 8, c);
    if (!(w > 0.0f)) continue;                    // behind: (-0xffff, ...)
    const float x = proj_row(Pm, c) / w;
    const float y = proj_row(Pm + 4, c) / w;
    const float wl = static_cast<float>(width[cand * nlev + lc]);
    const float hl = static_cast<float>(height[cand * nlev + lc]);
    if (x >= 0.0f && x < wl - 1.0f && y >= 0.0f && y < hl - 1.0f)
      out[cnt++] = cand;
  }
  ok[b] = ref_valid && cnt >= min_images;
  for (int k = cnt; k < K; ++k) out[k] = -1;
}

// argmin over w[0..K): the first NaN if any, else the lowest slot of the
// smallest value (torch.argmin).
__device__ __forceinline__ int argmin_nan(const float* w, int K) {
  int best = 0;
  for (int k = 1; k < K; ++k) {
    const float a = w[k], m = w[best];
    if (isnan(m)) break;
    if (isnan(a) || a < m) best = k;
  }
  return best;
}

__global__ void sort_views_kernel(
    const int* __restrict__ views, const float* __restrict__ nccs,
    const bool* __restrict__ valid, const float* __restrict__ center,
    const float* __restrict__ normal, const float* __restrict__ scale,
    const float* __restrict__ cam_center, const float* __restrict__ fsum,
    int B, int K, float keep_thr, float thr, int maxlevel, int min_images,
    float min_angle, float max_angle, int* __restrict__ out_views,
    bool* __restrict__ ok, int* __restrict__ order) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* v = views + b * K;
  const float c[3] = {center[b * 3], center[b * 3 + 1], center[b * 3 + 2]};
  const float n[3] = {normal[b * 3], normal[b * 3 + 1], normal[b * 3 + 2]};
  float nz[3];
  normalize(n, nz);
  const float sc = scale[b];

  // filterImagesNCC: keep mask, stable compaction (order o1)
  int o1[kMaxSlots], v1[kMaxSlots];
  const bool ref_ok = valid[b * K];
  int n1 = 0;
  for (int k = 0; k < K; ++k) {
    bool keep = v[k] >= 0;
    if (k > 0) {
      const float incc =
          (valid[b * K + k] && ref_ok) ? 1.0f - nccs[b * K + k] : 2.0f;
      keep = keep && incc < keep_thr;
    }
    if (keep) o1[n1++] = k;
  }
  for (int k = 0, m = n1; k < K; ++k) {
    bool kept = false;
    for (int i = 0; i < n1; ++i) kept |= o1[i] == k;
    if (!kept) o1[m++] = k;
  }
  for (int i = 0; i < K; ++i) v1[i] = i < n1 ? v[o1[i]] : -1;
  const bool ok1 = n1 >= min_images;

  // sortImages: reference level, rays, weighted scales, greedy suppression
  float fz0, r0[3];
  ray_to(cam_center, max(v1[0], 0), c, r0, fz0);   // fz0 only
  const int ref_level = f2i(clamp_nan(
      rintf(log2f((sc * fsum[max(v1[0], 0)]) / (2.0f * fz0))), 0.0f,
      static_cast<float>(maxlevel - 1)));
  const float lscale = exp2f(static_cast<float>(ref_level));
  float rays[kMaxSlots][3], wsc[kMaxSlots];
  int o2[kMaxSlots];
  int ncand = 0;
  for (int k = 0; k < K; ++k) {
    const int ci = max(v1[k], 0);
    float fz;
    ray_to(cam_center, ci, c, rays[k], fz);
    const float cosa = dot3(rays[k], nz);
    const float ft = fsum[ci];
    const float gs = ft == 0.0f ? 1.0f : ((2.0f * fz) * lscale) / ft;
    wsc[k] = gs / (cosa > 0.0f ? cosa : 1.0f);
    if (v1[k] >= 0 && cosa > 0.0f) o2[ncand++] = k;
  }
  for (int k = 0, m = ncand; k < K; ++k) {
    bool is_cand = false;
    for (int i = 0; i < ncand; ++i) is_cand |= o2[i] == k;
    if (!is_cand) o2[m++] = k;
  }
  float w[kMaxSlots];
  for (int i = 0; i < K; ++i)
    w[i] = (i < ncand && v1[o2[i]] >= 0) ? (i == 0 ? 0.0f : wsc[o2[i]])
                                         : kBig;
  const float thr_half = thr * 0.5f;
  int* ov = out_views + b * K;
  int* ord = order + b * K;
  int picked[kMaxSlots];   // the slot of v1 behind each output slot
  int nout = 0;
  for (int i = 0; i < K; ++i) {
    const int pick = argmin_nan(w, K);
    const float wp = w[pick];
    const int pv = pick < ncand ? v1[o2[pick]] : -1;
    ov[i] = wp < kBig ? pv : -1;
    nout += ov[i] >= 0;
    picked[i] = o2[pick];
    ord[i] = o1[o2[pick]];
    const float* pr = rays[o2[pick]];
    for (int k = 0; k < K; ++k) {
      const float s = 1.0f - dot3(pr, rays[o2[k]]);
      const float lo = (isnan(s) || s > thr_half) ? s : thr_half;
      const float ft = (isnan(lo) || lo < thr) ? lo : thr;
      w[k] = w[k] * (thr / ft);
    }
    w[pick] = kBig;
  }
  const bool ok2 = nout >= min_images && ncand >= 2;

  // assureImageAngles over the sorted views (a valid output slot's ray is
  // that of the v1 slot it came from: the same camera)
  bool good = false;
  for (int k = 0; k < K && !good; ++k) {
    if (ov[k] < 0) continue;
    for (int j = 0; j < K && !good; ++j) {
      if (j == k || ov[j] < 0) continue;
      const float a = acosf(clamp_nan(
          pair_dot(rays[picked[k]], rays[picked[j]]), -1.0f, 1.0f));
      good = a > min_angle && a < max_angle;
    }
  }
  ok[b] = ok1 && ok2 && good;
}

}  // namespace

extern "C" int hpmvs_add_views(const int* views, const float* center,
                               const float* normal, const float* scale,
                               const int* covis, const float* cam_center,
                               const float* fsum, const float* P,
                               const int* width, const int* height, int B,
                               int K, int C, int nlev, float cos_max,
                               int minlevel, int maxlevel, int min_images,
                               int* out_views, bool* ok,
                               cudaStream_t stream) {
  constexpr int kThreads = 32;
  if (B > 0) {
    add_views_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        views, center, normal, scale, covis, cam_center, fsum, P, width,
        height, B, K, C, nlev, cos_max, minlevel, maxlevel, min_images,
        out_views, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hpmvs_sort_views(const int* views, const float* nccs,
                                const bool* valid, const float* center,
                                const float* normal, const float* scale,
                                const float* cam_center, const float* fsum,
                                int B, int K, float keep_thr, float thr,
                                int maxlevel, int min_images, float min_angle,
                                float max_angle, int* out_views, bool* ok,
                                int* order, cudaStream_t stream) {
  constexpr int kThreads = 32;
  if (B > 0) {
    sort_views_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(views, nccs, valid, center, normal, scale,
                                  cam_center, fsum, B, K, keep_thr, thr,
                                  maxlevel, min_images, min_angle, max_angle,
                                  out_views, ok, order);
  }
  return static_cast<int>(cudaGetLastError());
}
