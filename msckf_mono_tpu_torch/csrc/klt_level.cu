// One Lucas-Kanade pyramid level on Hopper, for a batch of (B, F) features.
//
// Replaces the TPU kernel msckf_mono_tpu/ops/klt_pallas.py::_klt_level_kernel
// (wrapper track_level, called level by level by frontend/klt.py
// track_features_pyr). It computes ops/klt_cuda.track_level_plain, the port of
// the JAX package's frontend/klt._track_level, which the TPU kernel names as
// its contract:
//   template T and central-difference gradients Ix, Iy of the previous level
//   on the (2h+1)^2 window around pts_prev, each a bilinear sample clamped
//   per sample (x0 = clip(floor x, 0, W-2), fx = clip(x - x0, 0, 1));
//   G = [[sum Ix^2, sum Ix Iy], [sum Ix Iy, sum Iy^2]]; good = valid and
//   min eigenvalue of G / n > min_eig_thr (n = window cells); then from
//   pts_cur up to max_iters Gauss-Newton steps d = -G^{-1} sum((I - T) grad),
//   each applied, and the loop left once |d| < eps; det G guarded at 1e-12;
//   out = good ? point : pts_cur.
// The TPU kernel's edge-replicated padding and clamped slice bases are not
// carried over: with the per-sample clamp, kernel and plain version agree on
// border features too. They sum the window in different orders (and the
// kernel contracts to FMAs), so positions agree to float32 rounding, except
// where the eps stop test fires one iteration apart.
//
// What bounds it: operations. A bilinear sample is ~20 flops (clamps, four
// loads, three lerps); a valid feature takes 5 n samples for its template and
// gradients and n a live iteration. At the main path's level 0 (B = 256,
// F = 64, 21 x 21 window) that is ~0.7 GFLOP before any iteration and ~0.14
// GFLOP for every iteration all features stay live: tens of microseconds at
// 67 TFLOP/s. The bytes are the two levels, <= 2.9 MB in shared mode, read
// from the 50 MB L2 after the first touch.
//
// Design: one warp per feature, kWarps features a block, over all B * F
// features. The window's n cells are spread over the lanes (K = ceil(n / 32)
// a lane: 14 for a 21 x 21 window); each lane keeps its cells' offsets,
// template and gradients in registers (K is a template parameter, so the
// arrays stay in registers). Every Gauss-Newton iteration samples the current
// level straight from global memory (read-only path) and reduces the two
// sums with xor shuffles, which leave the identical total in every lane: the
// whole warp takes the same step and leaves its loop together, with no
// divergence inside the warp and no coupling across features (the TPU's
// packs of 4 features that wait for the slowest have no reason here). A
// shared image (Bi == 1) is read by every filter's features.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libklt_level.so klt_level.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/klt_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float bilinear(const float* __restrict__ img, int H, int W,
                                          float y, float x) {
  const float x0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float y0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  const float fx = fminf(fmaxf(x - x0, 0.f), 1.f);
  const float fy = fminf(fmaxf(y - y0, 0.f), 1.f);
  const float* p = img + (size_t)(int)y0 * W + (int)x0;
  const float i00 = __ldg(p), i01 = __ldg(p + 1), i10 = __ldg(p + W), i11 = __ldg(p + W + 1);
  return i00 * (1.f - fy) * (1.f - fx) + i01 * (1.f - fy) * fx + i10 * fy * (1.f - fx) +
         i11 * fy * fx;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
klt_level_kernel(const float* __restrict__ img_prev, const float* __restrict__ img_cur,
                 int Bi, int H, int W, const float* __restrict__ pts_prev,
                 const float* __restrict__ pts_cur, const bool* __restrict__ valid,
                 float* __restrict__ out_pts, bool* __restrict__ out_good, int B, int F,
                 int half, int max_iters, float eps, float min_eig_thr) {
  const int lane = threadIdx.x & 31;
  const long long f = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= (long long)B * F) return;  // the whole warp leaves together
  const float cx0 = pts_cur[2 * f], cy0 = pts_cur[2 * f + 1];
  if (!valid[f]) {
    if (lane == 0) {
      out_pts[2 * f] = cx0;
      out_pts[2 * f + 1] = cy0;
      out_good[f] = false;
    }
    return;
  }
  const size_t plane = (size_t)H * W;
  const size_t base = Bi == 1 ? 0 : (size_t)(f / F) * plane;
  const float* ip = img_prev + base;
  const float* ic = img_cur + base;
  const float px = pts_prev[2 * f], py = pts_prev[2 * f + 1];
  const int w = 2 * half + 1, n = w * w;

  float ox[K], oy[K], tpl[K], gx[K], gy[K];
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    ox[k] = oy[k] = tpl[k] = gx[k] = gy[k] = 0.f;
    if (c < n) {
      oy[k] = (float)(c / w - half);
      ox[k] = (float)(c % w - half);
      const float ys = py + oy[k], xs = px + ox[k];
      tpl[k] = bilinear(ip, H, W, ys, xs);
      gx[k] = 0.5f * (bilinear(ip, H, W, ys, xs + 1.f) - bilinear(ip, H, W, ys, xs - 1.f));
      gy[k] = 0.5f * (bilinear(ip, H, W, ys + 1.f, xs) - bilinear(ip, H, W, ys - 1.f, xs));
      sxx += gx[k] * gx[k];
      sxy += gx[k] * gy[k];
      syy += gy[k] * gy[k];
    }
  }
  sxx = warp_sum(sxx);
  sxy = warp_sum(sxy);
  syy = warp_sum(syy);

  // min eigenvalue of G / n (cv semantics)
  const float wn = (float)n;
  const float tr = (sxx + syy) / wn;
  const float det = (sxx * syy - sxy * sxy) / (wn * wn);
  const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  const bool good = min_eig > min_eig_thr;
  float det_g = sxx * syy - sxy * sxy;
  det_g = fabsf(det_g) > 1e-12f ? det_g : 1e-12f;

  float cx = cx0, cy = cy0;
  if (good) {
    for (int it = 0; it < max_iters; ++it) {
      float bx = 0.f, by = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane + 32 * k < n) {
          const float d = bilinear(ic, H, W, cy + oy[k], cx + ox[k]) - tpl[k];
          bx += d * gx[k];
          by += d * gy[k];
        }
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      // solve G d = -b
      const float dx = -(syy * bx - sxy * by) / det_g;
      const float dy = -(-sxy * bx + sxx * by) / det_g;
      cx += dx;
      cy += dy;
      if (sqrtf(dx * dx + dy * dy) < eps) break;
    }
  }
  if (lane == 0) {
    out_pts[2 * f] = good ? cx : cx0;
    out_pts[2 * f + 1] = good ? cy : cy0;
    out_good[f] = good;
  }
}

template <int K>
int launch(const float* img_prev, const float* img_cur, int Bi, int H, int W,
           const float* pts_prev, const float* pts_cur, const bool* valid, float* out_pts,
           bool* out_good, int B, int F, int half, int max_iters, float eps, float min_eig_thr,
           cudaStream_t stream) {
  const long long features = (long long)B * F;
  const unsigned blocks = (unsigned)((features + kWarps - 1) / kWarps);
  klt_level_kernel<K><<<blocks, kWarps * 32, 0, stream>>>(
      img_prev, img_cur, Bi, H, W, pts_prev, pts_cur, valid, out_pts, out_good, B, F, half,
      max_iters, eps, min_eig_thr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img_prev, img_cur: (Bi, H, W) f32 with Bi == 1 (shared) or Bi == B;
// pts_prev, pts_cur, out_pts: (B, F, 2) f32; valid, out_good: (B, F) bool;
// all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); a window of more than 64 * 32 cells
// (wider than 45 px) returns cudaErrorInvalidValue.
int klt_level_launch(const float* img_prev, const float* img_cur, int Bi, int H, int W,
                     const float* pts_prev, const float* pts_cur, const bool* valid,
                     float* out_pts, bool* out_good, int B, int F, int half, int max_iters,
                     float eps, float min_eig_thr, void* stream) {
  if (B <= 0 || F <= 0 || half < 0 || H < 2 || W < 2 || (Bi != 1 && Bi != B))
    return (int)cudaErrorInvalidValue;
  const int n = (2 * half + 1) * (2 * half + 1);
  const int per_lane = (n + 31) / 32;
  const cudaStream_t s = (cudaStream_t)stream;
#define KLT_LAUNCH(K)                                                                     \
  if (per_lane <= K)                                                                      \
    return launch<K>(img_prev, img_cur, Bi, H, W, pts_prev, pts_cur, valid, out_pts,      \
                     out_good, B, F, half, max_iters, eps, min_eig_thr, s);
  KLT_LAUNCH(4)
  KLT_LAUNCH(8)
  KLT_LAUNCH(16)
  KLT_LAUNCH(32)
  KLT_LAUNCH(64)
#undef KLT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* klt_level_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
