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
// What bounds it on this card: not the bytes (the two levels, <= 2.9 MB with
// a shared camera, sit in the 50 MB L2) and not the floating-point
// operations, but the shared-memory and load traffic of its bilinear samples
// and the instructions around them: four loads and ~20 instructions a sample,
// and the work is per feature, not per pixel (a 60 x 94 level costs what a
// 480 x 752 one does). The earlier design took five samples a window cell
// (the template and its four neighbours for the central differences), each
// straight from global memory, with the window's values in per-lane register
// arrays (147 registers a thread, ~12 warps an SM).
//
// Design: one warp per feature, as before, so the xor-shuffle sums leave the
// same total in every lane and a feature's warp steps and stops as one, with
// no coupling across features. What changed:
// - The previous level's pixels around the point are staged in shared
//   memory once per feature, by cp.async copies (coalesced along its rows,
//   16 or 8 bytes a lane where the rows are so aligned, no registers held
//   while in flight). The patch spans the range of
//   x0 = clip(floor x, 0, W-2) over the window +- 1, plus one column (rows
//   alike); its bounds come from the same float expressions as the samples,
//   which are monotone in the offset, so every clamped sample of the plain
//   version indexes inside the patch and keeps the plain version's x0, fx
//   and four weights. (2h+5)^2 floats bound the patch.
// - The template's samples lie on one grid of w+2 lines a side, and each is
//   taken once: (w+2)^2 - 4 samples a feature (525 for 21 px), not 5 w^2.
//   The lanes hold grid columns and sweep down the rows, keeping three rows
//   in registers; a cell's samples at ys -+ 1 are its column's rows above and
//   below, and those at xs -+ 1 come from the neighbouring lanes by shuffles.
//   That reuse holds where the plain version's xs + 1 equals the neighbouring
//   grid line's coordinate bit for bit; where it does not (the sum crosses a
//   power of two) the sample is taken at the plain version's own coordinate.
//   So T, Ix and Iy are the plain version's samples exactly. They go to
//   shared memory (3 w^2 floats a warp) for the iterations.
// - A lane's x axis (x0, fx) is computed once per column and each row's y
//   axis once, into a shared table, not once per sample: float-int
//   conversions and floor run at a quarter of the FMA rate on this card.
//   No per-lane register arrays or per-window template parameters remain,
//   so any window runs.
// - Each Gauss-Newton iteration samples the current level through the
//   read-only path, lanes over window columns (a lane's x axis computed
//   once). Staging the current level's patch as well, prefetched around
//   pts_cur for the first iteration (about the only one on the main paths),
//   made a level slower on the card in development: the extra shared memory
//   costs more warps an SM than the loads it saves.
// - A window whose patch and template do not fit one block's shared memory
//   (wider than 117 px) runs klt_global_kernel: no shared memory, five
//   samples a cell from global memory, recomputed in each iteration (a
//   second pass over the window). Slow, but no width raises.
// No tensor cores: the work is three dot products a window.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libklt_level.so klt_level.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/klt_cuda.py).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kStaged = 0;   // patch, sample grid and axis tables in shared memory
constexpr int kGlobal = 1;   // no shared memory, every sample from global memory
constexpr int kMaxSmem = 232448;     // shared memory one block may use on an H100
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxWarps = 4;         // features (warps) a block

// Row stride bound of a staged patch: pmax = 2h + 5 columns, widened by up
// to 3 to whole 16-byte groups.
__host__ __device__ inline int patch_stride(int pmax) { return (pmax + 3 + 3) / 4 * 4; }

// Words (4 bytes) of shared memory one warp of kStaged takes for a half-width
// h: the previous level's patch (2h+5 rows of patch_stride), a table of
// g = 2h+3 row axes (two words each), g row flags and T, Ix, Iy over the
// (2h+1)^2 window; rounded up to 4 words, so every warp's patch stays
// 16-byte aligned.
__host__ __device__ inline long long staged_words(int half) {
  const long long p = 2 * half + 5, g = 2 * half + 3, w = 2 * half + 1;
  return (p * patch_stride((int)p) + 3 * g + 3 * w * w + 3) / 4 * 4;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One axis of a bilinear sample at coordinate x on an image of `size`
// pixels, as the plain version: x0 = clip(floor x, 0, size-2) (here as an
// offset from the pixel block's first pixel `lo`), f = clip(x - x0, 0, 1).
struct __align__(8) Axis {
  int o;
  float f;
};

__device__ __forceinline__ Axis axis(float x, int size, int lo) {
  const float x0 = clampf(floorf(x), 0.f, (float)(size - 2));
  return Axis{(int)x0 - lo, clampf(x - x0, 0.f, 1.f)};
}

// The plain version's bilinear sample from the pixel block p (row stride
// `stride`) at row offset yo (already times the stride) and column xo.
template <bool kLdg>
__device__ __forceinline__ float bilerp(const float* p, int stride, int yo, float fy, int xo,
                                        float fx) {
  const float* q = p + yo + xo;
  float i00, i01, i10, i11;
  if (kLdg) {
    i00 = __ldg(q), i01 = __ldg(q + 1), i10 = __ldg(q + stride), i11 = __ldg(q + stride + 1);
  } else {
    i00 = q[0], i01 = q[1], i10 = q[stride], i11 = q[stride + 1];
  }
  return i00 * (1.f - fy) * (1.f - fx) + i01 * (1.f - fy) * fx + i10 * fy * (1.f - fx) +
         i11 * fy * fx;
}

// A sample of a whole level (global memory) at (y, x).
__device__ __forceinline__ float sample_global(const float* img, int H, int W, float y, float x) {
  const Axis ay = axis(y, H, 0), ax = axis(x, W, 0);
  return bilerp<true>(img, W, ay.o * W, ay.f, ax.o, ax.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Coordinate of grid line k in [0, w+2) around p: k = 0 is the window's
// first cell minus one, (p - h) - 1; k = w+1 its last plus one, (p + h) + 1;
// otherwise the cell p + (k - 1 - h). These are the plain version's
// expressions for xs - 1 of the first cell, xs + 1 of the last and xs.
__device__ __forceinline__ float grid_coord(float p, int k, int half) {
  const float fh = (float)half;
  if (k == 0) return (p + (-fh)) - 1.f;
  if (k == 2 * half + 2) return (p + fh) + 1.f;
  return p + (float)(k - 1 - half);
}

// Lane's items q = lane + 32 i of a rows x cols block in row-major order,
// with (row, col) kept by stepping instead of dividing.
struct Walk {
  int q, row, col, step_row, step_col, cols;
  __device__ Walk(int lane, int cols_)
      : q(lane), row(lane / cols_), col(lane % cols_), step_row(32 / cols_),
        step_col(32 % cols_), cols(cols_) {}
  __device__ void next() {
    q += 32;
    row += step_row;
    col += step_col;
    if (col >= cols) col -= cols, ++row;
  }
};

// Start copying the pixels that samples at x in [xa, xb], y in [ya, yb] read
// (the clamped x0 range plus one) into dst, row-major, by cp.async: the
// lanes walk the patch in order (coalesced along its rows, no registers held
// while in flight). Where the level's rows are 16-byte aligned (W a multiple
// of 4), the columns are widened to whole 16-byte groups and copied 16 bytes
// a lane; where they are 8-byte aligned (W even, as the 60 x 94 level), 8;
// otherwise 4. Returns (stride, x_lo, y_lo) of the patch; the caller
// commits, waits and syncs the warp. Float rounding is monotone, so every
// sample of the window, computed as p + o (+- 1) with o in [-h, h], lies in
// [(p - h) - 1, (p + h) + 1] when xa and xb are computed so. Each side spans
// at most floor(xb) - floor(xa) + 2 <= 2h + 5 = pmax pixels (pmax + 3 with
// the widening); the copy is capped there.
__device__ int3 stage(float* dst, const float* img, int H, int W, float xa, float xb, float ya,
                      float yb, int pmax, int lane) {
  int x_lo = (int)clampf(floorf(xa), 0.f, (float)(W - 2));
  const int x_hi = (int)clampf(floorf(xb), 0.f, (float)(W - 2)) + 1;
  const int y_lo = (int)clampf(floorf(ya), 0.f, (float)(H - 2));
  const int y_hi = (int)clampf(floorf(yb), 0.f, (float)(H - 2)) + 1;
  const int ph = min(y_hi - y_lo + 1, pmax);
  const size_t addr = reinterpret_cast<size_t>(img);
  const int vw = W % 4 == 0 && (addr & 15) == 0 ? 4 : W % 2 == 0 && (addr & 7) == 0 ? 2 : 1;
  x_lo &= ~(vw - 1);
  const int pw = min((x_hi - x_lo + vw) / vw * vw, vw == 1 ? pmax : patch_stride(pmax));
  const float* src = img + (size_t)y_lo * W + x_lo;
  const int cols = pw / vw;  // copies a row
  for (Walk it(lane, cols); it.q < cols * ph; it.next()) {
    float* d = dst + it.row * pw + vw * it.col;
    const float* g = src + (size_t)it.row * W + vw * it.col;
    if (vw == 4)
      __pipeline_memcpy_async(d, g, 16);
    else if (vw == 2)
      __pipeline_memcpy_async(d, g, 8);
    else
      __pipeline_memcpy_async(d, g, 4);
  }
  return make_int3(pw, x_lo, y_lo);
}

__device__ __forceinline__ void write_out(long long f, int lane, bool good, float cx, float cy,
                                          float cx0, float cy0, float* out_pts, bool* out_good) {
  if (lane == 0) {
    out_pts[2 * f] = good ? cx : cx0;
    out_pts[2 * f + 1] = good ? cy : cy0;
    out_good[f] = good;
  }
}

// good and det G from the three window sums (cv semantics: min eigenvalue
// of G / n against the threshold; det G guarded at 1e-12).
__device__ __forceinline__ bool gate(float sxx, float sxy, float syy, int n, float min_eig_thr,
                                     float& det_g) {
  const float wn = (float)n;
  const float tr = (sxx + syy) / wn;
  const float det = (sxx * syy - sxy * sxy) / (wn * wn);
  const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  det_g = sxx * syy - sxy * sxy;
  det_g = fabsf(det_g) > 1e-12f ? det_g : 1e-12f;
  return min_eig > min_eig_thr;
}

// One Gauss-Newton step from the two sums: solve G d = -b, move, and say
// whether the step was shorter than eps.
__device__ __forceinline__ bool gn_step(float sxx, float sxy, float syy, float det_g, float bx,
                                        float by, float eps, float& cx, float& cy) {
  const float dx = -(syy * bx - sxy * by) / det_g;
  const float dy = -(-sxy * bx + sxx * by) / det_g;
  cx += dx;
  cy += dy;
  return sqrtf(dx * dx + dy * dy) < eps;
}

__global__ void klt_staged_kernel(const float* __restrict__ img_prev,
                                  const float* __restrict__ img_cur, int Bi, int H, int W,
                                  const float* __restrict__ pts_prev,
                                  const float* __restrict__ pts_cur,
                                  const bool* __restrict__ valid, float* __restrict__ out_pts,
                                  bool* __restrict__ out_good, int B, int F, int half,
                                  int max_iters, float eps, float min_eig_thr) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long f = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= (long long)B * F) return;  // the whole warp leaves together
  // Both points are loaded before the valid test, so their latencies overlap.
  const float cx0 = pts_cur[2 * f], cy0 = pts_cur[2 * f + 1];
  const float px = pts_prev[2 * f], py = pts_prev[2 * f + 1];
  if (!valid[f]) return write_out(f, lane, false, cx0, cy0, cx0, cy0, out_pts, out_good);
  const size_t base = Bi == 1 ? 0 : (size_t)(f / F) * H * W;
  const float* ip = img_prev + base;
  const float* ic = img_cur + base;
  const int w = 2 * half + 1, g = w + 2, n = w * w, pmax = 2 * half + 5;
  const float fh = (float)half;

  // This warp's shared memory: the previous level's patch, row axes (their
  // offsets premultiplied by the row stride), row flags, then T, Ix, Iy.
  float* patch = smem + (size_t)warp * staged_words(half);
  Axis* yt = reinterpret_cast<Axis*>(patch + pmax * patch_stride(pmax));
  int* yflag = reinterpret_cast<int*>(yt + g);
  float* tpl = reinterpret_cast<float*>(yflag + g);
  float* gxs = tpl + n;
  float* gys = gxs + n;

  const int3 pb = stage(patch, ip, H, W, (px + (-fh)) - 1.f, (px + fh) + 1.f,
                        (py + (-fh)) - 1.f, (py + fh) + 1.f, pmax, lane);
  __pipeline_commit();
  const int pw = pb.x, x_lo = pb.y, y_lo = pb.z;
  // While the copies fly: each grid row's axis, and for window row r whether
  // the plain version's ys + 1 and ys - 1 are grid rows r + 2 and r bit for
  // bit (bits 0 and 1; they are except where the sum crosses a power of
  // two). Float-int conversions are quarter-rate on this card, so they are
  // made once here and once a lane below, not once a sample.
  for (int k = lane; k < g; k += 32) {
    const Axis ay = axis(grid_coord(py, k, half), H, y_lo);
    yt[k] = Axis{ay.o * pw, ay.f};
    const float ys = py + (float)(k - half);
    yflag[k] = k < w ? (ys + 1.f == grid_coord(py, k + 2, half)) |
                           (ys - 1.f == grid_coord(py, k, half)) << 1
                     : 0;
  }
  __pipeline_wait_prior(0);
  __syncwarp();

  // The template's samples lie on the grid of lines k = 0 .. w+1 a side
  // (grid_coord). One sweep down the grid rows per chunk of 30 window
  // columns: lane l holds grid column k0 + l and samples it row by row, once
  // a sample ((w+2)^2 - 4 distinct samples a window, not 5 w^2). Cell (r, c)
  // of the window, c = k0 + l - 1, takes T from its own column's row r+1,
  // the samples at ys -+ 1 from rows r and r+2, and those at xs -+ 1 from
  // the neighbouring lanes. Those reuses hold where the flags say the plain
  // version's coordinate is the grid line's; elsewhere the sample is taken at
  // the plain version's own coordinate. So T, Ix and Iy are the plain
  // version's samples exactly.
  auto sample_prev = [&](float y, float x) {
    const Axis ay = axis(y, H, y_lo), ax = axis(x, W, x_lo);
    return bilerp<false>(patch, pw, ay.o * pw, ay.f, ax.o, ax.f);
  };
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
  for (int k0 = 0; k0 < w; k0 += 30) {
    const int kx = min(k0 + lane, g - 1), c = k0 + lane - 1;
    const bool cell_lane = lane >= 1 && lane <= 30 && c < w;
    const Axis ax = axis(grid_coord(px, kx, half), W, x_lo);
    const float xs = px + (float)(c - half);
    const bool x_ok = !cell_lane || (xs + 1.f == grid_coord(px, kx + 1, half) &&
                                     xs - 1.f == grid_coord(px, kx - 1, half));
    auto row = [&](int ky) {
      const Axis ay = yt[ky];
      return bilerp<false>(patch, pw, ay.o, ay.f, ax.o, ax.f);
    };
    float up = row(0), mid = row(1);
#pragma unroll 4
    for (int r = 0; r < w; ++r) {
      const float down = row(r + 2);
      float left = __shfl_up_sync(0xffffffffu, mid, 1);
      float right = __shfl_down_sync(0xffffffffu, mid, 1);
      if (cell_lane) {
        const int yf = yflag[r];
        float dn = down, u = up;
        if (!x_ok || yf != 3) {
          const float ys = py + (float)(r - half);
          if (!x_ok) {
            right = sample_prev(ys, xs + 1.f);
            left = sample_prev(ys, xs - 1.f);
          }
          if (!(yf & 1)) dn = sample_prev(ys + 1.f, xs);
          if (!(yf & 2)) u = sample_prev(ys - 1.f, xs);
        }
        const float ix = 0.5f * (right - left);
        const float iy = 0.5f * (dn - u);
        tpl[r * w + c] = mid;
        gxs[r * w + c] = ix;
        gys[r * w + c] = iy;
        sxx += ix * ix;
        sxy += ix * iy;
        syy += iy * iy;
      }
      up = mid;
      mid = down;
    }
  }
  sxx = warp_sum(sxx);
  sxy = warp_sum(sxy);
  syy = warp_sum(syy);
  float det_g;
  const bool good = gate(sxx, sxy, syy, n, min_eig_thr, det_g);

  float cx = cx0, cy = cy0;
  if (good) {
    for (int it_ = 0; it_ < max_iters; ++it_) {
      // Lanes over window columns: a lane's x axis is fixed down its column,
      // the rows' axes go to the table; the current level is read through
      // the read-only path.
      __syncwarp();  // T, Ix, Iy were written, and the table last read, by other lanes
      for (int k = lane; k < w; k += 32) {
        const Axis ay = axis(cy + (float)(k - half), H, 0);
        yt[k] = Axis{ay.o * W, ay.f};
      }
      __syncwarp();
      float bx = 0.f, by = 0.f;
      for (int c0 = 0; c0 < w; c0 += 32) {
        const int c = c0 + lane;
        const Axis ax = axis(cx + (float)(min(c, w - 1) - half), W, 0);
        if (c >= w) break;
#pragma unroll 8
        for (int r = 0; r < w; ++r) {
          const Axis ay = yt[r];
          const float d = bilerp<true>(ic, W, ay.o, ay.f, ax.o, ax.f) - tpl[r * w + c];
          bx += d * gxs[r * w + c];
          by += d * gys[r * w + c];
        }
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      if (gn_step(sxx, sxy, syy, det_g, bx, by, eps, cx, cy)) break;
    }
  }
  write_out(f, lane, good, cx, cy, cx0, cy0, out_pts, out_good);
}

// Any window, no shared memory: each cell's template and central
// differences are sampled from the level (five samples), once for the sums
// and again in every iteration.
__global__ void klt_global_kernel(const float* __restrict__ img_prev,
                                  const float* __restrict__ img_cur, int Bi, int H, int W,
                                  const float* __restrict__ pts_prev,
                                  const float* __restrict__ pts_cur,
                                  const bool* __restrict__ valid, float* __restrict__ out_pts,
                                  bool* __restrict__ out_good, int B, int F, int half,
                                  int max_iters, float eps, float min_eig_thr) {
  const int lane = threadIdx.x & 31;
  const long long f = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (f >= (long long)B * F) return;
  const float cx0 = pts_cur[2 * f], cy0 = pts_cur[2 * f + 1];
  if (!valid[f]) return write_out(f, lane, false, cx0, cy0, cx0, cy0, out_pts, out_good);
  const size_t base = Bi == 1 ? 0 : (size_t)(f / F) * H * W;
  const float* ip = img_prev + base;
  const float* ic = img_cur + base;
  const float px = pts_prev[2 * f], py = pts_prev[2 * f + 1];
  const int w = 2 * half + 1, n = w * w;
  auto cell = [&](int r, int c, float& t, float& ix, float& iy) {
    const float ys = py + (float)(r - half), xs = px + (float)(c - half);
    t = sample_global(ip, H, W, ys, xs);
    ix = 0.5f * (sample_global(ip, H, W, ys, xs + 1.f) - sample_global(ip, H, W, ys, xs - 1.f));
    iy = 0.5f * (sample_global(ip, H, W, ys + 1.f, xs) - sample_global(ip, H, W, ys - 1.f, xs));
  };
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
  for (Walk it(lane, w); it.q < n; it.next()) {
    float t, ix, iy;
    cell(it.row, it.col, t, ix, iy);
    sxx += ix * ix;
    sxy += ix * iy;
    syy += iy * iy;
  }
  sxx = warp_sum(sxx);
  sxy = warp_sum(sxy);
  syy = warp_sum(syy);
  float det_g;
  const bool good = gate(sxx, sxy, syy, n, min_eig_thr, det_g);
  float cx = cx0, cy = cy0;
  if (good) {
    for (int it_ = 0; it_ < max_iters; ++it_) {
      float bx = 0.f, by = 0.f;
      for (Walk it(lane, w); it.q < n; it.next()) {
        float t, ix, iy;
        cell(it.row, it.col, t, ix, iy);
        const float d = sample_global(ic, H, W, cy + (float)(it.row - half),
                                      cx + (float)(it.col - half)) - t;
        bx += d * ix;
        by += d * iy;
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      if (gn_step(sxx, sxy, syy, det_g, bx, by, eps, cx, cy)) break;
    }
  }
  write_out(f, lane, good, cx, cy, cx0, cy0, out_pts, out_good);
}

// How a half-width runs: kStaged with as many warps a block (up to
// kMaxWarps) as fit kMaxSmem, its shared memory staged_words a warp; kGlobal
// where not even one warp fits (windows wider than 117 px). No width raises.
struct Plan {
  int variant, warps, smem;
};

Plan plan_for(int half) {
  const long long per_warp = staged_words(half) * (long long)sizeof(float);
  const int warps = (int)(kMaxSmem / per_warp < kMaxWarps ? kMaxSmem / per_warp : kMaxWarps);
  if (warps == 0) return {kGlobal, kMaxWarps, 0};
  return {kStaged, warps, (int)(warps * per_warp)};
}

}  // namespace

extern "C" {

// The variant the launcher runs for a half-width (kStaged 0, kGlobal 1);
// *warps gets the features a block and *smem_bytes its dynamic shared memory.
int klt_level_plan(int half, int* warps, int* smem_bytes) {
  const Plan p = plan_for(half);
  *warps = p.warps;
  *smem_bytes = p.smem;
  return p.variant;
}

// img_prev, img_cur: (Bi, H, W) f32 with Bi == 1 (shared) or Bi == B;
// pts_prev, pts_cur, out_pts: (B, F, 2) f32; valid, out_good: (B, F) bool;
// all contiguous on the device. Launches the variant plan_for picks on
// `stream` and returns cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for bad sizes, or the error of raising the shared-memory limit.
int klt_level_launch(const float* img_prev, const float* img_cur, int Bi, int H, int W,
                     const float* pts_prev, const float* pts_cur, const bool* valid,
                     float* out_pts, bool* out_good, int B, int F, int half, int max_iters,
                     float eps, float min_eig_thr, void* stream) {
  if (B <= 0 || F <= 0 || half < 0 || H < 2 || W < 2 || (Bi != 1 && Bi != B))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(half);
  const long long features = (long long)B * F;
  const unsigned blocks = (unsigned)((features + p.warps - 1) / p.warps);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.variant == kStaged) {
    static int raised = kDefaultSmem;  // the kernel's shared-memory limit so far
    if (p.smem > raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          klt_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (e != cudaSuccess) {
        cudaGetLastError();  // clear it, so that the next launch does not report it
        return (int)e;
      }
      raised = p.smem;
    }
    klt_staged_kernel<<<blocks, p.warps * 32, p.smem, s>>>(
        img_prev, img_cur, Bi, H, W, pts_prev, pts_cur, valid, out_pts, out_good, B, F, half,
        max_iters, eps, min_eig_thr);
  } else {
    klt_global_kernel<<<blocks, p.warps * 32, 0, s>>>(
        img_prev, img_cur, Bi, H, W, pts_prev, pts_cur, valid, out_pts, out_good, B, F, half,
        max_iters, eps, min_eig_thr);
  }
  return (int)cudaGetLastError();
}

const char* klt_level_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
