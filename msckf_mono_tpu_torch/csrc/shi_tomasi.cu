// Shi-Tomasi min-eigenvalue score, FAST/NMS gate and per-cell best on Hopper.
//
// Replaces no TPU kernel: the JAX package computes the score as plain JAX
// (msckf_mono_tpu/frontend/detect.py, shi_tomasi_score: the central
// differences and the box sums as banded matrix products, which is how a
// stencil reaches the TPU's matrix unit), and so did the port. Added because
// those products are the largest item of the per-stream image step: per
// 480 x 752 image img @ Gx^T, Gy @ img, then Bv @ Z @ Bh^T on the three
// products Z, 1.78 G multiply-adds, 228 GFLOP a step at 64 images, ~4.4 ms of
// f32 GEMMs, plus ~3 GB of elementwise, pad and permute traffic around them.
//
// It computes ops/shi_tomasi_cuda.shi_tomasi_cells_plain: for image b and
// grid cell c (grid_h = H / n_rows + 1 rows by grid_w = W / n_cols + 1
// columns, row-major, the last row and column of cells padded past the
// image),
//   v(y, x) = st(y, x) where nms(y, x) > 0, else -1; -1 on the padding;
//   st      = 0 where the box touches the 1 px border (outside the interior
//             y - half >= 1, y + half < H - 1, and the same in x), else
//             0.5 (tr - sqrt(max(tr^2 - 4 det, 0))) of the box sums of
//             dx^2, dy^2, dx dy over [y - half, y + half) x [x - half,
//             x + half), each divided by 2 (2 half)^2, with
//             dx = I(y, x + 1) - I(y, x - 1), dy = I(y + 1, x) - I(y - 1, x);
//   best[b, c]  = max of v over the cell,
//   local[b, c] = its row-major index in the cell, the smallest on ties.
// The arithmetic is full precision, as the configuration's "highest" tier
// states: dx and dy are float32 differences (as the plain version's), their
// products and every sum are float64, the eigenvalue is taken in float64
// and rounded once to float32. No TF32, no half precision.
//
// What bounds it: bytes. Each pixel and its FAST/NMS value are read once
// and a cell writes 12 bytes: 8 H W bytes an image, 2.9 MB at 480 x 752,
// 0.86 us at 3.35 TB/s (55 us for 64 images). Running sums take ~30
// operations a pixel (0.7 GFLOP at 64 images), far below the bytes.
//
// Design: one block of 128 threads per (cell, image), Bi x C blocks a launch.
// 1. Every pixel of the cell is read from the FAST/NMS map once, 16 loads a
//    thread in flight. A pixel whose value needs no sum (not marked: -1;
//    padding: -1; marked outside the interior: 0) is a candidate right
//    there; the marked interior pixels' bounding box is reduced in shared
//    memory. Only that box needs box sums (on a rendered frame ~40% of the
//    cells have no corner at all), and every pixel of it is interior, so its
//    30 x 30 windows and their differences never leave the image: no border
//    case.
// 2. The box is cut into sub-tiles of at most th x tw pixels (the launcher's
//    plan: 19 rows of a 76 px wide cell at 480 x 752, so a middle cell's 49
//    rows in three). Each sub-tile stages its pixels with a half + 1 px halo
//    (th + 31 by tw + 31 floats at half = 15) and its map in shared memory
//    by cp.async. One thread a column of products walks down it with
//    running float64 sums (add the row entering the window, subtract the one
//    leaving it, products taken anew from the staged pixels), writing the
//    30-row sums of the three products as float64 rows (3 th (tw + 29)
//    doubles). Then threads walk along the rows (a row, or a part of one, a
//    thread) with running float64 sums of 30 columns, and take the
//    eigenvalue only at marked pixels, of the sums, divided by 2 (2 half)^2
//    once. Never 900 terms a pixel.
// 3. (value, index) pairs are reduced lexicographically (larger value, then
//    smaller index) in registers, by warp shuffles, then across the 4 warps.
// At 74 KB of shared memory a block at most, three blocks share an SM (the
// fastest of 2, 3 and 4 a SM and 128, 192 and 256 threads a block on 64
// rendered frames: 0.173 ms, 3.1 times the bytes' bound). No
// device state, no atomics outside the block, no memset: one launch,
// capturable in a CUDA graph, and deterministic. Images are assumed finite.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libshi_tomasi.so shi_tomasi.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/shi_tomasi_cuda.py).

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxSmem = 74 * 1024;   // dynamic shared memory a block, at most
constexpr int kDefaultSmem = 48 * 1024;     // what a launch may use without opting in
constexpr int kMinChunk = 16;               // outputs a thread walks along a row, at least
constexpr int kBatch = 16;                  // map values a thread has in flight in pass 1

// Dynamic shared memory of a th x tw sub-tile: the 30-row sums (three
// float64 planes of th x (tw + 2 half - 1)), the pixels with their halo
// ((th + 2 half + 1) x (tw + 2 half + 1) floats) and the FAST/NMS map
// (th x tw floats).
long long tile_bytes(long long th, long long tw, long long half) {
  const long long zc = tw + 2 * half - 1, ip = tw + 2 * half + 1;
  return 3 * th * zc * 8 + (th + 2 * half + 1) * ip * 4 + th * tw * 4;
}

struct Plan {
  int th, tw, smem;  // the largest sub-tile and its bytes; all 0 when no pixel is interior
  bool ok;
};

// The sub-tile: the whole width of a cell and as many rows as fit kMaxSmem,
// or, where not even one row of the cell fits, as many columns of one row as
// fit. Only the interior (H - 2 half - 2 rows by W - 2 half - 2 columns)
// ever needs sums, so a sub-tile never exceeds it. Too wide a box for one
// pixel with its halo (half above ~80) is refused.
Plan plan_for(int H, int W, int half, int n_rows, int n_cols) {
  const long long gh = H / n_rows + 1, gw = W / n_cols + 1;
  const long long ih = (long long)H - 2LL * half - 2, iw = (long long)W - 2LL * half - 2;
  if (ih <= 0 || iw <= 0) return {0, 0, 0, true};
  long long tw = gw < iw ? gw : iw;
  const long long rows = gh < ih ? gh : ih;
  long long th = rows;
  while (th > 0 && tile_bytes(th, tw, half) > kMaxSmem) --th;
  if (th == 0) {
    th = 1;
    while (tw > 0 && tile_bytes(1, tw, half) > kMaxSmem) --tw;
    if (tw == 0) return {0, 0, 0, false};
  }
  return {(int)th, (int)tw, (int)tile_bytes(th, tw, half), true};
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The three products at staged pixel p (its row pitch ip), added (sign +1)
// or subtracted (-1) from the running sums.
__device__ __forceinline__ void add_products(const float* p, int ip, double sign, double& sxx,
                                             double& syy, double& sxy) {
  const double dx = (double)(p[1] - p[-1]);
  const double dy = (double)(p[ip] - p[-ip]);
  sxx += sign * (dx * dx);
  syy += sign * (dy * dy);
  sxy += sign * (dx * dy);
}

__global__ void __launch_bounds__(kThreads, 3)
shi_tomasi_cells_kernel(const float* __restrict__ img, const float* __restrict__ nms,
                        float* __restrict__ best, long long* __restrict__ local, int H, int W,
                        int half, int n_cols, int gh, int gw, int th_max, int tw_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int box[4];  // the marked interior pixels' rows and columns (cell-local), min / max
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int cell = blockIdx.x, n_cells = gridDim.x;
  const int y0 = (cell / n_cols) * gh, x0 = (cell % n_cols) * gw;
  const size_t plane = (size_t)H * W;
  const float* im = img + blockIdx.y * plane;
  const float* nm = nms + blockIdx.y * plane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int iy0 = half + 1, iy1 = H - 1 - half, ix0 = half + 1, ix1 = W - 1 - half;

  if (tid == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  __syncthreads();

  // 1. The pixels that need no sum, and the box of those that do. The map
  // is read kBatch values a thread at a time, all in flight at once; a
  // pixel past the image reads 0, unmarked, as the padding's -1 asks.
  float bv = -INFINITY;
  int bi = INT_MAX;
  int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
  // Thread tid takes pixels tid, tid + kThreads, ... of the cell; (r, c)
  // steps by (dr, dc) with a carry, not by a division a pixel.
  const int n = gh * gw, dr = kThreads / gw, dc = kThreads - dr * gw;
  int r0 = tid / gw, c0 = tid - r0 * gw;
  for (int base = tid; base < n; base += kThreads * kBatch) {
    float m[kBatch];
    int r = r0, c = c0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int y = y0 + r, x = x0 + c;
      m[k] = base + k * kThreads < n && y < H && x < W ? __ldg(nm + (size_t)y * W + x) : 0.f;
      r += dr;
      c += dc;
      if (c >= gw) c -= gw, ++r;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      if (i >= n) break;
      const int y = y0 + r0, x = x0 + c0;
      if (m[k] > 0.f && y >= iy0 && y < iy1 && x >= ix0 && x < ix1) {
        ylo = min(ylo, r0);
        yhi = max(yhi, r0);
        xlo = min(xlo, c0);
        xhi = max(xhi, c0);
      } else {
        take(m[k] > 0.f ? 0.f : -1.f, i, bv, bi);
      }
      r0 += dr;
      c0 += dc;
      if (c0 >= gw) c0 -= gw, ++r0;
    }
  }
  ylo = __reduce_min_sync(kFull, ylo);
  yhi = __reduce_max_sync(kFull, yhi);
  xlo = __reduce_min_sync(kFull, xlo);
  xhi = __reduce_max_sync(kFull, xhi);
  if (lane == 0 && yhi >= 0) {
    atomicMin(&box[0], ylo);
    atomicMax(&box[1], yhi);
    atomicMin(&box[2], xlo);
    atomicMax(&box[3], xhi);
  }
  __syncthreads();

  // 2. Box sums and scores over the box, a sub-tile at a time.
  if (box[1] >= 0) {
    const int bh = box[1] - box[0] + 1, bw = box[3] - box[2] + 1;
    const int ny = (bh + th_max - 1) / th_max, nx = (bw + tw_max - 1) / tw_max;
    const int sth = (bh + ny - 1) / ny, stw = (bw + nx - 1) / nx;
    const int span = 2 * half;
    const double denom = 2.0 * (double)span * (double)span;
    for (int sy = 0; sy < ny; ++sy) {
      for (int sx = 0; sx < nx; ++sx) {
        const int ry = box[0] + sy * sth, cx = box[2] + sx * stw;
        const int th = min(sth, box[1] + 1 - ry), tw = min(stw, box[3] + 1 - cx);
        const int gy0 = y0 + ry, gx0 = x0 + cx;
        const int zc = tw + span - 1;            // columns of products
        const int ip = tw + span + 1;            // staged pixel columns
        const int irows = th + span + 1;         // staged pixel rows
        double* vs = reinterpret_cast<double*>(smem);           // [3][th][zc]
        float* pix = reinterpret_cast<float*>(vs + 3 * th * zc);  // [irows][ip]
        float* mark = pix + irows * ip;                           // [th][tw]

        // The sub-tile's pixels from row gy0 - half - 1 and column
        // gx0 - half - 1 on, all inside the image (the box is interior),
        // and its map, by cp.async: every copy in flight at once.
        const float* src = im + (size_t)(gy0 - half - 1) * W + (gx0 - half - 1);
        for (int r = warp; r < irows; r += kWarps)
          for (int c = lane; c < ip; c += 32)
            __pipeline_memcpy_async(pix + r * ip + c, src + (size_t)r * W + c, 4);
        const float* msrc = nm + (size_t)gy0 * W + gx0;
        for (int r = warp; r < th; r += kWarps)
          for (int c = lane; c < tw; c += 32)
            __pipeline_memcpy_async(mark + r * tw + c, msrc + (size_t)r * W + c, 4);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();

        // Products column j (pixel column j + 1), output row r's window is
        // product rows r .. r + span - 1 (pixel rows r + 1 .. r + span).
        const int plane_v = th * zc;
        for (int j = tid; j < zc; j += kThreads) {
          const float* p = pix + ip + j + 1;
          double sxx = 0.0, syy = 0.0, sxy = 0.0;
          for (int i = 0; i < span - 1; ++i) add_products(p + i * ip, ip, 1.0, sxx, syy, sxy);
          for (int r = 0; r < th; ++r) {
            add_products(p + (r + span - 1) * ip, ip, 1.0, sxx, syy, sxy);
            vs[r * zc + j] = sxx;
            vs[plane_v + r * zc + j] = syy;
            vs[2 * plane_v + r * zc + j] = sxy;
            add_products(p + r * ip, ip, -1.0, sxx, syy, sxy);
          }
        }
        __syncthreads();

        // Along the rows: output column x's window is columns x .. x + span - 1.
        const int per_row = max(1, min(kThreads / th, (tw + kMinChunk - 1) / kMinChunk));
        const int len = (tw + per_row - 1) / per_row;
        for (int item = tid; item < th * per_row; item += kThreads) {
          const int r = item / per_row;
          const int xa = (item - r * per_row) * len, xb = min(xa + len, tw);
          const float* mk = mark + r * tw;
          bool any = false;
          for (int x = xa; x < xb; ++x) any |= mk[x] > 0.f;
          if (!any) continue;
          const double* a = vs + r * zc;
          const double* b = a + plane_v;
          const double* c = b + plane_v;
          double sxx = 0.0, syy = 0.0, sxy = 0.0;
          for (int j = xa; j < xa + span - 1; ++j) {
            sxx += a[j];
            syy += b[j];
            sxy += c[j];
          }
          for (int x = xa; x < xb; ++x) {
            const int in = x + span - 1;
            sxx += a[in];
            syy += b[in];
            sxy += c[in];
            if (mk[x] > 0.f) {
              // the eigenvalue of the sums, divided once: lambda(S / d) = lambda(S) / d
              const double tr = sxx + syy, det = sxx * syy - sxy * sxy;
              const double disc = sqrt(fmax(tr * tr - 4.0 * det, 0.0));
              take((float)(0.5 * (tr - disc) / denom), (ry + r) * gw + cx + x, bv, bi);
            }
            sxx -= a[x];
            syy -= b[x];
            sxy -= c[x];
          }
        }
        __syncthreads();  // before the next sub-tile overwrites shared memory
      }
    }
  }

  // 3. The block's best (value, index).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, bv, o);
    const int oi = __shfl_down_sync(kFull, bi, o);
    take(ov, oi, bv, bi);
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) take(red_v[w], red_i[w], bv, bi);
    const size_t out = (size_t)blockIdx.y * n_cells + cell;
    best[out] = bv;
    local[out] = bi;
  }
}

}  // namespace

extern "C" {

// The launcher's plan for (H, W, half, n_rows, n_cols): *th x *tw, the
// largest sub-tile of a cell's box a block stages, and *smem_bytes its
// dynamic shared memory (all 0 where no pixel is interior). Returns 0, or
// cudaErrorInvalidValue where the sizes are refused.
int shi_tomasi_plan(int H, int W, int half, int n_rows, int n_cols, int* th, int* tw,
                    int* smem_bytes) {
  if (H <= 0 || W <= 0 || half <= 0 || n_rows <= 0 || n_cols <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(H, W, half, n_rows, n_cols);
  *th = p.th;
  *tw = p.tw;
  *smem_bytes = p.smem;
  return p.ok ? 0 : (int)cudaErrorInvalidValue;
}

// img, nms: (Bi, H, W) f32; best: (Bi, n_rows * n_cols) f32; local: the same
// shape, int64; all contiguous on the device. Launches on `stream` and
// returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for sizes
// it refuses, or the error of raising the shared-memory limit.
int shi_tomasi_launch(const float* img, const float* nms, float* best, long long* local, int Bi,
                      int H, int W, int half, int n_rows, int n_cols, void* stream) {
  if (Bi <= 0 || Bi > 65535 || H <= 0 || W <= 0 || half <= 0 || n_rows <= 0 || n_cols <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(H, W, half, n_rows, n_cols);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  static int raised = kDefaultSmem;  // the kernel's shared-memory limit so far
  if (p.smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        shi_tomasi_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so that the next launch does not report it
      return (int)e;
    }
    raised = p.smem;
  }
  const dim3 grid((unsigned)(n_rows * n_cols), (unsigned)Bi);
  shi_tomasi_cells_kernel<<<grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      img, nms, best, local, H, W, half, n_cols, H / n_rows + 1, W / n_cols + 1,
      p.th > 0 ? p.th : 1, p.tw > 0 ? p.tw : 1);
  return (int)cudaGetLastError();
}

const char* shi_tomasi_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
