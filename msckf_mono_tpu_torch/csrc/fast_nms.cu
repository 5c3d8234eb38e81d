// FAST-10 corner score + 3x3 non-max suppression on Hopper.
//
// Replaces the TPU kernel msckf_mono_tpu/ops/fast_pallas.py::_fast_nms_kernel
// (wrapper fast_nms_score, called by frontend/detect.py detect_features). It
// computes ops/fast_cuda.nonmax_3x3(fast_score_10(img)) composed:
//   d_j   = img[y + dy_j, x + dx_j] - img[y, x] on the 16-pixel circle;
//   score = max(max_k min_{j in arc k} d_j, max_k min_{j in arc k} -d_j)
//           over the 16 circular arcs of length 10;
//   s     = score where score > threshold and the pixel is >= 3 px from every
//           edge, else -inf;
//   out   = s where s > -inf and s >= s of each of its 8 neighbours (-inf
//           outside the image), else 0.
// Only subtractions, negations and min/max, in the plain version's order, so
// the kernel equals its plain PyTorch version (ops/fast_cuda.py) bit for bit.
//
// What bounds it: operations, narrowly. One read and one write of each image
// is 2*H*W*4 bytes: 2.9 MB, 0.86 us at 3.35 TB/s for one 480 x 752 image.
// Its arithmetic is 202 sub/neg/min/max operations a pixel (16 differences
// and their negations; per polarity 48 + 16 mins for the arc minima by
// doubling and 15 maxes; the threshold test; 8 maxes and 2 tests of the NMS):
// 73 MOP a frame, 1.09 us at 67 TOP/s.
//
// Design: one thread per output pixel of a 32 x 16 tile. The block stages
// its tile plus a 4 px halo (3 px circle + 1 px NMS ring) in shared memory
// with row-contiguous loads, once; computes the masked score of the tile and
// its 1 px ring into shared memory (border and threshold masks in global
// coordinates); and after __syncthreads() runs the 3x3 NMS out of shared
// memory. Ragged edges are masked, so H and W need not be multiples of the
// tile. The TPU kernel's row slabs and lane rolls are not carried over.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfast_nms.so fast_nms.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/fast_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;                      // 3 px circle + 1 px NMS ring
constexpr int kPixW = kTileW + 2 * kHalo;     // 40
constexpr int kPixH = kTileH + 2 * kHalo;     // 24
constexpr int kScoreW = kTileW + 2;           // tile + 1 px ring
constexpr int kScoreH = kTileH + 2;
constexpr int kThreads = kTileW * kTileH;

// The best length-10 arc: max over k of min(d[k], ..., d[k+9]) (indices mod
// 16), with the arc minima by doubling: min of 2, 4, 8, then 8 + 2.
__device__ __forceinline__ float best_arc(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) m2[j] = fminf(d[j], d[(j + 1) & 15]);
#pragma unroll
  for (int j = 0; j < 16; ++j) m4[j] = fminf(m2[j], m2[(j + 2) & 15]);
#pragma unroll
  for (int j = 0; j < 16; ++j) m8[j] = fminf(m4[j], m4[(j + 4) & 15]);
  float best = fminf(m8[0], m2[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fmaxf(best, fminf(m8[k], m2[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                float threshold) {
  // (dx, dy) of the Bresenham circle in circular order (fast_cuda.FAST_OFFSETS).
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  __shared__ float pix[kPixH][kPixW];
  __shared__ float score[kScoreH][kScoreW];

  const size_t plane = (size_t)H * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  // Tile + halo; pixels outside the image are never read by a kept score.
  for (int i = tid; i < kPixH * kPixW; i += kThreads) {
    const int sy = i / kPixW, sx = i % kPixW;
    const int gy = y0 - kHalo + sy, gx = x0 - kHalo + sx;
    pix[sy][sx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? __ldg(im + (size_t)gy * W + gx) : 0.f;
  }
  __syncthreads();

  // Masked score of the tile and its 1 px ring.
  for (int i = tid; i < kScoreH * kScoreW; i += kThreads) {
    const int ry = i / kScoreW, rx = i % kScoreW;
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    float s = -INFINITY;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int cy = ry + kHalo - 1, cx = rx + kHalo - 1;
      const float c = pix[cy][cx];
      float bright[16], dark[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        bright[j] = pix[cy + kDy[j]][cx + kDx[j]] - c;
        dark[j] = -bright[j];
      }
      const float sc = fmaxf(best_arc(bright), best_arc(dark));
      if (sc > threshold) s = sc;
    }
    score[ry][rx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const int ry = threadIdx.y + 1, rx = threadIdx.x + 1;
  const float m = score[ry][rx];
  float nb = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx != 0 || dy != 0) nb = fmaxf(nb, score[ry + dy][rx + dx]);
    }
  }
  out[blockIdx.z * plane + (size_t)gy * W + gx] = (m > -INFINITY && m >= nb) ? m : 0.f;
}

}  // namespace

extern "C" {

// img, out: (Bi, H, W) contiguous f32 on the device. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int fast_nms_launch(const float* img, float* out, int Bi, int H, int W, float threshold,
                    void* stream) {
  if (Bi <= 0 || H <= 0 || W <= 0 || Bi > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, Bi);
  const dim3 block(kTileW, kTileH);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}

const char* fast_nms_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
