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
// Only subtractions, negations and min/max, so the kernel equals its plain
// PyTorch version (ops/fast_cuda.py) bit for bit: min and max are exact in
// any order, and min_j(-d_j) = -max_j(d_j) exactly (up to the sign of a
// zero, which comparisons and torch.equal do not separate).
//
// What bounds it: bytes, on camera images. One read and one write of each
// image is 2*H*W*4 bytes: 2.9 MB, 0.86 us at 3.35 TB/s for one 480 x 752
// image. The full segment test costs ~176 operations a pixel, but a pixel
// can score above t only if an arc of 10 circle pixels all differ from it by
// more than t in one direction, and any 10 contiguous circle positions hold
// two neighbouring compass points of d_0, d_4, d_8, d_12. So the exact
// pre-test "some neighbouring compass pair has both d > t, or both d < -t"
// rejects all but ~0.5% of a rendered frame's pixels; only those get the
// full test. The neighbouring pairs are the pairs of one of N, S with one of
// E, W, so the pre-test is min(max(dN, dS), max(dE, dW)) > t or
// max(min(dN, dS), min(dE, dW)) < -t: 5 reads and 13 operations. On
// uniform noise ~84% pass, and the kernel is then bound by the full test's
// operations.
//
// Design: a block of 256 threads owns a 64 x 16 tile; a thread owns 4
// pixels of a row.
//   1. The tile and its 4 px halo (3 px circle + 1 px NMS ring), 72 x 24
//      pixels, are staged in shared memory by cp.async: 16 bytes a copy
//      where the image's base pointer and its rows are 16-byte aligned (W a
//      multiple of 4), else 4 bytes (the launcher picks the variant). Pixels
//      outside the image are zeros that no kept score reads.
//   2. The pre-test runs on every position of the tile and its 1 px ring
//      (18 rows of 66), four positions a thread from five float4 reads, and
//      writes -inf into the block's score map. Each warp compacts its
//      passing positions into a shared list with __ballot_sync and __popc
//      (one shared-memory atomicAdd a warp for its base), with the
//      polarities that passed.
//   3. The whole block's threads work the list: the full 16-difference arc
//      test for the polarities that passed (a polarity that failed the
//      pre-test scores <= t, so it cannot be the kept maximum); a score
//      above t goes into the score map.
//   4. 3x3 NMS where the thread's 4 pixels hold a score, out of the score
//      map; 0 elsewhere; one float4 store a thread (4 scalar stores in the
//      unaligned variant).
// The loads of a batch of images are kept in flight by many resident
// blocks: 14.5 KB of shared memory a block and __launch_bounds__(256, 6)
// (40 registers, no spills; the differences are taken anew for each
// polarity) hold six blocks an SM, 792 on 132 SMs, so one 480 x 752 image's
// 360 tiles run in one wave.
// No device state and no atomics across blocks: one launch, no memset,
// capturable in a CUDA graph. Ragged edges are masked, so H and W need not
// be multiples of the tile. The TPU kernel's row slabs and lane rolls are
// not carried over.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libfast_nms.so fast_nms.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/fast_cuda.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kThreads = kTileW / 4 * kTileH;      // 256: 4 pixels of a row each
constexpr int kHalo = 4;                           // 3 px circle + 1 px NMS ring
constexpr int kPixW = kTileW + 2 * kHalo;          // 72 staged columns
constexpr int kPixH = kTileH + 2 * kHalo;          // 24 staged rows
constexpr int kChunks = kPixW / 4;                 // 18 four-pixel chunks a row
constexpr int kRingH = kTileH + 2;                 // 18 score rows: tile + 1 px ring
constexpr int kMaxCand = kRingH * (kTileW + 2);    // 1188 ring positions
// The score map is (kRingH, kPixW): score row r is staged row r + 3 (global
// row y0 - 1 + r), score column c is staged column c (global x0 - 4 + c).
// Columns 3..68 are the tile and its ring; the others stay -inf, unread.
constexpr int kRingLo = kHalo - 1, kRingHi = kHalo + kTileW;   // 3, 68

// max over k of min(d[k], ..., d[k+9]) (indices mod 16), the arc minima by
// doubling: min of 2, 4, 8, then 8 + 2.
__device__ __forceinline__ float best_min_arc(const float (&d)[16]) {
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

// min over k of max(d[k], ..., d[k+9]): the dark polarity's best arc is its
// negation, without negating the 16 differences.
__device__ __forceinline__ float least_max_arc(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) m2[j] = fmaxf(d[j], d[(j + 1) & 15]);
#pragma unroll
  for (int j = 0; j < 16; ++j) m4[j] = fmaxf(m2[j], m2[(j + 2) & 15]);
#pragma unroll
  for (int j = 0; j < 16; ++j) m8[j] = fmaxf(m4[j], m4[(j + 4) & 15]);
  float least = fmaxf(m8[0], m2[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) least = fminf(least, fmaxf(m8[k], m2[(k + 8) & 15]));
  return least;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, float t) {
  // (dx, dy) of the Bresenham circle in circular order (fast_cuda.FAST_OFFSETS).
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  __shared__ __align__(16) float pix[kPixH * kPixW];
  __shared__ __align__(16) float score[kRingH * kPixW];
  // a candidate: (score-map index << 2) | dark << 1 | bright
  __shared__ unsigned short cand[kMaxCand];
  __shared__ int n_cand;

  const size_t plane = (size_t)H * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) n_cand = 0;

  // 1. Stage the tile and its halo.
  if (kVec) {
    for (int i = tid; i < kPixH * kChunks; i += kThreads) {
      const int sy = i / kChunks, q = i % kChunks;
      const int gy = y0 - kHalo + sy, gx = x0 - kHalo + 4 * q;   // gx % 4 == 0, W % 4 == 0
      float* d = pix + sy * kPixW + 4 * q;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        __pipeline_memcpy_async(d, im + (size_t)gy * W + gx, 16);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < kPixH * kPixW; i += kThreads) {
      const int sy = i / kPixW, sx = i % kPixW;
      const int gy = y0 - kHalo + sy, gx = x0 - kHalo + sx;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        __pipeline_memcpy_async(pix + i, im + (size_t)gy * W + gx, 4);
      else
        pix[i] = 0.f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. Pre-test on the tile and its ring, four positions a work item, and
  // compaction of the positions that pass. The loop bound is uniform, so
  // every lane reaches the ballots.
  const float nt = -t;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < kRingH * kChunks; base += kThreads) {
    const int i = base + tid;
    unsigned bright = 0, dark = 0;   // bit j: position 4q + j passes
    int r = 0, q = 0;
    if (i < kRingH * kChunks) {
      r = i / kChunks;
      q = i % kChunks;
      // Reads before the row's start (q = 0) or past its end (q = 17) land
      // in the neighbouring staged row; only positions 0..2 and 69..71 use
      // them, and those are never candidates.
      const float* p = pix + (r + 3) * kPixW + 4 * q;
      const float4 cen = *reinterpret_cast<const float4*>(p);
      const float4 lft = *reinterpret_cast<const float4*>(p - 4);
      const float4 rgt = *reinterpret_cast<const float4*>(p + 4);
      const float4 nth = *reinterpret_cast<const float4*>(p - 3 * kPixW);
      const float4 sth = *reinterpret_cast<const float4*>(p + 3 * kPixW);
      *reinterpret_cast<float4*>(score + r * kPixW + 4 * q) =
          make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      const float c[4] = {cen.x, cen.y, cen.z, cen.w};
      const float n[4] = {nth.x, nth.y, nth.z, nth.w};
      const float s[4] = {sth.x, sth.y, sth.z, sth.w};
      const float w[4] = {lft.y, lft.z, lft.w, cen.x};
      const float e[4] = {cen.w, rgt.x, rgt.y, rgt.z};
      // The item's positions that lie in the ring and >= 3 px from every
      // image edge: bits lo..hi.
      const int gy = y0 - 1 + r, base_x = x0 - kHalo;
      const int lo = max(max(kRingLo, 3 - base_x) - 4 * q, 0);
      const int hi = min(min(kRingHi, W - 4 - base_x) - 4 * q, 3);
      const unsigned valid =
          gy >= 3 && gy < H - 3 && lo <= hi ? (2u << hi) - (1u << lo) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dn = n[j] - c[j], ds = s[j] - c[j], de = e[j] - c[j], dw = w[j] - c[j];
        // The neighbouring compass pairs are exactly the pairs of one of N,
        // S with one of E, W.
        bright |= (unsigned)(fminf(fmaxf(dn, ds), fmaxf(de, dw)) > t) << j;
        dark |= (unsigned)(fmaxf(fminf(dn, ds), fminf(de, dw)) < nt) << j;
      }
      bright &= valid;
      dark &= valid;
    }
    const unsigned any = bright | dark;
    if (__ballot_sync(0xffffffffu, any != 0u) == 0u) continue;   // the common case
    unsigned ball[4];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ball[j] = __ballot_sync(0xffffffffu, (any >> j) & 1u);
      total += __popc(ball[j]);
    }
    int at = 0;
    if (lane == 0 && total > 0) at = atomicAdd(&n_cand, total);
    at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((any >> j) & 1u) {
        const int pos = r * kPixW + 4 * q + j;
        cand[at + __popc(ball[j] & below)] =
            (unsigned short)((pos << 2) | (((dark >> j) & 1u) << 1) | ((bright >> j) & 1u));
      }
      at += __popc(ball[j]);
    }
  }
  __syncthreads();

  // 3. The full segment test on the listed positions, by the whole block.
  const int n_list = n_cand;
  for (int k = tid; k < n_list; k += kThreads) {
    const unsigned entry = cand[k];
    const int pos = entry >> 2;
    const int r = pos / kPixW, col = pos % kPixW;
    const float* p = pix + (r + 3) * kPixW + col;
    const float cv = p[0];
    // The differences are taken anew for each polarity, so that only one
    // polarity's arrays are live at a time (registers, hence blocks an SM).
    float sc = -INFINITY;
    if (entry & 1u) {
      float d[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = p[kDy[j] * kPixW + kDx[j]] - cv;
      sc = best_min_arc(d);
    }
    if (entry & 2u) {
      float d[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = p[kDy[j] * kPixW + kDx[j]] - cv;
      sc = fmaxf(sc, -least_max_arc(d));
    }
    if (sc > t) score[pos] = sc;
  }
  __syncthreads();

  // 4. NMS and the output, 4 pixels of a row a thread.
  float* o = out + blockIdx.z * plane;
  for (int m = tid; m < kTileH * (kTileW / 4); m += kThreads) {
    const int tr = m / (kTileW / 4), tq = m % (kTileW / 4);
    const int gy = y0 + tr, gx = x0 + 4 * tq;
    if (gy >= H || gx >= W) continue;
    const float* sm = score + (tr + 1) * kPixW + kHalo + 4 * tq;
    const float4 mid = *reinterpret_cast<const float4*>(sm);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (mid.x > -INFINITY || mid.y > -INFINITY || mid.z > -INFINITY || mid.w > -INFINITY) {
      float rows[3][6];   // score-map columns 4tq + 3 .. 4tq + 8 of the three rows
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        const float* q = sm + (dr - 1) * kPixW;
        const float4 a = *reinterpret_cast<const float4*>(q);
        rows[dr][0] = q[-1];
        rows[dr][1] = a.x;
        rows[dr][2] = a.y;
        rows[dr][3] = a.z;
        rows[dr][4] = a.w;
        rows[dr][5] = q[4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = rows[1][j + 1];
        float nb = fmaxf(rows[1][j], rows[1][j + 2]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) nb = fmaxf(nb, fmaxf(rows[0][j + dx], rows[2][j + dx]));
        v[j] = (c > -INFINITY && c >= nb) ? c : 0.f;
      }
    }
    float* row = o + (size_t)gy * W + gx;
    if (kVec) {
      *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gx + j < W) row[j] = v[j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// 1 if the launcher runs the 16-byte variant for this (Bi, H, W) contiguous
// image, else 0 (the 4-byte variant): 16-byte copies need the image's base
// and every row 16-byte aligned. The launcher also needs the output's base
// aligned, as every output the wrapper allocates is.
int fast_nms_plan(const void* img, int W) { return W % 4 == 0 && aligned16(img); }

// img, out: (Bi, H, W) contiguous f32 on the device. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int fast_nms_launch(const float* img, float* out, int Bi, int H, int W, float threshold,
                    void* stream) {
  if (Bi <= 0 || H <= 0 || W <= 0 || Bi > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, Bi);
  const cudaStream_t s = (cudaStream_t)stream;
  if (fast_nms_plan(img, W) && aligned16(out))
    fast_nms_kernel<true><<<grid, kThreads, 0, s>>>(img, out, H, W, threshold);
  else
    fast_nms_kernel<false><<<grid, kThreads, 0, s>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}

const char* fast_nms_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
