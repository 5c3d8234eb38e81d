// Batched Mahalanobis gate on Hopper: gamma_i = r_i^T S_i^{-1} r_i.
//
// Replaces the TPU kernel msckf_mono_tpu/ops/psd_pallas.py::_gamma_kernel
// (wrapper gamma_psd, called by core/update.py gating_test_all). It computes
// the same function: S = L L^T by a right-looking Cholesky, then y = L^{-1} r
// by forward substitution and gamma = sum(y^2) (no back-substitution). A
// pivot <= 0 or NaN gives gamma = +inf, so the caller's `gamma < chi2` gate
// fails closed.
//
// What bounds it: the input. The function needs only the lower triangle of
// each S (the upper one is its mirror) and r: n * (R(R+1)/2 + R) * 4 bytes
// read once, 29.6 MB at the main path's marginalize shape (R = 41,
// n = 8192), about 8.8 us at 3.35 TB/s, and n * 4 bytes written. The
// R^3 / 3 flops of the factorization are negligible against the H100's f32
// rate. The kernel itself is far from that bound: one warp walks the R
// columns in turn.
//
// Design: one warp per system, kWarpsPerBlock systems per block. The warp
// copies its S and r into shared memory with coalesced loads (a system is
// contiguous), so device memory is touched once. It copies all of S: a copy
// of the lower triangle alone, row by row, ran slower on an H100, since the
// time goes to the column loop and not to device memory. Only the lower
// triangle is used from there on. The O(R^3) arithmetic then runs out of
// shared memory with lanes over rows and __syncwarp() between
// columns, and only gamma goes back to device memory. Lanes over rows give
// conflict-free shared-memory stores for odd R (stride R between lanes), and
// the column-j reads are broadcasts. The TPU's lanes-last layout and identity
// padding are not carried over: nothing here needs R to be a multiple of
// anything. Above 48 KB of shared memory per block (R > 54) the launcher
// raises the dynamic shared-memory limit with cudaFuncSetAttribute; an R
// whose block does not fit the card's limit (R > 120 on an H100) makes the
// launcher return that call's error.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libpsd_gamma.so psd_gamma.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/psd_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
psd_gamma_kernel(const float* __restrict__ S, const float* __restrict__ r,
                 float* __restrict__ out, int n, int R) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (sys >= n) return;  // the whole warp leaves together

  const int RR = R * R;
  float* A = smem + (size_t)warp * (RR + R);
  float* b = A + RR;
  const float* Sg = S + (size_t)sys * RR;
  const float* rg = r + (size_t)sys * R;
  for (int i = lane; i < RR; i += 32) A[i] = Sg[i];
  for (int i = lane; i < R; i += 32) b[i] = rg[i];
  __syncwarp();

  // Right-looking Cholesky on the lower triangle, in place: A[i][k] is
  // used only for k <= i, here and in the substitution.
  bool bad = false;
  for (int j = 0; j < R; ++j) {
    const float d = A[j * R + j];
    bad |= !(d > 0.f);
    const float s = rsqrtf(fmaxf(d, 1e-30f));
    __syncwarp();  // every lane has read the pivot before it is overwritten
    for (int i = j + lane; i < R; i += 32) A[i * R + j] *= s;
    __syncwarp();
    for (int i = j + 1 + lane; i < R; i += 32) {
      const float lij = A[i * R + j];
      float* row = A + (size_t)i * R;
      for (int k = j + 1; k <= i; ++k) row[k] -= lij * A[k * R + j];
    }
    __syncwarp();
  }

  // Forward substitution y = L^{-1} b; the lane that owns row j keeps y_j^2.
  float acc = 0.f;
  for (int j = 0; j < R; ++j) {
    const float yj = b[j] / A[j * R + j];
    if ((j & 31) == lane) acc += yj * yj;
    for (int i = j + 1 + lane; i < R; i += 32) b[i] -= A[i * R + j] * yj;
    __syncwarp();
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[sys] = bad ? INFINITY : acc;
}

// Shared memory one block needs for systems of size R.
size_t smem_bytes(int R) {
  return (size_t)kWarpsPerBlock * ((size_t)R * R + R) * sizeof(float);
}

}  // namespace

extern "C" {

// S: (n, R, R), r: (n, R), out: (n,), all contiguous f32 on the device.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of raising the shared-memory limit for an R too large.
int psd_gamma_launch(const float* S, const float* r, float* out, int n, int R,
                     void* stream) {
  if (n <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R);
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        psd_gamma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so that the next launch does not report it
      return (int)e;
    }
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  psd_gamma_kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      S, r, out, n, R);
  return (int)cudaGetLastError();
}

const char* psd_gamma_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
