// Batched Mahalanobis gate on Hopper: gamma_i = r_i^T S_i^{-1} r_i.
//
// Replaces the TPU kernel msckf_mono_tpu/ops/psd_pallas.py::_gamma_kernel
// (wrapper gamma_psd, called by core/update.py gating_test_all). It computes
// the same function, S = L L^T and gamma = |L^{-1} r|^2, with the same
// behaviour: only the lower triangle of S is read, a pivot <= 0 or NaN gives
// gamma = +inf (the caller's `gamma < chi2` gate fails closed).
//
// What bounds it on this card: the bytes would (the lower triangle and r,
// n * (R(R+1)/2 + R) * 4 read once: 29.6 MB, ~8.8 us at 3.35 TB/s for the
// main path's R = 41, n = 8192; the R^3/3 flops a system are ~1 us at
// 67 TFLOP/s), but a Cholesky is a chain of R dependent rank-1 updates, so
// what bounds a design is how evenly each column's update is spread and how
// many steps wait on each other. The earlier design gave each lane one row:
// at column j the lane of row i did i - j updates and the warp waited for the
// longest, ~R^2 dependent steps a system; at R = 1 one lane of 32 worked.
//
// Design: factor the bordered matrix [[S, r], [r^T, 0]] of M = R + 1 rows,
// right-looking. After the R columns, row R holds y = L^{-1} r and its
// diagonal 0 - sum_j y_j^2 = -gamma, so the forward substitution is fused
// into the factorization. Variants by R (the launcher picks, plan_for; the
// wrapper asks psd_gamma_plan only for the scratch a system needs):
// - kThread, R <= kThreadMaxR: one thread a system, the bordered triangle in
//   registers, fully unrolled; 32 systems a warp (the prune gate's R = 1).
// - kWarp, R + 1 <= 64: one warp a system, up to 4 a block. Lane l holds
//   rows l and M-1-l in registers (row lengths l + 1 and M - l: the same
//   M + 1 entries on every busy lane, so every column's trailing update is
//   split evenly, about M/2 updates a lane where one-row-a-lane gave up to
//   M); the scaled column is broadcast through a small shared cache as
//   float4 loads. The system is staged by coalesced cp.async copies.
// - kBlock: one block a system, the packed bordered triangle in dynamic
//   shared memory (tri(M) + M floats: R <= 338 in 227 KB); each column's
//   trailing update is spread over all (i, k) pairs, which the block's
//   threads walk in packed order with stride blockDim.
// - kScratch: as kBlock, on a device-memory copy the wrapper allocates
//   (n * (tri(M) + M) floats): any R. Slow, but no R raises for lack of
//   shared memory.
// The kBlock walk run by one warp was the first design for the main path's
// R = 41; PERF.md records why kWarp replaced it there.
// No tensor cores: the updates are dependent f32 rank-1 steps, and TF32
// would break the gate as the bf16 passes did on the TPU.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libpsd_gamma.so psd_gamma.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/psd_cuda.py).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThread = 0, kWarp = 1, kBlock = 2, kScratch = 3;
constexpr int kThreadMaxR = 4;
constexpr int kRowsMaxMB = 64;  // kWarp: R + 1 <= 64 registers a row
constexpr int kMaxSmem = 232448;       // shared memory one block may use on an H100
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kThreadBlock = 128;      // kThread: systems (threads) a block
constexpr int kSystemsPerBlock = 4;    // kWarp: systems (warps) a block
constexpr int kBlockThreads = 256;     // kBlock, kScratch: threads a system

__host__ __device__ constexpr long long tri(long long i) { return i * (i + 1) / 2; }

// Floats one system takes: the bordered packed triangle and the column cache.
__host__ __device__ constexpr long long system_floats(int R) { return tri(R + 1) + R + 1; }

// Floats one warp of gamma_rows_kernel takes: the column cache (MB), S, r and
// the border's 0, rounded up to 4 floats so every warp's cache is 16-byte
// aligned.
__host__ __device__ constexpr int rows_floats(int R, int MB) {
  return MB + (R * R + R + 1 + 3) / 4 * 4;
}

// Registers a row of gamma_rows_kernel: R + 1 rounded up to 4, at least 8.
constexpr int rows_mb(int R) { return (R + 4) / 4 * 4 < 8 ? 8 : (R + 4) / 4 * 4; }

template <int R>
__global__ void gamma_thread_kernel(const float* __restrict__ S, const float* __restrict__ r,
                                    float* __restrict__ out, int n) {
  const long long sys = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (sys >= n) return;
  constexpr int M = R + 1;
  float a[tri(M)];
  const float* Sg = S + sys * R * R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k <= i; ++k) a[tri(i) + k] = __ldg(Sg + i * R + k);
#pragma unroll
  for (int k = 0; k < R; ++k) a[tri(R) + k] = __ldg(r + sys * R + k);
  a[tri(R) + R] = 0.f;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float d = a[tri(j) + j];
    bad |= !(d > 0.f);
    const float s = rsqrtf(fmaxf(d, 1e-30f));
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i > j) a[tri(i) + j] *= s;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (j < k && k <= i) a[tri(i) + k] -= a[tri(i) + j] * a[tri(k) + j];
  }
  out[sys] = bad ? INFINITY : -a[tri(R) + R];
}

// The G = blockDim threads (rank t) of a block factor one bordered system
// held in A (packed, tri(R+1) floats) with the column cache col (R + 1
// floats), in shared memory or, for kScratch, in device memory (the block's
// __syncthreads orders both).
template <bool kAsyncLoad>
__device__ float factor_bordered(const float* __restrict__ Sg, const float* __restrict__ rg,
                                 float* A, float* col, int R, int t, int G) {
  // Load the lower triangle of S, packed position p = tri(i) + k taken with
  // stride G, then the border row r, 0. Into shared memory the copies are
  // cp.async, all in flight at once and holding no registers.
  int i = 0, k = t;
  while (k > i) k -= ++i;
  while (i < R) {
    if (kAsyncLoad)
      __pipeline_memcpy_async(A + tri(i) + k, Sg + (size_t)i * R + k, 4);
    else
      A[tri(i) + k] = __ldg(Sg + (size_t)i * R + k);
    k += G;
    while (k > i) k -= ++i;
  }
  for (int k = t; k < R; k += G) {
    if (kAsyncLoad)
      __pipeline_memcpy_async(A + tri(R) + k, rg + k, 4);
    else
      A[tri(R) + k] = __ldg(rg + k);
  }
  if (kAsyncLoad) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  if (t == 0) A[tri(R) + R] = 0.f;
  bool bad = false;
  for (int j = 0; j < R; ++j) {
    __syncthreads();  // column j is final, and col is free again
    const float d = A[tri(j) + j];
    bad |= !(d > 0.f);
    const float s = rsqrtf(fmaxf(d, 1e-30f));
    float* c1 = col + j + 1;         // c1[m] = l_{j+1+m}
    const int rows = R - j;          // rows j+1 .. R below the pivot
    for (int m = t; m < rows; m += G) c1[m] = A[tri(j + 1 + m) + j] * s;
    __syncthreads();
    // Pairs (i, k) = (j+1+ii, j+1+kk), 0 <= kk <= ii < rows, taken in packed
    // order with stride G: row ii of the trailing triangle has ii + 1 pairs.
    int ii = 0, kk = t;
    while (kk > ii) kk -= ++ii;
    if (ii >= rows) continue;
    float* arow = A + tri(j + 1 + ii) + j + 1;
    float li = c1[ii];
    while (true) {
      arow[kk] -= li * c1[kk];
      kk += G;
      if (kk > ii) {
        do kk -= ++ii;
        while (kk > ii);
        if (ii >= rows) break;
        arow = A + tri(j + 1 + ii) + j + 1;
        li = c1[ii];
      }
    }
  }
  __syncthreads();
  // Every thread saw every pivot, so `bad` agrees across the group.
  return bad ? INFINITY : -A[tri(R) + R];
}

// Column J of gamma_rows_kernel, then J + 1, ...: one instantiation a
// column, so every register index is a compile-time constant whatever the
// compiler's unrolling does (a loop over j that it left rolled put a row's
// registers in local memory).
template <int MB, int J>
__device__ __forceinline__ void rows_column(float (&ra)[MB], float (&rb)[MB], float* col, int R,
                                            int iA, int iB, bool hasA, bool hasB, bool& bad,
                                            float& gamma) {
  if constexpr (J < MB - 1) {
    if (J >= R) return;  // uniform across the warp
    const int M = R + 1;
    // Row J is row iA of lane J where 2J < M, else row iB of lane M-1-J.
    const float d = 2 * J < M ? __shfl_sync(0xffffffffu, ra[J], J)
                              : __shfl_sync(0xffffffffu, rb[J], M - 1 - J);
    bad |= !(d > 0.f);
    const float s = rsqrtf(fmaxf(d, 1e-30f));
    const float la = ra[J] * s, lb = rb[J] * s;
    gamma = fmaf(lb, lb, gamma);  // on lane 0, whose row iB is the border: y_J^2
    if (hasA && iA > J) col[iA] = la;
    if (hasB && iB > J) col[iB] = lb;
    __syncwarp();
#pragma unroll
    for (int k4 = (J + 1) / 4; k4 < MB / 4; ++k4) {
      const float4 c = reinterpret_cast<const float4*>(col)[k4];
      const float ck[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * k4 + e > J) {
          ra[4 * k4 + e] -= la * ck[e];
          rb[4 * k4 + e] -= lb * ck[e];
        }
      }
    }
    __syncwarp();  // the cache is rewritten at the next column
    rows_column<MB, J + 1>(ra, rb, col, R, iA, iB, hasA, hasB, bad, gamma);
  }
}

// One warp a system, rows in registers. Lane l holds rows iA = l and
// iB = M-1-l of the bordered matrix (M = R + 1 rows, MB >= M registers a
// row, a multiple of 4), so every lane holds about (M + 1) / 2 entries a
// column and each column's update is split evenly over the (M + 1) / 2 busy
// lanes. Column j: the pivot comes from its owner by a shuffle; each lane
// writes its rows' scaled entries l_i to the shared column cache; then every
// lane updates its rows, a[k] -= l_row * l_k for all k > j, reading the cache
// four entries at a time (broadcast float4 loads). Entries right of a row's
// diagonal, and rows already factored, take junk updates that are never read
// (a row's entry k is read only as the pivot, k = row, or as l_row while
// k < row), so the update needs no predicate and every register index is a
// compile-time constant. gamma = sum_j y_j^2 is summed by lane 0, which holds
// the border row. The system is staged in shared memory first (S and
// r in full, coalesced cp.async; only the lower triangle is read from there).
template <int MB>
__global__ void __launch_bounds__(128)
gamma_rows_kernel(const float* __restrict__ S, const float* __restrict__ r,
                  float* __restrict__ out, int n, int R) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= n) return;  // the whole warp leaves together
  const int M = R + 1;
  float* col = smem + (size_t)warp * rows_floats(R, MB);
  float* st = col + MB;  // S (R * R), then r (R), then the border's 0
  const float* Sg = S + sys * R * R;
  for (int i = lane; i < R * R; i += 32) __pipeline_memcpy_async(st + i, Sg + i, 4);
  for (int i = lane; i < R; i += 32) __pipeline_memcpy_async(st + R * R + i, r + sys * R + i, 4);
  __pipeline_commit();
  for (int i = lane; i < MB; i += 32) col[i] = 0.f;
  if (lane == 0) st[R * R + R] = 0.f;
  __pipeline_wait_prior(0);
  __syncwarp();

  const int iA = lane, iB = M - 1 - lane;
  const bool hasA = iA <= iB, hasB = iA < iB;
  float ra[MB], rb[MB];
  // Row i's entry k <= i is st[i * R + k]: for i = R that is r_k, and the
  // border's diagonal st[R * R + R] is 0.
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    ra[k] = hasA && k <= iA ? st[iA * R + k] : 0.f;
    rb[k] = hasB && k <= iB ? st[iB * R + k] : 0.f;
  }
  // The border row R is row iB of lane 0: its scaled entries are y = L^{-1} r,
  // and lane 0 sums their squares as they come (reading the border's
  // diagonal rb[R] instead would index the registers by a runtime R).
  bool bad = false;
  float gamma = 0.f;
  rows_column<MB, 0>(ra, rb, col, R, iA, iB, hasA, hasB, bad, gamma);
  if (lane == 0) out[sys] = bad ? INFINITY : gamma;
}

template <bool kInScratch>
__global__ void gamma_block_kernel(const float* __restrict__ S, const float* __restrict__ r,
                                   float* __restrict__ out, int n, int R, float* scratch) {
  extern __shared__ float smem[];
  const long long sys = blockIdx.x;
  float* A = kInScratch ? scratch + sys * system_floats(R) : smem;
  const float g = factor_bordered<!kInScratch>(S + sys * R * R, r + sys * R, A,
                                                       A + tri(R + 1), R, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) out[sys] = g;
}

template <int R>
int launch_thread(const float* S, const float* r, float* out, int n, cudaStream_t s) {
  const int blocks = (n + kThreadBlock - 1) / kThreadBlock;
  gamma_thread_kernel<R><<<blocks, kThreadBlock, 0, s>>>(S, r, out, n);
  return (int)cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory limit to `smem` where the default
// 48 KB does not cover it; `raised` remembers the kernel's limit so far.
template <typename Kernel>
int raise_smem_limit(Kernel kernel, int smem, int& raised) {
  if (smem <= kDefaultSmem || smem <= raised) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return (int)e;
  }
  raised = smem;
  return 0;
}

template <int MB>
int launch_rows(const float* S, const float* r, float* out, int n, int R, int smem,
                cudaStream_t s) {
  static int raised = 0;
  if (int e = raise_smem_limit(gamma_rows_kernel<MB>, smem, raised)) return e;
  gamma_rows_kernel<MB><<<(n + kSystemsPerBlock - 1) / kSystemsPerBlock, kSystemsPerBlock * 32,
                          smem, s>>>(S, r, out, n, R);
  return (int)cudaGetLastError();
}

// How systems of R rows run: the variant and a block's dynamic shared memory.
// The byte counts are the kernels' own layouts (rows_floats, system_floats).
struct Plan {
  int variant, smem;
};

Plan plan_for(int R) {
  if (R <= kThreadMaxR) return {kThread, 0};
  if (rows_mb(R) <= kRowsMaxMB)
    return {kWarp, kSystemsPerBlock * rows_floats(R, rows_mb(R)) * (int)sizeof(float)};
  const long long block = system_floats(R) * (long long)sizeof(float);
  if (block <= kMaxSmem) return {kBlock, (int)block};
  return {kScratch, 0};
}

}  // namespace

extern "C" {

// The variant the launcher runs for R (kThread 0, kWarp 1, kBlock 2,
// kScratch 3); *smem_bytes gets its dynamic shared memory a block and
// *scratch_bytes the device memory a system needs (0 unless kScratch).
int psd_gamma_plan(int R, int* smem_bytes, long long* scratch_bytes) {
  const Plan p = plan_for(R);
  *smem_bytes = p.smem;
  *scratch_bytes = p.variant == kScratch ? system_floats(R) * (long long)sizeof(float) : 0;
  return p.variant;
}

// S: (n, R, R), r: (n, R), out: (n,), all contiguous f32 on the device;
// scratch: n * the scratch bytes psd_gamma_plan names, or null where it names
// none. Launches the variant plan_for picks on `stream` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes or a
// missing scratch, or the error of raising the shared-memory limit.
int psd_gamma_launch(const float* S, const float* r, float* out, int n, int R, float* scratch,
                     void* stream) {
  if (n <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Plan p = plan_for(R);
  switch (p.variant) {
    case kThread:
      switch (R) {
        case 1: return launch_thread<1>(S, r, out, n, s);
        case 2: return launch_thread<2>(S, r, out, n, s);
        case 3: return launch_thread<3>(S, r, out, n, s);
        case 4: return launch_thread<4>(S, r, out, n, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case kWarp:
      switch (rows_mb(R)) {
#define ROWS_CASE(MB) \
  case MB:            \
    return launch_rows<MB>(S, r, out, n, R, p.smem, s);
        ROWS_CASE(8) ROWS_CASE(12) ROWS_CASE(16) ROWS_CASE(20) ROWS_CASE(24)
        ROWS_CASE(28) ROWS_CASE(32) ROWS_CASE(36) ROWS_CASE(40) ROWS_CASE(44)
        ROWS_CASE(48) ROWS_CASE(52) ROWS_CASE(56) ROWS_CASE(60) ROWS_CASE(64)
#undef ROWS_CASE
        default: return (int)cudaErrorInvalidValue;
      }
    case kBlock: {
      static int raised = 0;
      if (int e = raise_smem_limit(gamma_block_kernel<false>, p.smem, raised)) return e;
      gamma_block_kernel<false><<<n, kBlockThreads, p.smem, s>>>(S, r, out, n, R, nullptr);
      return (int)cudaGetLastError();
    }
    default: {  // kScratch
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      gamma_block_kernel<true><<<n, kBlockThreads, 0, s>>>(S, r, out, n, R, scratch);
      return (int)cudaGetLastError();
    }
  }
}

const char* psd_gamma_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
