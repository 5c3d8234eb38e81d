// Motion gate + Levenberg-Marquardt triangulation of feature tracks on Hopper.
//
// Replaces no TPU kernel: the JAX package triangulates in plain JAX
// (msckf_mono_tpu/core/triangulate.py, check_motion + initialize_position),
// and so did the port (core/triangulate.py, the same two functions). Added
// because that plain version is the largest mechanism of the frame step: it
// runs twice a frame (core/update.marginalize_prep on the staged tracks,
// core/prune.prune_prep on the prune candidates) as ~1,700 small PyTorch
// operations a call, and its LM evaluates all n_trials damped candidates of
// each outer step at once through (..., N, 3, n_trials) float32 intermediates:
// ~10 GB of operator traffic a call at (1024, 16, 28) for ~5 MB of inputs.
//
// What bounds it on this card: neither bytes nor flops. The inputs are
// (obs, mask, window poses), ~40 bytes a slot, and the work ~80 kFLOP a track
// (a few us for 16,384 tracks at 67 TFLOP/s f32). Each outer LM step is a
// chain of dependent warp reductions (the normal equations, then one cost per
// trial tried), so the kernel is bound by instructions and their latency.
//
// Design: one warp a track, lane j holding window slot j, so it takes
// N <= 32 window slots (every configuration has 8 to 28; the launcher refuses
// more). Each lane forms its slot's pose relative to the first observing
// camera (A_j, t_j) once, in registers.
// Every value the warp decides on (JᵀJ, Jᵀr, each trial's cost) is a
// butterfly shuffle sum, which leaves the same bits in every lane, so the
// whole warp takes every branch together. An outer step accumulates the
// Huber-weighted JᵀJ (6 values) and Jᵀr (3) over the slots, then tries the
// damped 3 x 3 adjugate solves in trial order, each lane solving the same
// system, until one lowers the cost.
//
// The rules are the plain version's, op for op in IEEE float32 (built with
// -fmad=false and without fast math, so no multiply-add is contracted and
// every division and square root is correctly rounded): the initial guess
// from the first and last observing views; lambda 1e-3, trial k damped by
// min(lambda 10^k, 1e12); the first trial that lowers the cost is accepted
// and lambda becomes max(lambda_k / 10, 1e-10), else the solution stays and
// lambda becomes min(lambda_{K-1} 10, 1e12); a track is done once the taken
// step's norm is <= 5e-7; valid when m >= 2 views observe it, the point lies
// in front of every one, and the cost / (2 max(m, 1)^2) <= max_gn_cost_norm.
// Two exits give the same results as the plain version's full sweeps: the
// trials after the first one that lowers the cost, whose costs the plain
// version computes and never reads, are not tried; and once a track is done
// the plain version freezes its state through every remaining outer step,
// so the warp leaves the loop. The sums run in warp order, not PyTorch's,
// so results agree with the plain version to rounding.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -fmad=false -o libtriangulate.so triangulate.cu
// and bound with ctypes (msckf_mono_tpu_torch/ops/triangulate_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 32;          // one slot a lane
constexpr int kWarpsPerBlock = 4;  // tracks a block

struct Inputs {
  const float* obs;      // (n, N, 2)
  const uint8_t* mask;   // (n, N)
  const float* q;        // (n / S, N, 4): track i reads window i / S
  const float* p;        // (n / S, N, 3)
  int n, N, S;
};

struct Params {
  float translation_threshold, max_cost_norm;
  int n_iters, n_trials;
};

// One window slot of a track: x_slot = A x_c0 + t maps the first observing
// camera's frame to the slot's (the plain version's _relative_poses).
struct Slot {
  float A[3][3], t[3], o[2];
  bool present, valid;  // present: j < N; valid: observed
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// A NaN passes through both, as through torch.clamp.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// utils/quat.to_rotmat: R v = q * v.
__device__ __forceinline__ void rotmat(const float* q, float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// Slot j of a track whose first observing camera has rotation R0 (world to
// camera, R(q)) and position p0: A = R_j R0ᵀ, t = R_j (p0 - p_j).
__device__ __forceinline__ Slot make_slot(const float* obs, const uint8_t* mask, const float* q,
                                          const float* p, int j, int N, const float R0[3][3],
                                          const float p0[3]) {
  Slot s = {};
  s.present = j < N;
  if (!s.present) return s;
  s.valid = mask[j] != 0;
  s.o[0] = obs[2 * j];
  s.o[1] = obs[2 * j + 1];
  float R[3][3];
  rotmat(q + 4 * j, R);
  const float d[3] = {p0[0] - p[3 * j], p0[1] - p[3 * j + 1], p0[2] - p[3 * j + 2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int l = 0; l < 3; ++l) s.A[i][l] = (R[i][0] * R0[l][0] + R[i][1] * R0[l][1]) + R[i][2] * R0[l][2];
    s.t[i] = (R[i][0] * d[0] + R[i][1] * d[1]) + R[i][2] * d[2];
  }
  return s;
}

// Squared reprojection error of the inverse-depth point X = (alpha, beta, rho).
__device__ __forceinline__ float slot_error(const Slot& s, const float X[3]) {
  float h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) h[i] = ((s.A[i][0] * X[0] + s.A[i][1] * X[1]) + s.A[i][2]) + X[2] * s.t[i];
  const float u = h[0] / h[2] - s.o[0], v = h[1] / h[2] - s.o[1];
  return u * u + v * v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    triangulate_warp_kernel(Inputs in, Params prm, uint8_t* __restrict__ motion_ok,
                            float* __restrict__ p_f_G, uint8_t* __restrict__ tri_ok) {
  const int lane = threadIdx.x & 31;
  const int track = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (track >= in.n) return;  // the whole warp
  const int N = in.N;
  const float* obs = in.obs + (size_t)track * N * 2;
  const uint8_t* mask = in.mask + (size_t)track * N;
  const size_t window = (size_t)(track / in.S) * N;
  const float* q = in.q + window * 4;
  const float* p = in.p + window * 3;

  // The first and last observing slot, with the plain version's argmax
  // conventions (0 and N - 1 where no slot observes), and their count.
  const unsigned observed = __ballot_sync(kFull, lane < N && mask[lane] != 0);
  const int i0 = observed ? __ffs(observed) - 1 : 0;
  const int i1 = observed ? 31 - __clz(observed) : N - 1;
  const int m = __popc(observed);

  float R0[3][3];
  rotmat(q + 4 * i0, R0);
  const float p0[3] = {p[3 * i0], p[3 * i0 + 1], p[3 * i0 + 2]};
  const float z0[2] = {obs[2 * i0], obs[2 * i0 + 1]};

  // Motion gate (check_motion): the widest baseline orthogonal to the first
  // observation's bearing, over the other observing slots; a NaN fails it,
  // as it does torch.amax.
  bool motion;
  {
    const float nrm = sqrtf((z0[0] * z0[0] + z0[1] * z0[1]) + 1.0f);
    const float d[3] = {z0[0] / nrm, z0[1] / nrm, 1.0f / nrm};
    float fd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) fd[i] = (R0[0][i] * d[0] + R0[1][i] * d[1]) + R0[2][i] * d[2];
    float widest = 0.0f;
    bool nan = false;
    if (lane != i0 && ((observed >> lane) & 1u)) {
      const int j = lane;
      const float t[3] = {p[3 * j] - p0[0], p[3 * j + 1] - p0[1], p[3 * j + 2] - p0[2]};
      const float par = (t[0] * fd[0] + t[1] * fd[1]) + t[2] * fd[2];
      const float o[3] = {t[0] - par * fd[0], t[1] - par * fd[1], t[2] - par * fd[2]};
      const float on = sqrtf((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]);
      if (isnan(on)) nan = true;
      else widest = on;
    }
    widest = warp_max(widest);
    nan = __any_sync(kFull, nan);
    motion = m >= 2 && !nan && widest > prm.translation_threshold;
  }

  const Slot s = make_slot(obs, mask, q, p, lane, N, R0, p0);
  // Masked slots add an exact 0 (torch.where), whatever their error.
  auto total_cost = [&](const float X[3]) {
    const float e = slot_error(s, X);
    return warp_sum(s.valid ? e : 0.0f);
  };

  // Two-view initial guess from the first and last observing slots.
  float sol[3];
  {
    const Slot last = make_slot(obs, mask, q, p, i1, N, R0, p0);
    float mv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) mv[i] = (last.A[i][0] * z0[0] + last.A[i][1] * z0[1]) + last.A[i][2];
    const float a0 = mv[0] - last.o[0] * mv[2], a1 = mv[1] - last.o[1] * mv[2];
    const float b0 = last.o[0] * last.t[2] - last.t[0], b1 = last.o[1] * last.t[2] - last.t[1];
    const float depth = (a0 * b0 + a1 * b1) / clamp_min(a0 * a0 + a1 * a1, 1e-20f);
    const float g[3] = {z0[0] * depth, z0[1] * depth, depth};
    sol[0] = g[0] / g[2];
    sol[1] = g[1] / g[2];
    sol[2] = 1.0f / g[2];
  }
  float cost = total_cost(sol);
  float lambda = 1e-3f;

  for (int it = 0; it < prm.n_iters; ++it) {
    // Huber-weighted normal equations at sol. A masked slot's weight is 0
    // times its Huber weight, as the plain version's mask times w², so a
    // non-finite masked slot poisons the sums there too.
    float JtJ[6] = {0, 0, 0, 0, 0, 0}, Jtr[3] = {0, 0, 0};  // JtJ: 00 01 02 11 12 22
    if (s.present) {
      float h[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        h[i] = ((s.A[i][0] * sol[0] + s.A[i][1] * sol[1]) + s.A[i][2]) + sol[2] * s.t[i];
      const float W[3][3] = {{s.A[0][0], s.A[0][1], s.t[0]},
                             {s.A[1][0], s.A[1][1], s.t[1]},
                             {s.A[2][0], s.A[2][1], s.t[2]}};
      const float h33 = h[2] * h[2];
      const float c0 = h[0] / h33, c1 = h[1] / h33;
      float J0[3], J1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        J0[k] = W[0][k] / h[2] - c0 * W[2][k];
        J1[k] = W[1][k] / h[2] - c1 * W[2][k];
    }
    const float r0 = h[0] / h[2] - s.o[0], r1 = h[1] / h[2] - s.o[1];
    const float e = sqrtf(r0 * r0 + r1 * r1);
    // 0.01 / (2 e) as the plain version's Python-scalar division computes
    // it: the reciprocal, then the product.
    const float w = e <= 0.01f ? 1.0f : (1.0f / (2.0f * clamp_min(e, 1e-20f))) * 0.01f;
    const float wt = (s.valid ? 1.0f : 0.0f) * (w == 1.0f ? 1.0f : w * w);
    JtJ[0] += wt * (J0[0] * J0[0] + J1[0] * J1[0]);
    JtJ[1] += wt * (J0[0] * J0[1] + J1[0] * J1[1]);
    JtJ[2] += wt * (J0[0] * J0[2] + J1[0] * J1[2]);
    JtJ[3] += wt * (J0[1] * J0[1] + J1[1] * J1[1]);
    JtJ[4] += wt * (J0[1] * J0[2] + J1[1] * J1[2]);
    JtJ[5] += wt * (J0[2] * J0[2] + J1[2] * J1[2]);
    Jtr[0] += wt * (J0[0] * r0 + J1[0] * r1);
    Jtr[1] += wt * (J0[1] * r0 + J1[1] * r1);
    Jtr[2] += wt * (J0[2] * r0 + J1[2] * r1);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) JtJ[i] = warp_sum(JtJ[i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) Jtr[i] = warp_sum(Jtr[i]);

    // Trials in order until one lowers the cost (the plain version takes the
    // first such); every lane solves the same damped system (linalg.solve3x3).
    bool lowered = false;
    float lam_k = lambda, step[3] = {0, 0, 0}, cand[3] = {0, 0, 0}, cand_cost = 0.0f;
    float pow10 = 1.0f;
    for (int k = 0; k < prm.n_trials; ++k, pow10 *= 10.0f) {
      lam_k = clamp_max(lambda * pow10, 1e12f);
      const float a00 = JtJ[0] + lam_k, a01 = JtJ[1], a02 = JtJ[2];
      const float a10 = JtJ[1], a11 = JtJ[3] + lam_k, a12 = JtJ[4];
      const float a20 = JtJ[2], a21 = JtJ[4], a22 = JtJ[5] + lam_k;
      const float c00 = a11 * a22 - a12 * a21, c01 = a12 * a20 - a10 * a22,
                  c02 = a10 * a21 - a11 * a20;
      float det = (a00 * c00 + a01 * c01) + a02 * c02;
      det = fabsf(det) > 1e-30f ? det : 1e-30f;
      const float c10 = a02 * a21 - a01 * a22, c11 = a00 * a22 - a02 * a20,
                  c12 = a01 * a20 - a00 * a21;
      const float c20 = a01 * a12 - a02 * a11, c21 = a02 * a10 - a00 * a12,
                  c22 = a00 * a11 - a01 * a10;
      step[0] = ((c00 * Jtr[0] + c10 * Jtr[1]) + c20 * Jtr[2]) / det;
      step[1] = ((c01 * Jtr[0] + c11 * Jtr[1]) + c21 * Jtr[2]) / det;
      step[2] = ((c02 * Jtr[0] + c12 * Jtr[1]) + c22 * Jtr[2]) / det;
#pragma unroll
      for (int i = 0; i < 3; ++i) cand[i] = sol[i] - step[i];
      cand_cost = total_cost(cand);
      if (cand_cost < cost) {
        lowered = true;
        break;
      }
    }
    // Here lam_k and step are the accepted trial's, or the last trial's.
    if (lowered) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sol[i] = cand[i];
      cost = cand_cost;
      lambda = clamp_min(lam_k / 10.0f, 1e-10f);
    } else {
      lambda = clamp_max(lam_k * 10.0f, 1e12f);
    }
    if (sqrtf((step[0] * step[0] + step[1] * step[1]) + step[2] * step[2]) <= 5e-7f) break;
  }

  const float fp[3] = {sol[0] / sol[2], sol[1] / sol[2], 1.0f / sol[2]};
  // Cheirality in every observing view.
  const bool front = __all_sync(
      kFull, !s.valid || ((s.A[2][0] * fp[0] + s.A[2][1] * fp[1]) + s.A[2][2] * fp[2]) + s.t[2] > 0.0f);
  const float mf = (float)(m < 1 ? 1 : m);
  const bool valid = front && cost / (2.0f * (mf * mf)) <= prm.max_cost_norm && m >= 2;

  if (lane == 0) {
    motion_ok[track] = motion;
    tri_ok[track] = valid;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      p_f_G[3 * (size_t)track + i] = ((R0[0][i] * fp[0] + R0[1][i] * fp[1]) + R0[2][i] * fp[2]) + p0[i];
  }
}

}  // namespace

extern "C" {

// obs (n, N, 2) f32, mask (n, N) bytes (0 or 1), q (n / S, N, 4) and p
// (n / S, N, 3) f32, track i on window i / S; outputs motion_ok (n,) and
// tri_ok (n,) bytes, p_f_G (n, 3) f32; all contiguous on the device. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (N > 32 among them).
int triangulate_launch(const float* obs, const uint8_t* mask, const float* q, const float* p, int n,
                       int N, int S, float translation_threshold, float max_cost_norm, int n_iters,
                       int n_trials, uint8_t* motion_ok, float* p_f_G, uint8_t* tri_ok,
                       void* stream) {
  if (n <= 0 || N <= 0 || N > kMaxN || S <= 0 || n % S != 0 || n_iters < 0 || n_trials < 1)
    return (int)cudaErrorInvalidValue;
  const Inputs in{obs, mask, q, p, n, N, S};
  const Params prm{translation_threshold, max_cost_norm, n_iters, n_trials};
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = (cudaStream_t)stream;
  triangulate_warp_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(in, prm, motion_ok, p_f_G, tri_ok);
  return (int)cudaGetLastError();
}

const char* triangulate_error_name(int rc) { return cudaGetErrorName((cudaError_t)rc); }

}  // extern "C"
