"""IMU propagation (port of ``msckf_mono_tpu/core/propagate.py``).

Same math as ``MSCKF::propagate`` (reference msckf.h:101-145):

* continuous-time error-state Jacobians F (15x15) and G (15x12)
  (msckf.h:874-903), error-state ordering [θ, b_g, v, b_a, p];
* 6-stage fixed-coefficient RK quaternion integration, Euler v and
  previous-velocity p update (msckf.h:1425-1467);
* Φ = expm(F·dt) via fixed-order Taylor (ops/expm.py);
* observability-constrained Φ surgery (OC-EKF, msckf.h:113-132);
* covariance propagation Φ(P₁₅+GQGᵀdt)Φᵀ with symmetrization and the
  cross-covariance Φ·P[0:15,15:] (msckf.h:134-144).

Every function takes a leading batch axis (B, ...).
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.core.types import FilterState, ImuState
from portbench.reference.msckf.ops.expm import expm_taylor
from portbench.reference.msckf.ops.linalg import bmv
from portbench.reference.msckf.utils import quat
from portbench.reference.msckf.utils.config import MsckfConfig


def _blocks(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def calc_F(imu: ImuState, omega, a):
    """Continuous-time error-state Jacobian (reference msckf.h:874-890); (..., 15, 15)."""
    omega_hat = omega - imu.b_g
    a_hat = a - imu.b_a
    C_IG = quat.to_rotmat(imu.q_IG)
    batch = C_IG.shape[:-2]
    eye3 = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(batch + (3, 3))
    z3 = torch.zeros_like(eye3)
    C_GI = C_IG.transpose(-1, -2)
    return _blocks([
        [-quat.skew(omega_hat), -eye3, z3, z3, z3],
        [z3, z3, z3, z3, z3],
        [-(C_GI @ quat.skew(a_hat)), z3, z3, -C_GI, z3],
        [z3, z3, z3, z3, z3],
        [z3, z3, eye3, z3, z3],
    ])


def calc_G(imu: ImuState, dtype):
    """Noise input Jacobian (reference msckf.h:892-903); (..., 15, 12)."""
    C_IG = quat.to_rotmat(imu.q_IG).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=C_IG.device).expand(C_IG.shape)
    z3 = torch.zeros_like(eye3)
    return _blocks([
        [-eye3, z3, z3, z3],
        [z3, eye3, z3, z3],
        [z3, z3, -C_IG.transpose(-1, -2), z3],
        [z3, z3, z3, eye3],
        [z3, z3, z3, z3],
    ])


def propagate_imu_state(imu: ImuState, omega, a, dt) -> ImuState:
    """State integration (reference msckf.h:1425-1467); dt has the batch shape.

    p update intentionally uses the pre-update velocity (msckf.h:1465).
    """
    q_new = quat.integrate_rk5(imu.q_IG, omega - imu.b_g, dt)
    C_IG = quat.to_rotmat(imu.q_IG)
    dt3 = dt[..., None]
    v_new = imu.v_I_G + (bmv(C_IG.transpose(-1, -2), a - imu.b_a) + imu.g) * dt3
    p_new = imu.p_I_G + imu.v_I_G * dt3
    return imu.replace(q_IG=q_new, v_I_G=v_new, p_I_G=p_new)


def _oc_surgery(Phi, q_null, q_post, v_null, v_post, p_null, p_post, g, dt):
    """OC-EKF nullspace enforcement on Φ (msckf.h:111-132), batched."""
    R_kk_1 = quat.to_rotmat(q_null)
    R_prop = quat.to_rotmat(q_post)
    Phi = Phi.clone()
    Phi[..., 0:3, 0:3] = R_prop @ R_kk_1.transpose(-1, -2)

    u = bmv(R_kk_1, g)
    s = u / torch.sum(u * u, dim=-1, keepdim=True)

    A1 = Phi[..., 6:9, 0:3]
    w1 = bmv(quat.skew(v_null - v_post), g)
    lhs1 = bmv(A1, u) - w1
    Phi[..., 6:9, 0:3] = A1 - lhs1[..., :, None] * s[..., None, :]

    A2 = Phi[..., 12:15, 0:3]
    tmp = dt[..., None] * v_null + p_null - p_post
    w2 = bmv(quat.skew(tmp), g)
    lhs2 = bmv(A2, u) - w2
    Phi[..., 12:15, 0:3] = A2 - lhs2[..., :, None] * s[..., None, :]
    return Phi


def compute_phi(imu: ImuState, imu_prop: ImuState, F, dt):
    """Φ = expm(F·dt) with OC-EKF nullspace enforcement (msckf.h:111-132)."""
    Phi = expm_taylor(F * dt[..., None, None])
    return _oc_surgery(Phi, imu.q_IG_null, imu_prop.q_IG, imu.v_I_G_null, imu_prop.v_I_G,
                       imu.p_I_G_null, imu_prop.p_I_G, imu.g, dt)


def _set_imu_block(P, P00, P0c):
    P = P.clone()
    P[:, 0:15, 0:15] = P00
    P[:, 0:15, 15:] = P0c
    P[:, 15:, 0:15] = P0c.transpose(-1, -2)
    return P


def propagate_block(state: FilterState, omegas, accs, dts, config: MsckfConfig) -> FilterState:
    """All K IMU samples of one frame in a single composed covariance update.

    Identical math to running :func:`propagate` K times: the recurrence
    P_{k+1} = Φ_k (P_k + G_k Q G_kᵀ dt_k) Φ_kᵀ composes to

        P_K  = S_0 P_0 S_0ᵀ + Σ_k S_k (G_k Q G_kᵀ dt_k) S_kᵀ,
        S_k  = Φ_{K-1} ··· Φ_k,

    so only the small state integration is sequential (a Python loop of K
    steps) and the (15+6N)-wide covariance is touched once.

    omegas/accs: (B, K, 3); dts: (B, K), 0 for padded samples (identity steps).
    """
    dtype = state.P.dtype
    dev = state.P.device
    omegas = torch.as_tensor(omegas, dtype=dtype, device=dev)
    accs = torch.as_tensor(accs, dtype=dtype, device=dev)
    dts = torch.as_tensor(dts, dtype=dtype, device=dev)
    K = dts.shape[-1]
    imu0 = state.imu

    # 1) sequential state integration
    pre, imu = [], imu0
    for k in range(K):
        pre.append(imu)
        imu = propagate_imu_state(imu, omegas[:, k], accs[:, k], dts[:, k])
    imuN = imu
    post = pre[1:] + [imuN]

    def stack(states, name):
        return torch.stack([getattr(s, name) for s in states], dim=1)   # (B, K, ·)

    imu_pre = ImuState(**{n: stack(pre, n) for n in ("q_IG", "b_g", "v_I_G", "b_a", "p_I_G",
                                                      "g", "q_IG_null", "v_I_G_null",
                                                      "p_I_G_null")})
    # OC-EKF null linearization points: step k>=1 sees null == its pre-step
    # state; only step 0 uses the stored nulls (they survive EKF corrections).
    q_null = torch.cat([imu0.q_IG_null[:, None], imu_pre.q_IG[:, 1:]], dim=1)
    v_null = torch.cat([imu0.v_I_G_null[:, None], imu_pre.v_I_G[:, 1:]], dim=1)
    p_null = torch.cat([imu0.p_I_G_null[:, None], imu_pre.p_I_G[:, 1:]], dim=1)

    # 2) batched per-sample Φ with the OC surgery
    F = calc_F(imu_pre, omegas, accs)                                 # (B,K,15,15)
    Phi = expm_taylor(F * dts[..., None, None])
    g = imu0.g[:, None, :]                                            # (B,1,3)
    Phi = _oc_surgery(Phi, q_null, stack(post, "q_IG"), v_null, stack(post, "v_I_G"),
                      p_null, stack(post, "p_I_G"), g, dts)

    # 3) suffix transition products S_k = Φ_{K-1}···Φ_k
    S_k = torch.eye(15, dtype=dtype, device=dev).expand(Phi.shape[0], 15, 15)
    suffix = [None] * K
    for k in range(K - 1, -1, -1):
        S_k = S_k @ Phi[:, k]
        suffix[k] = S_k
    S = torch.stack(suffix, dim=1)                                    # (B,K,15,15)
    S0 = S[:, 0]

    # 4) one composed covariance update
    Q = torch.diag_embed(state.q_imu_diag.to(dtype))                  # (B,12,12)
    G = calc_G(imu_pre, dtype)                                        # (B,K,15,12)
    SG = S @ G                                                        # (B,K,15,12)
    noise = torch.einsum("bk,bkac,bcd,bked->bae", dts, SG, Q, SG)

    P = state.P
    P00_prop = S0 @ P[:, 0:15, 0:15] @ S0.transpose(-1, -2) + noise
    P00_prop = 0.5 * (P00_prop + P00_prop.transpose(-1, -2))
    P0c = S0 @ P[:, 0:15, 15:]
    P = _set_imu_block(P, P00_prop, P0c)

    imu_new = imuN.replace(q_IG_null=imuN.q_IG, v_I_G_null=imuN.v_I_G, p_I_G_null=imuN.p_I_G)
    return state.replace(imu=imu_new, P=P)


def propagate(state: FilterState, omega, a, dt, config: MsckfConfig) -> FilterState:
    """One IMU sample. omega/a: (B, 3), dt: (B,)."""
    dtype = state.P.dtype
    dev = state.P.device
    omega = torch.as_tensor(omega, dtype=dtype, device=dev)
    a = torch.as_tensor(a, dtype=dtype, device=dev)
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)

    imu = state.imu
    F = calc_F(imu, omega, a)
    G = calc_G(imu, dtype)
    imu_prop = propagate_imu_state(imu, omega, a, dt)
    Phi = compute_phi(imu, imu_prop, F, dt)

    Q = torch.diag_embed(state.q_imu_diag.to(dtype))
    P = state.P
    P00 = P[:, 0:15, 0:15]
    GQG = G @ Q @ G.transpose(-1, -2) * dt[:, None, None]
    P00_prop = Phi @ (P00 + GQG) @ Phi.transpose(-1, -2)
    P00_prop = 0.5 * (P00_prop + P00_prop.transpose(-1, -2))
    P0c = Phi @ P[:, 0:15, 15:]
    P = _set_imu_block(P, P00_prop, P0c)

    imu_new = imu_prop.replace(
        q_IG_null=imu_prop.q_IG, v_I_G_null=imu_prop.v_I_G, p_I_G_null=imu_prop.p_I_G
    )
    return state.replace(imu=imu_new, P=P)
