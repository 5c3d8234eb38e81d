"""The synthetic EuRoC-rate world: the traffic every cell is made from.

A copy of the port's ``data/synthetic.py`` generator (numpy, same seed, same
sequence): a loop trajectory inside a cylinder of landmarks, a 200 Hz IMU
consistent with the filter's own discrete kinematics, a 20 Hz camera with
its feature tracks. ``config`` needs ``.shapes.imu_per_frame``,
``.shapes.max_features_per_frame`` and ``.camera`` (the program's config or
the reference's: both have them).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _quat_mul_np(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _quat_rotmat_np(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def _integrate_rk5_np(q, omega, dt):
    """Numpy mirror of utils.quat.integrate_rk5 (same tableau)."""
    s = np.array(
        [[0, -omega[2], omega[1]], [omega[2], 0, -omega[0]], [-omega[1], omega[0], 0]]
    )
    om = np.zeros((4, 4))
    om[0:3, 0:3] = -s
    om[0:3, 3] = omega
    om[3, 0:3] = -omega
    om *= 0.5
    y0 = np.array([-q[1], -q[2], -q[3], q[0]])
    f = lambda y: om @ y
    k0 = f(y0)
    k1 = f(y0 + (k0 / 4.0) * dt)
    k2 = f(y0 + (k0 / 8.0 + k1 / 8.0) * dt)
    k3 = f(y0 + (-k1 / 2.0 + k2) * dt)
    k4 = f(y0 + (k0 * 3 / 16 + k3 * 9 / 16) * dt)
    k5 = f(y0 + (-k0 * 3 / 7 + k1 * 2 / 7 + k2 * 12 / 7 - k3 * 12 / 7 + k4 * 8 / 7) * dt)
    y = y0 + (7 * k0 + 32 * k2 + 12 * k3 + 32 * k4 + 7 * k5) * dt / 90.0
    qn = np.array([y[3], -y[0], -y[1], -y[2]])
    return qn / np.linalg.norm(qn)


@dataclasses.dataclass
class SyntheticWorld:
    """Full world state for image rendering / re-projection."""

    landmarks: np.ndarray   # (L, 3)
    q_seq: np.ndarray       # (n_imu+1, 4) full-rate attitude
    p_seq: np.ndarray       # (n_imu+1, 3)
    frame_idx: np.ndarray   # (T,) indices into the full-rate arrays


@dataclasses.dataclass
class SyntheticSequence:
    # packed frame inputs (numpy, host side)
    imu_omega: np.ndarray   # (T, K, 3)
    imu_acc: np.ndarray     # (T, K, 3)
    imu_dt: np.ndarray      # (T, K)
    tracked_uv: np.ndarray  # (T, F, 2)
    tracked_ids: np.ndarray # (T, F)
    tracked_valid: np.ndarray
    new_uv: np.ndarray
    new_ids: np.ndarray
    new_valid: np.ndarray
    time: np.ndarray        # (T,)
    # ground truth at frame times
    gt_p: np.ndarray        # (T, 3)
    gt_q: np.ndarray        # (T, 4)
    gt_v: np.ndarray        # (T, 3)
    # true biases
    b_g: np.ndarray
    b_a: np.ndarray
    # full-rate ground truth (for init)
    imu_gt_p: np.ndarray    # (T*K, 3)


def generate(
    config,
    n_frames: int = 200,
    seed: int = 0,
    pixel_noise: float = 1.0,       # in pixels (converted to normalized)
    gyro_noise: float = 0.0,        # rad/s white noise sigma (discrete)
    accel_noise: float = 0.0,       # m/s^2 white noise sigma (discrete)
    b_g=(0.002, -0.001, 0.0005),
    b_a=(0.02, -0.01, 0.015),
    n_landmarks: int = 800,
    traj_radius: float = 5.0,
    traj_omega: float = 0.35,       # rad/s around the loop
    return_world: bool = False,
) -> SyntheticSequence:
    """A loop trajectory inside a cylinder of landmarks, EuRoC-like rates."""
    rng = np.random.default_rng(seed)
    shp = config.shapes
    K = shp.imu_per_frame
    F = shp.max_features_per_frame
    dt = 0.005                     # 200 Hz IMU
    g = np.array([0.0, 0.0, -9.81])
    b_g = np.asarray(b_g, float)
    b_a = np.asarray(b_a, float)

    n_imu = n_frames * K

    # --- analytic angular velocity (body frame): slow yaw + small wobble ---
    t_imu = np.arange(n_imu) * dt
    omega_body = np.stack(
        [
            0.05 * np.sin(0.9 * t_imu),
            0.04 * np.sin(0.7 * t_imu + 1.0),
            traj_omega + 0.03 * np.sin(0.5 * t_imu),
        ],
        axis=-1,
    )

    # --- integrate attitude with the filter's own discrete scheme ---
    q = np.array([1.0, 0.0, 0.0, 0.0])
    q_seq = np.zeros((n_imu + 1, 4))
    q_seq[0] = q
    for k in range(n_imu):
        q = _integrate_rk5_np(q, omega_body[k], dt)
        q_seq[k + 1] = q

    # --- world acceleration for a circular-ish trajectory ---
    a_world = np.stack(
        [
            -traj_radius * traj_omega**2 * np.cos(traj_omega * t_imu),
            -traj_radius * traj_omega**2 * np.sin(traj_omega * t_imu),
            -0.2 * (1.4) ** 2 * np.sin(1.4 * t_imu),
        ],
        axis=-1,
    )
    v0 = np.array([0.0, traj_radius * traj_omega, 0.2 * 1.4])
    p0 = np.array([traj_radius, 0.0, 0.0])

    # discrete GT with the filter's Euler scheme (v then p with previous v)
    v_seq = np.zeros((n_imu + 1, 3))
    p_seq = np.zeros((n_imu + 1, 3))
    v_seq[0], p_seq[0] = v0, p0
    for k in range(n_imu):
        v_seq[k + 1] = v_seq[k] + a_world[k] * dt
        p_seq[k + 1] = p_seq[k] + v_seq[k] * dt

    # --- IMU measurements consistent with the filter model ---
    C_IG = _quat_rotmat_np(q_seq[:-1])      # (n_imu,3,3) global->IMU
    acc_meas = (
        np.einsum("nij,nj->ni", C_IG, a_world - g[None, :])
        + b_a[None, :]
        + rng.normal(size=(n_imu, 3)) * accel_noise
    )
    gyro_meas = omega_body + b_g[None, :] + rng.normal(size=(n_imu, 3)) * gyro_noise

    # --- landmarks on a cylinder around the loop + floor/ceiling ---
    theta = rng.uniform(0, 2 * np.pi, n_landmarks)
    r_land = traj_radius + rng.uniform(3.0, 6.0, n_landmarks)
    z_land = rng.uniform(-3.0, 3.0, n_landmarks)
    landmarks = np.stack([r_land * np.cos(theta), r_land * np.sin(theta), z_land], -1)

    # --- camera poses + projections at frame times ---
    cam_cfg = config.camera
    q_CI = np.asarray(cam_cfg.q_CI)
    p_C_I = np.asarray(cam_cfg.p_C_I)
    half_fov_u = cam_cfg.width / (2 * cam_cfg.f_u)
    half_fov_v = cam_cfg.height / (2 * cam_cfg.f_v)
    px_sigma = pixel_noise / cam_cfg.f_u

    frame_idx = (np.arange(n_frames) + 1) * K   # state after K-th imu sample
    tracked_uv = np.zeros((n_frames, F, 2))
    tracked_ids = np.full((n_frames, F), -1, np.int64)
    tracked_valid = np.zeros((n_frames, F), bool)
    new_uv = np.zeros((n_frames, F, 2))
    new_ids = np.full((n_frames, F), -1, np.int64)
    new_valid = np.zeros((n_frames, F), bool)

    lm_id = np.full(n_landmarks, -1, np.int64)      # current track id
    lm_active = np.zeros(n_landmarks, bool)
    next_id = 1

    for fi in range(n_frames):
        k = frame_idx[fi]
        q_IG = q_seq[k]
        p_I_G = p_seq[k]
        q_CG = _quat_mul_np(q_CI, q_IG)
        R_CG = _quat_rotmat_np(q_CG)
        R_IG = _quat_rotmat_np(q_IG)
        p_C_G = p_I_G + R_IG.T @ p_C_I

        rel = landmarks - p_C_G[None, :]
        p_f_C = rel @ R_CG.T
        z = p_f_C[:, 2]
        u = p_f_C[:, 0] / np.where(np.abs(z) < 1e-9, 1e-9, z)
        v = p_f_C[:, 1] / np.where(np.abs(z) < 1e-9, 1e-9, z)
        visible = (z > 0.5) & (z < 40.0) & (np.abs(u) < half_fov_u) & (np.abs(v) < half_fov_v)

        cont = visible & lm_active
        newly = visible & ~lm_active

        # feature budget: continuing first, then new
        cont_idx = np.flatnonzero(cont)[:F]
        n_cont = len(cont_idx)
        new_idx = np.flatnonzero(newly)[: F - n_cont]

        noise = rng.normal(size=(len(cont_idx), 2)) * px_sigma
        tracked_uv[fi, :n_cont] = np.stack([u[cont_idx], v[cont_idx]], -1) + noise
        tracked_ids[fi, :n_cont] = lm_id[cont_idx]
        tracked_valid[fi, :n_cont] = True

        ids_new = np.arange(next_id, next_id + len(new_idx))
        next_id += len(new_idx)
        lm_id[new_idx] = ids_new
        noise = rng.normal(size=(len(new_idx), 2)) * px_sigma
        new_uv[fi, : len(new_idx)] = np.stack([u[new_idx], v[new_idx]], -1) + noise
        new_ids[fi, : len(new_idx)] = ids_new
        new_valid[fi, : len(new_idx)] = True

        # active set: landmarks reported this frame stay tracked
        lm_active = np.zeros(n_landmarks, bool)
        lm_active[cont_idx] = True
        lm_active[new_idx] = True

    seq = SyntheticSequence(
        imu_omega=gyro_meas.reshape(n_frames, K, 3),
        imu_acc=acc_meas.reshape(n_frames, K, 3),
        imu_dt=np.full((n_frames, K), dt),
        tracked_uv=tracked_uv,
        tracked_ids=tracked_ids,
        tracked_valid=tracked_valid,
        new_uv=new_uv,
        new_ids=new_ids,
        new_valid=new_valid,
        time=frame_idx * dt,
        gt_p=p_seq[frame_idx],
        gt_q=q_seq[frame_idx],
        gt_v=v_seq[frame_idx],
        b_g=b_g,
        b_a=b_a,
        imu_gt_p=p_seq[1:],
    )
    if return_world:
        world = SyntheticWorld(
            landmarks=landmarks, q_seq=q_seq, p_seq=p_seq, frame_idx=frame_idx
        )
        return seq, world
    return seq


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the positions ``est`` (T, 3) against ``gt`` after the
    least-squares rigid alignment (Umeyama, no scale): a copy of the port's
    ``eval/ate.ate_rmse``."""
    est, gt = np.asarray(est, float), np.asarray(gt, float)
    e, g = est - est.mean(0), gt - gt.mean(0)
    U, _, Vt = np.linalg.svd(g.T @ e / est.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    aligned = (R @ est.T).T + (gt.mean(0) - R @ est.mean(0))
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))
