"""Write a SyntheticWorld as an on-disk ASL/EuRoC dataset tree (port of ``msckf_mono_tpu/data/write_asl.py``).

Produces the exact layout the readers (data/asl.py, mirroring the
reference's datasets/asl_readers.cpp) consume:

    <root>/cam0/sensor.yaml, data.csv, data/<ts>.png   (rendered frames)
    <root>/imu0/sensor.yaml, data.csv
    <root>/state_groundtruth_estimate0/data.csv

This gives the full dataset->CLI path (native CSV parse, PNG decode,
prefetch, sync, front-end, filter, ATE) a self-contained integration fixture
— the deterministic stand-in for EuRoC sequences when none are on disk.

Convention round-trip: the reader inverts T_BS's rotation
(asl_readers.cpp:32) and converts GT with v <- q*v, q <- q^-1
(asl_readers.cpp:335-336), so this writer emits R_BS = R(q_CI)^T,
q_csv = conj(q_IG) and v_csv = C_IG·v_world — reading the tree back yields
exactly the synthetic ground truth.
"""

from __future__ import annotations

import os

import numpy as np

from msckf_mono_tpu_torch.data import png, render
from msckf_mono_tpu_torch.data.synthetic import (
    SyntheticSequence,
    SyntheticWorld,
    _quat_rotmat_np,
)
from msckf_mono_tpu_torch.utils.config import MsckfConfig

IMU_DT_NS = 5_000_000  # 200 Hz


def write_sequence(
    root: str,
    config: MsckfConfig,
    seq: SyntheticSequence,
    world: SyntheticWorld,
    t0_ns: int = 1_000_000_000_000,
    gt_stride: int = 1,
) -> dict:
    """Write the dataset; returns {'t0_ns', 'frame_ts'} for driving the CLI."""
    cam_cfg = config.camera
    K_rate = seq.imu_omega.shape[1]
    n_frames = seq.time.shape[0]
    n_imu = n_frames * K_rate

    # ---- cam0 ----
    cam_dir = os.path.join(root, "cam0")
    os.makedirs(os.path.join(cam_dir, "data"), exist_ok=True)
    R_CI = _quat_rotmat_np(np.asarray(cam_cfg.q_CI))
    T_BS = np.eye(4)
    T_BS[:3, :3] = R_CI.T  # reader conjugates back to q_CI
    T_BS[:3, 3] = np.asarray(cam_cfg.p_C_I)
    _write_yaml_cam(os.path.join(cam_dir, "sensor.yaml"), cam_cfg, T_BS)

    frame_ts = t0_ns + (world.frame_idx.astype(np.int64) * IMU_DT_NS)
    lines = ["#timestamp [ns],filename"]
    for fi, ts in enumerate(frame_ts):
        img = render.render_frame(config, world, fi).astype(np.uint8)
        fn = f"{ts}.png"
        png.write(os.path.join(cam_dir, "data", fn), img)
        lines.append(f"{ts},{fn}")
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")

    # ---- imu0 ----
    # reading k integrates the state over (k·dt, (k+1)·dt]; stamping it at the
    # interval END makes drain-until-image-stamp bucketing assign readings
    # fi·K..fi·K+K-1 to frame fi exactly.
    imu_dir = os.path.join(root, "imu0")
    os.makedirs(imu_dir, exist_ok=True)
    _write_yaml_imu(os.path.join(imu_dir, "sensor.yaml"))
    omega = seq.imu_omega.reshape(n_imu, 3)
    acc = seq.imu_acc.reshape(n_imu, 3)
    rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
    for k in range(n_imu):
        ts = t0_ns + (k + 1) * IMU_DT_NS
        rows.append(
            f"{ts}," + ",".join(repr(float(v)) for v in (*omega[k], *acc[k]))
        )
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")

    # ---- ground truth (full state rate) ----
    gt_dir = os.path.join(root, "state_groundtruth_estimate0")
    write_gt_csv(gt_dir, seq, world, n_imu, t0_ns, gt_stride)

    return {"t0_ns": t0_ns, "frame_ts": frame_ts}


def write_gt_csv(gt_dir, seq, world, n_imu, t0_ns, gt_stride=1):
    """ASL-format GT csv in the reader's conventions (asl_readers.cpp:335-336).

    Discrete GT velocity from the synthetic integrator: v_seq is not stored
    in SyntheticSequence at full rate, so recover v from p differencing
    (p_{k+1} = p_k + v_k dt) -> v_k = (p_{k+1} - p_k)/dt.
    """
    os.makedirs(gt_dir, exist_ok=True)
    p_seq = world.p_seq
    q_seq = world.q_seq
    dt = IMU_DT_NS * 1e-9
    v_seq = np.zeros_like(p_seq)
    v_seq[:-1] = (p_seq[1:] - p_seq[:-1]) / dt
    v_seq[-1] = v_seq[-2]

    rows = [
        "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,"
        "b_w_x,b_w_y,b_w_z,b_a_x,b_a_y,b_a_z"
    ]
    b_g, b_a = seq.b_g, seq.b_a
    for k in range(0, n_imu + 1, gt_stride):
        ts = t0_ns + k * IMU_DT_NS
        q_IG = q_seq[k]
        q_csv = q_IG * np.array([1.0, -1.0, -1.0, -1.0])  # reader re-inverts
        C_IG = _quat_rotmat_np(q_IG)
        v_csv = C_IG @ v_seq[k]  # reader rotates back with q_csv
        p = p_seq[k]
        rows.append(
            f"{ts}," + ",".join(repr(float(v)) for v in (*p, *q_csv, *v_csv, *b_g, *b_a))
        )
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _write_yaml_cam(path, cam_cfg, T_BS):
    data = ", ".join(repr(float(v)) for v in T_BS.reshape(-1))
    dist = ", ".join(repr(float(v)) for v in cam_cfg.distortion_coeffs)
    with open(path, "w") as f:
        f.write(
            f"""%YAML:1.0
sensor_type: camera
comment: synthetic ASL fixture (msckf_mono_tpu_torch.data.write_asl)
T_BS:
  rows: 4
  cols: 4
  data: [{data}]
rate_hz: 20
resolution: [{cam_cfg.width}, {cam_cfg.height}]
camera_model: pinhole
intrinsics: [{cam_cfg.f_u!r}, {cam_cfg.f_v!r}, {cam_cfg.c_u!r}, {cam_cfg.c_v!r}]
distortion_model: {cam_cfg.distortion_model}
distortion_coefficients: [{dist}]
"""
        )


def _write_yaml_imu(path):
    with open(path, "w") as f:
        f.write(
            """%YAML:1.0
sensor_type: imu
comment: synthetic ASL fixture
T_BS:
  rows: 4
  cols: 4
  data: [1.0,0.0,0.0,0.0, 0.0,1.0,0.0,0.0, 0.0,0.0,1.0,0.0, 0.0,0.0,0.0,1.0]
rate_hz: 200
gyroscope_noise_density: 1.6968e-04
gyroscope_random_walk: 1.9393e-05
accelerometer_noise_density: 2.0000e-3
accelerometer_random_walk: 3.0000e-3
"""
        )
