"""Write a SyntheticWorld as an on-disk PennCOSYVIO dataset tree (port of ``msckf_mono_tpu/data/write_penncosy.py``).

Produces the layout the restored readers (data/penncosy.py, from
the reference's include/datasets/penncosy_readers.h:36-75) consume:

    <root>/data/<sensor>/<seq>/left.yaml                 OpenCV-style calib
    <root>/data/<sensor>/<seq>/left_cam.txt              timestamps [s]
    <root>/data/<sensor>/<seq>/left_cam_frames/frame_%04d.png
    <root>/data/<sensor>/<seq>/imu.txt                   t ax ay az wx wy wz
    <root>/data/<sensor>/<seq>/gt0/data.csv              (extension, ASL format)

The gt0 dir is our evaluation extension: PennCOSYVIO's tag-based ground truth
lives outside the sensor tree the reference encodes, so synthetic fixtures
carry it in the ASL format the shared reader already parses.
"""

from __future__ import annotations

import os

import numpy as np

from msckf_mono_tpu_torch.data import png, render
from msckf_mono_tpu_torch.data.synthetic import SyntheticSequence, SyntheticWorld, _quat_rotmat_np
from msckf_mono_tpu_torch.data.write_asl import IMU_DT_NS, write_gt_csv
from msckf_mono_tpu_torch.utils.config import MsckfConfig


def write_sequence(
    root: str,
    config: MsckfConfig,
    seq: SyntheticSequence,
    world: SyntheticWorld,
    sensor_name: str = "visensor",
    seq_name: str = "af",
    t0_ns: int = 1_000_000_000_000,
) -> dict:
    cam_cfg = config.camera
    K_rate = seq.imu_omega.shape[1]
    n_frames = seq.time.shape[0]
    n_imu = n_frames * K_rate
    base = os.path.join(root, "data", sensor_name, seq_name)
    frames_dir = os.path.join(base, "left_cam_frames")
    os.makedirs(frames_dir, exist_ok=True)

    # ---- left.yaml (penncosy_readers.cpp:20-60 layout) ----
    R_CI = _quat_rotmat_np(np.asarray(cam_cfg.q_CI))
    T_BS = np.eye(4)
    T_BS[:3, :3] = R_CI.T  # reader conjugates back to q_CI
    T_BS[:3, 3] = np.asarray(cam_cfg.p_C_I)
    data = ",\n         ".join(
        ", ".join(repr(float(v)) for v in row) for row in T_BS
    )
    dist = ", ".join(repr(float(v)) for v in cam_cfg.distortion_coeffs)
    with open(os.path.join(base, "left.yaml"), "w") as f:
        f.write(
            f"""%YAML:1.0
T_BS:
  rows: 4
  cols: 4
  data: [{data}]
rate_hz: 20
resolution: [{cam_cfg.width}, {cam_cfg.height}]
intrinsics: [{cam_cfg.f_u!r}, {cam_cfg.f_v!r}, {cam_cfg.c_u!r}, {cam_cfg.c_v!r}]
distortion_model: {cam_cfg.distortion_model}
distortion_coefficients: [{dist}]
"""
        )

    # ---- frames + left_cam.txt (1-based frame numbering, readers.cpp:103) ----
    frame_ts = t0_ns + (world.frame_idx.astype(np.int64) * IMU_DT_NS)
    lines = []
    for fi, ts in enumerate(frame_ts):
        img = render.render_frame(config, world, fi).astype(np.uint8)
        png.write(os.path.join(frames_dir, f"frame_{fi + 1:04d}.png"), img)
        lines.append(f"{ts / 1e9:.9f}")
    with open(os.path.join(base, "left_cam.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    # ---- imu.txt: accel columns precede gyro (readers.cpp:195-203) ----
    omega = seq.imu_omega.reshape(n_imu, 3)
    acc = seq.imu_acc.reshape(n_imu, 3)
    rows = []
    for k in range(n_imu):
        ts = (t0_ns + (k + 1) * IMU_DT_NS) / 1e9
        rows.append(
            f"{ts:.9f} " + " ".join(repr(float(v)) for v in (*acc[k], *omega[k]))
        )
    with open(os.path.join(base, "imu.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")

    # ---- gt (evaluation extension) ----
    write_gt_csv(os.path.join(base, "gt0"), seq, world, n_imu, t0_ns)

    return {"t0_ns": t0_ns, "frame_ts": frame_ts}
