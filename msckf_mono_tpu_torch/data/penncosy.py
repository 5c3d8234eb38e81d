"""PennCOSYVIO dataset readers (port of ``msckf_mono_tpu/data/penncosy.py``).

The reference's PennCOSYVIO support is bit-rotted: the reader references a
removed type, the runner's filter section is commented out, and the build
target is disabled (reference datasets/penncosy_readers.cpp:192,
penncosy_msckf.cpp:43-123, CMakeLists.txt:108-109; README.md:58 lists it as
TODO). This module restores the capability against the layout the reference's
code actually encodes (penncosy_readers.h:36-75, penncosy_readers.cpp):

    <root>/data/<sensor_name>/<seq>/<csv_name>                 timestamps [s]
    <root>/data/<sensor_name>/<seq>/<cam_prefix>_cam_frames/frame_%04d.png
    <root>/data/<sensor_name>/<seq>/<cam_prefix>.yaml          OpenCV-style calib
    <root>/data/<sensor_name>/<seq>/imu.txt                    t ax ay az wx wy wz

Notes reproduced: camera q_BS is the INVERTED T_BS rotation
(penncosy_readers.cpp:35), IMU dT is hardcoded 1/200 s
(penncosy_readers.cpp:163), accel columns precede gyro (:195-203). The
reference's imu.yaml transform parse reads from an empty stream (another rot
artifact, :165-185); we default the IMU extrinsics to identity.

Output mirrors data/asl.py so downstream packing (data/sync.py) is shared.
"""

from __future__ import annotations

import os

import numpy as np

from msckf_mono_tpu_torch.data.asl import AslCamera, AslImu, _load_yaml, _quat_conj, _rotmat_to_quat_wxyz


def read_vi_camera(
    root: str, sensor_name: str, seq: str, csv_name: str = "left_cam.txt",
    cam_prefix: str = "left",
) -> AslCamera:
    base = os.path.join(root, "data", sensor_name, seq)
    cfg = _load_yaml(os.path.join(base, cam_prefix + ".yaml"))

    T = np.asarray(cfg["T_BS"]["data"], float).reshape(
        cfg["T_BS"]["rows"], cfg["T_BS"]["cols"]
    )
    q_BS = _quat_conj(_rotmat_to_quat_wxyz(T[:3, :3]))
    intr = cfg["intrinsics"]
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    res = cfg.get("resolution", [0, 0])

    times, files = [], []
    frames_dir = os.path.join(base, cam_prefix + "_cam_frames")
    with open(os.path.join(base, csv_name)) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            # round, don't truncate: second-denominated floats are ~0.1 ns
            # off after the f64 round-trip, and truncation would bias stamps
            # low and misalign the IMU-major bucketing
            times.append(round(float(line.split()[0]) * 1e9))
            # frame numbering is 1-based (penncosy_readers.cpp:103)
            files.append(os.path.join(frames_dir, f"frame_{i + 1:04d}.png"))

    return AslCamera(
        timestamps=np.asarray(times, np.int64),
        image_files=files,
        T_BS=T,
        q_BS=q_BS,
        p_BS=T[:3, 3],
        K=K,
        distortion_model=cfg.get("distortion_model", "radtan"),
        distortion_coeffs=np.asarray(cfg.get("distortion_coefficients", [0, 0, 0, 0]), float),
        width=int(res[0]),
        height=int(res[1]),
        rate_hz=float(cfg.get("rate_hz", 20.0)),
    )


def read_vi_imu(root: str, sensor_name: str, seq: str) -> AslImu:
    base = os.path.join(root, "data", sensor_name, seq)
    dT = 1.0 / 200.0  # hardcoded VI-sensor rate (penncosy_readers.cpp:163)
    ts, om, ac = [], [], []
    with open(os.path.join(base, "imu.txt")) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 7 or vals[0].startswith("#"):
                continue
            ts.append(round(float(vals[0]) * 1e9))  # see camera-reader note
            ac.append([float(v) for v in vals[1:4]])   # accel first
            om.append([float(v) for v in vals[4:7]])   # then gyro
    return AslImu(
        timestamps=np.asarray(ts, np.int64),
        omega=np.asarray(om, float),
        acc=np.asarray(ac, float),
        dT=dT,
        gyroscope_noise_density=0.0,
        gyroscope_random_walk=0.0,
        accelerometer_noise_density=0.0,
        accelerometer_random_walk=0.0,
    )


def read_sequence(root: str, sensor_name: str = "visensor", seq: str = "af"):
    """Full PennCOSYVIO sequence in the shared AslSequence shape.

    Completes the restoration the reference abandoned
    (reference datasets/penncosy_msckf.cpp:43-123 — MSCKF section
    commented out): the returned object drives the same packing/runner path
    as EuRoC (data/sync.py, cli/run_euroc.py --dataset pcv).

    Ground truth: PennCOSYVIO publishes tag-based GT separately from the
    sensor tree the reference's readers encode; if an ASL-format
    ``gt0/data.csv`` is present next to the sensor files (our writer emits
    one for synthetic fixtures) it is loaded, else gt is None.
    """
    from msckf_mono_tpu_torch.data.asl import AslSequence, read_ground_truth

    base = os.path.join(root, "data", sensor_name, seq)
    gt_dir = os.path.join(base, "gt0")
    return AslSequence(
        imu=read_vi_imu(root, sensor_name, seq),
        cam=read_vi_camera(root, sensor_name, seq),
        gt=read_ground_truth(gt_dir) if os.path.isdir(gt_dir) else None,
    )
