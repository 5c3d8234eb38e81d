"""Sensor synchronization and packing (port of ``msckf_mono_tpu/data/sync.py``).

Replaces ``synchronizer::Synchronizer`` (reference include/datasets/
data_synchronizers.h:79-165) — a lazy min-time merge driving per-sample
callbacks — with an eager host-side packer: the full IMU stream is bucketed
between consecutive camera frames, padded to a fixed ``imu_per_frame`` budget
(dt=0 padding == identity propagation), producing the (T, ...) arrays the
per-frame filter step consumes. The reference's 10:1 (200 Hz / 20 Hz)
rate makes the padding negligible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from msckf_mono_tpu_torch.data.asl import AslSequence


@dataclasses.dataclass
class PackedImu:
    omega: np.ndarray  # (T, K, 3)
    acc: np.ndarray    # (T, K, 3)
    dt: np.ndarray     # (T, K)
    frame_times: np.ndarray  # (T,) seconds
    dropped: int       # samples beyond the K budget (counted, not silent)


def bucket_imu(
    imu_ts: np.ndarray,
    omega: np.ndarray,
    acc: np.ndarray,
    imu_dt: float,
    frame_ts: np.ndarray,
    imu_per_frame: int,
    start_ts=None,
) -> PackedImu:
    """Assign each IMU sample with t <= frame_i (and > frame_{i-1}) to frame i,
    mirroring the runner's drain-queue-until-image-stamp loop
    (reference src/ros_interface.cpp:83-90)."""
    T = len(frame_ts)
    K = imu_per_frame
    out_o = np.zeros((T, K, 3))
    out_a = np.zeros((T, K, 3))
    out_dt = np.zeros((T, K))
    dropped = 0

    prev = start_ts if start_ts is not None else -np.inf
    for i, ft in enumerate(frame_ts):
        sel = (imu_ts > prev) & (imu_ts <= ft)
        idx = np.flatnonzero(sel)
        if len(idx) > K:
            dropped += len(idx) - K
            idx = idx[-K:]
        n = len(idx)
        out_o[i, :n] = omega[idx]
        out_a[i, :n] = acc[idx]
        out_dt[i, :n] = imu_dt
        prev = ft

    return PackedImu(
        omega=out_o,
        acc=out_a,
        dt=out_dt,
        frame_times=frame_ts.astype(np.float64) / 1e9,
        dropped=dropped,
    )


def select_frames(seq: AslSequence, start_time_ns=None, max_frames=None):
    ts = seq.cam.timestamps
    if start_time_ns is not None:
        ts = ts[ts >= start_time_ns]
    if max_frames is not None:
        ts = ts[:max_frames]
    return ts


def closest_gt_index(gt_ts: np.ndarray, t_ns: int) -> int:
    return int(np.argmin(np.abs(gt_ts.astype(np.int64) - int(t_ns))))


def gt_at_frames(gt, frame_ts: np.ndarray):
    """Ground truth resampled at frame timestamps (nearest neighbor)."""
    idx = np.searchsorted(gt.timestamps, frame_ts)
    idx = np.clip(idx, 0, len(gt.timestamps) - 1)
    return gt.p[idx], gt.q[idx], gt.v[idx]
