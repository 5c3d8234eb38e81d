#!/usr/bin/env python
"""Offline EuRoC/ASL runner: dataset -> front-end -> filter -> ATE (port of ``msckf_mono_tpu/cli/run_euroc.py``).

The equivalent of the reference's datasets/asl_msckf.cpp (ground-truth
seeded init, asl_msckf.cpp:141-159) and asl_msckf_no_ground_truth.cpp
(standstill self-calibration) in one CLI: images stream through the
``TrackHandler`` (FAST and KLT kernels on the card), the filter runs one
step a frame at B = 1, and the run is scored by ATE/drift. It runs on the
card unless ``--cpu`` is given.

Usage:
  python -m msckf_mono_tpu_torch.cli.run_euroc --data /path/to/MH_03_medium/mav0 \
      --stand-still-end 1403637129.5 [--max-frames 500] [--init standstill] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="asl: .../<sequence>/mav0;  pcv: the dataset root")
    ap.add_argument("--dataset", choices=["asl", "pcv"], default="asl",
                    help="asl = EuRoC layout; pcv = PennCOSYVIO layout "
                         "(the runner the reference abandoned, "
                         "penncosy_msckf.cpp:43-123)")
    ap.add_argument("--pcv-sensor", default="visensor")
    ap.add_argument("--pcv-seq", default="af")
    ap.add_argument("--stand-still-end", type=float, default=None,
                    help="end of the standstill window, seconds (unix epoch)")
    ap.add_argument("--init", choices=["gt", "standstill"], default="gt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--finish", action="store_true",
                    help="final residualization of all live tracks (msckf.h:765-807)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.core.filter import FrameInput
    from msckf_mono_tpu_torch.core.init import ground_truth_init, standstill_init
    from msckf_mono_tpu_torch.core.types import init_filter_state
    from msckf_mono_tpu_torch.data import asl, sync
    from msckf_mono_tpu_torch.eval.ate import ate_rmse, final_drift
    from msckf_mono_tpu_torch.frontend.track_handler import TrackHandler
    from msckf_mono_tpu_torch.interface import _budget, to_host
    from msckf_mono_tpu_torch.utils import quat as quat_ops
    from msckf_mono_tpu_torch.utils.config import CameraConfig, MsckfConfig

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float32
    if args.dataset == "pcv":
        from msckf_mono_tpu_torch.data import penncosy

        seq = penncosy.read_sequence(args.data, args.pcv_sensor, args.pcv_seq)
    else:
        seq = asl.read_sequence(args.data)
    cam = seq.cam

    # camera config from the dataset calibration (ros_interface.cpp:250-274)
    cfg = MsckfConfig(
        camera=CameraConfig(
            f_u=float(cam.K[0, 0]), f_v=float(cam.K[1, 1]),
            c_u=float(cam.K[0, 2]), c_v=float(cam.K[1, 2]),
            q_CI=tuple(cam.q_BS), p_C_I=tuple(cam.p_BS),
            width=cam.width, height=cam.height,
            distortion_model=cam.distortion_model,
            distortion_coeffs=tuple(cam.distortion_coeffs),
        )
    )

    ss_end_ns = int(args.stand_still_end * 1e9) if args.stand_still_end else (
        int(seq.imu.timestamps[0]) + 2_000_000_000
    )

    # --- init (asl_msckf.cpp:141-159 / asl_msckf_no_ground_truth.cpp:141-173) ---
    if args.init == "gt" and seq.gt is not None:
        gi = sync.closest_gt_index(seq.gt.timestamps, ss_end_ns)
        imu0 = ground_truth_init(
            p_I_G=seq.gt.p[gi], q_IG=seq.gt.q[gi], v_I_G=seq.gt.v[gi],
            b_g=seq.gt.b_g[gi], b_a=seq.gt.b_a[gi], dtype=dtype, device=device,
        )
    else:
        mask = seq.imu.timestamps < ss_end_ns
        imu0 = standstill_init(seq.imu.omega[mask], seq.imu.acc[mask], dtype=dtype, device=device)

    # --- pack sensors ---
    frame_ts = sync.select_frames(seq, start_time_ns=ss_end_ns, max_frames=args.max_frames)
    frame_index_offset = int(np.searchsorted(cam.timestamps, frame_ts[0]))
    packed = sync.bucket_imu(
        seq.imu.timestamps, seq.imu.omega, seq.imu.acc, seq.imu.dT,
        frame_ts, cfg.shapes.imu_per_frame, start_ts=ss_end_ns,
    )
    if packed.dropped:
        print(f"warning: {packed.dropped} IMU samples over the per-frame budget", file=sys.stderr)

    th = TrackHandler(
        cam.K, cam.distortion_coeffs, cam.distortion_model,
        n_grid_rows=10, n_grid_cols=10, max_features=100,
        # the repository's one shipped KLT window: 21 px / 4 levels
        # (KLT_WINDOW_AB.json)
        window_size=21, max_level=3, dtype=dtype, device=device,
    )

    state = init_filter_state(cfg, imu0, dtype=dtype, device=device)
    F = cfg.shapes.max_features_per_frame
    K = cfg.shapes.imu_per_frame
    q_CI = torch.as_tensor(cfg.camera.q_CI, dtype=dtype, device=device)
    # The whole IMU stream on the device in one copy: per frame, (omega, acc,
    # dt) and the state id and time (seconds since the first frame: f32 ULP at
    # an epoch stamp of ~1.4e9 s is ~128 s; absolute times are rebuilt on the
    # host in f64 from state_id at export).
    T = len(frame_ts)
    host = np.concatenate([packed.omega.reshape(T, -1), packed.acc.reshape(T, -1), packed.dt,
                           np.arange(1, T + 1)[:, None], ((frame_ts - frame_ts[0]) / 1e9)[:, None]],
                          axis=1)
    dev_in = torch.as_tensor(host, device=device)
    omega_all = dev_in[:, : 3 * K].reshape(T, 1, K, 3)
    acc_all = dev_in[:, 3 * K: 6 * K].reshape(T, 1, K, 3).to(dtype)
    dt_all = dev_in[:, 6 * K: 7 * K].reshape(T, 1, K)
    sid_all = dev_in[:, 7 * K].to(torch.int32)
    time_all = dev_in[:, 7 * K + 1].to(dtype)
    valid = torch.ones((1,), dtype=torch.bool, device=device)

    est = []
    map_accum = []     # cumulative map_ (msckf.h:50)
    pruned_accum = []  # pruned_states_ rows: [state_id, time, q(4), p(3)]
    t_start = time.perf_counter()
    # threaded decode-ahead: image decode overlaps with the device step
    prefetch = cam.prefetcher(n_threads=4, lookahead=16)
    for i, ts in enumerate(frame_ts):
        img = torch.as_tensor(prefetch.get(frame_index_offset + i), device=device).to(dtype)

        # this frame's gyro readings (the first n of the block; the padding
        # carries dt = 0) less the current bias estimate, into the camera
        # frame, as one op
        n = int(np.count_nonzero(packed.dt[i] > 0))
        if n:
            w = (omega_all[i, 0, :n] - state.imu.b_g).to(dtype)
            th.add_gyro_reading(quat_ops.rotate(q_CI, w))

        th.set_current_image(img, ts / 1e9)
        t_uv, t_ids, t_valid = th.tracked_features()
        n_uv, n_ids, n_valid = th.new_features()
        tb, nb = _budget(t_uv, t_ids, t_valid, F, dtype), _budget(n_uv, n_ids, n_valid, F, dtype)

        frame = FrameInput(
            imu_omega=omega_all[i].to(dtype), imu_acc=acc_all[i], imu_dt=dt_all[i].to(dtype),
            tracked_uv=tb[0], tracked_ids=tb[1], tracked_valid=tb[2],
            new_uv=nb[0], new_ids=nb[1], new_valid=nb[2],
            state_id=sid_all[i:i + 1], time=time_all[i:i + 1], frame_valid=valid,
        )
        state, _ = msckf_filter.step(state, frame, cfg)
        # the frame's one device->host copy: the position and the archive
        # buffers (reference msckf.h:49-50; published asl_msckf.cpp:337-352
        # and :405-428)
        p, m, mp, tm, tp, pm, pid, pt, pq, pp = to_host(
            [state.imu.p_I_G[0], state.map_mask[0], state.map_pts[0], state.tri_map_mask[0],
             state.tri_map_pts[0], state.pruned_mask[0], state.pruned_ids[0],
             state.pruned_time[0], state.pruned_q[0], state.pruned_p[0]])
        est.append(p)
        if m.any():
            map_accum.append(mp[m])
        if tm.any():
            map_accum.append(tp[tm])
        if pm.any():
            pruned_accum.append(np.concatenate([
                pid[pm, None].astype(np.float64), pt[pm, None], pq[pm], pp[pm]], axis=1))
        if i % 100 == 0:
            print(f"frame {i}/{len(frame_ts)}", file=sys.stderr)

    prefetch.close()
    if args.finish:
        state, fpts, fmask = msckf_filter.finish(state, cfg, collect_map=True)
        p, fm, fp = to_host([state.imu.p_I_G[0], fmask[0], fpts[0]])
        est[-1] = p
        if fm.any():
            map_accum.append(fp[fm])

    wall = time.perf_counter() - t_start
    est = np.asarray(est)

    report = {"frames": len(frame_ts), "wall_s": round(wall, 2),
              "fps": round(len(frame_ts) / wall, 2)}
    if seq.gt is not None:
        gt_p, _, _ = sync.gt_at_frames(seq.gt, frame_ts)
        report["ate_rmse"] = ate_rmse(est, gt_p)
        report["final_drift"] = final_drift(est, gt_p)
    print(json.dumps(report, indent=2))

    if args.out:
        map_pts = (np.concatenate(map_accum) if map_accum else np.zeros((0, 3), np.float32))
        pruned = (np.concatenate(pruned_accum) if pruned_accum else np.zeros((0, 9)))
        pruned = pruned[np.argsort(pruned[:, 0], kind="stable")]
        pruned_ids = pruned[:, 0].astype(np.int32)
        # Exact float64 absolute stamps, rebuilt from state_id via the host
        # frame_ts array (state_id = frame index + 1); the f32 device buffer
        # only carries seconds since the start.
        pruned_time = (frame_ts[np.clip(pruned_ids - 1, 0, len(frame_ts) - 1)] / 1e9
                       if len(pruned_ids) else pruned[:, 1])
        np.savez(
            args.out, est=est, time=frame_ts / 1e9,
            map=map_pts,                     # cumulative map_ (msckf.h:820-823)
            pruned_state_id=pruned_ids,
            pruned_time=pruned_time,
            pruned_q_CG=pruned[:, 2:6],      # pruned path (msckf.h:840-848)
            pruned_p_C_G=pruned[:, 6:9],
        )
    return report


if __name__ == "__main__":
    main()
