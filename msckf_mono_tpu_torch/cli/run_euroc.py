#!/usr/bin/env python
"""Offline EuRoC/ASL runner: dataset -> front-end -> filter -> ATE (port of ``msckf_mono_tpu/cli/run_euroc.py``).

The equivalent of the reference's datasets/asl_msckf.cpp (ground-truth
seeded init, asl_msckf.cpp:141-159) and asl_msckf_no_ground_truth.cpp
(standstill self-calibration) in one CLI: images stream through the
``TrackHandler`` (FAST and KLT kernels on the card), the filter runs one
step a frame at B = 1, and the run is scored by ATE/drift. It runs on the
card unless ``--cpu`` is given; there a frame's tracker and step replay one
captured CUDA graph from the second frame on (``interface.LiveFrame``), and
``--finish`` replays the graphed ``core/filter.finish``.

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
    from msckf_mono_tpu_torch.core.init import ground_truth_init, standstill_init
    from msckf_mono_tpu_torch.core.types import init_filter_state
    from msckf_mono_tpu_torch.data import asl, sync
    from msckf_mono_tpu_torch.eval.ate import ate_rmse, final_drift
    from msckf_mono_tpu_torch.frontend.track_handler import TrackHandler
    from msckf_mono_tpu_torch.interface import FRAME_OUTPUTS, LiveFrame, _unpack, frame_outputs, to_host
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
    live = LiveFrame(cfg, th, dtype, device)
    t_rel = (frame_ts - frame_ts[0]) / 1e9   # the device's clock: seconds since the first frame

    est = []
    map_accum = []     # cumulative map_ (msckf.h:50)
    pruned_accum = []  # pruned_states_ rows: [state_id, time, q(4), p(3)]
    t_start = time.perf_counter()
    # threaded decode-ahead: image decode overlaps with the device step
    prefetch = cam.prefetcher(n_threads=4, lookahead=16)
    for i, ts in enumerate(frame_ts):
        # the frame's IMU block (the first n rows; the padding carries dt = 0)
        # and image, staged and copied to the device, then the frame: the
        # tracker and the filter step, a replayed graph from the second frame
        n = int(np.count_nonzero(packed.dt[i] > 0))
        state, out = live(state, prefetch.get(frame_index_offset + i), packed.omega[i, :n],
                          packed.acc[i, :n], packed.dt[i, :n], i + 1, t_rel[i], ts / 1e9)
        # the frame's one device->host copy: the position and the archive
        # buffers (reference msckf.h:49-50; published asl_msckf.cpp:337-352
        # and :405-428)
        h = dict(zip(FRAME_OUTPUTS, _unpack(out.cpu().numpy(), frame_outputs(state, th))))
        est.append(h["p_I_G"])
        if h["map_mask"].any():
            map_accum.append(h["map_pts"][h["map_mask"]])
        if h["tri_map_mask"].any():
            map_accum.append(h["tri_map_pts"][h["tri_map_mask"]])
        pm = h["pruned_mask"]
        if pm.any():
            pruned_accum.append(np.concatenate([
                h["pruned_ids"][pm, None].astype(np.float64), h["pruned_time"][pm, None],
                h["pruned_q"][pm], h["pruned_p"][pm]], axis=1))
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
