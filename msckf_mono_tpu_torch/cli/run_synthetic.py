#!/usr/bin/env python
"""Run a batched Monte-Carlo fleet on a synthetic sequence (port of ``msckf_mono_tpu/cli/run_synthetic.py``).

The offline-runner equivalent of the reference's datasets/asl_msckf.cpp for
the no-dataset case: generates a synthetic world, runs B filters (perturbed
inits with ``--perturb``) sharded over every visible card
(``parallel/sharding.make_mesh``, ``make_sharded_run``; under
``torch.distributed`` over the process group too), and reports ATE
statistics, throughput and the fleet's metrics. It runs on the card unless
``--cpu`` is given (a one-device CPU mesh); each shard's frame step replays
one captured CUDA graph a frame.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pixel-noise", type=float, default=0.5)
    ap.add_argument("--perturb", action="store_true", help="Monte-Carlo perturbed inits")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write trajectory .npz")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.eval.ate import ate_rmse, final_drift
    from msckf_mono_tpu_torch.parallel import montecarlo, sharding
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    device = torch.device("cpu" if args.cpu else "cuda")
    cfg = MsckfConfig()
    dtype = torch.float64 if args.f64 else torch.float32

    seq = synthetic.generate(cfg, n_frames=args.frames, seed=args.seed,
                             pixel_noise=args.pixel_noise)
    frames = synthetic.to_frame_inputs(seq, dtype, device=device)
    # init at the trajectory start (frame inputs begin after the first IMU block)
    imu = ground_truth_init(
        p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
        v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4],
        b_g=seq.b_g, b_a=seq.b_a, dtype=dtype, device=device,
    )

    sigmas = {} if args.perturb else dict(sigma_p=0, sigma_v=0, sigma_theta=0, sigma_bg=0, sigma_ba=0)
    # key 0, as the JAX package's CLI draws it: --seed seeds the world only
    states = montecarlo.make_fleet(cfg, imu, args.batch, dtype=dtype, device=device, **sigmas)
    batch_frames = montecarlo.broadcast_frames(frames, args.batch)

    mesh = sharding.make_mesh(["cpu"] if args.cpu else None)
    run = sharding.make_sharded_run(cfg, mesh)
    states = sharding.shard_batch(states, mesh)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, outs, metrics = run(states, batch_frames)
    est = outs.gather("cpu").p_I_G.numpy()  # (T, B, 3): this process's filters
    wall = time.perf_counter() - t0

    ates = [ate_rmse(est[:, b], seq.gt_p) for b in range(min(est.shape[1], 64))]
    drifts = [final_drift(est[:, b], seq.gt_p) for b in range(min(est.shape[1], 64))]

    report = {
        "batch": args.batch,
        "frames": args.frames,
        "wall_s": round(wall, 3),
        "frame_steps_per_s": round(args.batch * args.frames / wall, 1),
        "ate_mean": float(np.mean(ates)),
        "ate_p90": float(np.percentile(ates, 90)),
        "drift_mean": float(np.mean(drifts)),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    print(json.dumps(report, indent=2))

    if args.out:
        np.savez(args.out, est=est, gt=seq.gt_p, time=seq.time)
        print(f"wrote {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
