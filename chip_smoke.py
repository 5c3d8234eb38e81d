#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msckf_mono_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 1024] [--frames 200]

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles csrc/psd_gamma.cu with nvcc for sm_90a (-Xptxas -v);
3. kernel: the gamma kernel against its plain PyTorch version on the card at
   R in {1, 13, 41, 53} (one lane set to -I must give +inf; NaN in the upper
   triangle must change nothing; R = 121 must raise), then times at the main
   path's shapes: the kernel, the plain version, the nearest library calls
   (cholesky_ex + solve_triangular), and the memory bound;
4. main path: the serving configuration of bench.py (fused updates, caps
   2/22, max_staged 8) on a 1024-filter fleet over the 200-frame synthetic
   sequence: make_fleet -> run_sequence -> fleet_metrics, with launch counts;
   then, from the fleet's state after frame 30, a profile of frames 30-32
   (device time by kernel, device-busy share) and a run of frames 30-33 that
   records every kernel launch's inputs and holds its gamma and gate
   decisions against the plain version on them.

The line before the last is a JSON object with the kernel's numbers; the last
line is {"ok": true, "device": {...}}. Without CUDA it exits non-zero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12      # H100 SXM f32 rate outside the tensor cores
# BENCH_r05.json (JAX package, 1024 filters x 200 frames): for reference only.
BENCH_R05 = {"ate_m": 0.2999, "residualized": 200704, "row_overflow": 8192,
             "staged_overflow": 59627}
ATE_GATE_M = 0.45            # bench.py:34
REPLACES = "msckf_mono_tpu/ops/psd_pallas.py:43"
SOURCE = "msckf_mono_tpu_torch/csrc/psd_gamma.cu"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    return name, smi


def phase_build():
    from msckf_mono_tpu_torch.ops import psd_cuda

    t0 = time.time()
    path = psd_cuda.build_library(verbose=True)
    psd_cuda._load()
    log(f"[build] {path.name} in {time.time() - t0:.2f} s")


def _make_systems(torch, rng, n, R):
    """As tests/test_psd_pallas.py::_make_systems: S = XXᵀ/R + 1e-5 I, r ~ N(0, I)."""
    X = torch.as_tensor(rng.normal(size=(n, R, R + 4)), device="cuda")
    S = X @ X.transpose(-1, -2) / R + 1e-5 * torch.eye(R, dtype=X.dtype, device="cuda")
    r = torch.as_tensor(rng.normal(size=(n, R)), device="cuda")
    return S.float().contiguous(), r.float().contiguous()


def _time_ms(torch, fn, reps=25):
    """Median of per-call CUDA-event times after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel(torch):
    from msckf_mono_tpu_torch.ops import psd_cuda
    from msckf_mono_tpu_torch.utils.chi2 import gate_threshold

    rng = np.random.default_rng(0)
    with_err = None
    try:
        psd_cuda.gamma_psd(torch.eye(121, device="cuda")[None], torch.ones(1, 121, device="cuda"))
    except RuntimeError as e:
        with_err = str(e)
    check(with_err is not None and "R=121" in with_err,
          f"R=121, whose block cannot fit in shared memory, gave {with_err!r}")
    # The launches below show that the failed one left no error behind.
    log(f"[kernel] R=121 raises: {with_err}")
    cases = [(1, 7), (1, 49152), (13, 7), (13, 8192), (41, 7), (41, 8192), (53, 7), (53, 8192)]
    worst = {}
    for R, n in cases:
        S, r = _make_systems(torch, rng, n, R)
        S[1] = -torch.eye(R, device="cuda")
        got = psd_cuda.gamma_psd(S, r)
        torch.cuda.synchronize()
        want = psd_cuda.gamma_psd_plain(S, r)
        upper = torch.triu(torch.ones(R, R, dtype=torch.bool, device="cuda"), diagonal=1)
        check(torch.equal(psd_cuda.gamma_psd(S.masked_fill(upper, float("nan")), r), got),
              f"R={R} n={n}: NaN in the upper triangle changed gamma")
        check(tuple(got.shape) == (n,), f"R={R} n={n}: output shape {tuple(got.shape)}")
        check(bool(torch.isposinf(got[1])), f"R={R}: indefinite lane gave {got[1].item()}")
        fin = torch.isfinite(want)
        check(torch.equal(torch.isfinite(got), fin), f"R={R} n={n}: finite lanes differ")
        rel = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)).max().item()
        abs_err = (got[fin] - want[fin]).abs().max().item()
        check(rel <= 1e-3, f"R={R} n={n}: max relative error {rel:.3e} > 1e-3")
        # The main path gates a track of R = 2m - 3 rows at dof = m - 1.
        thr = gate_threshold((R + 1) // 2, dtype=torch.float32, device="cuda")
        near = ((want - thr).abs() <= 1e-3 * thr) & fin
        same = (got < thr) == (want < thr)
        check(bool(torch.all(same)), f"R={R} n={n}: gate decisions differ on "
              f"{int((~same).sum())} lanes")
        log(f"[kernel] R={R:2d} n={n:5d}: max rel err {rel:.2e}, max abs err {abs_err:.3e}, "
            f"gate decisions identical on {n}/{n} lanes ({int((want < thr).sum())} pass; "
            f"{int(near.sum())} within 1e-3 of the threshold), indefinite lane +inf, "
            f"upper triangle unused")
        worst[(R, n)] = abs_err

    per_shape = []
    for R, n, where in ((41, 8192, "marginalize"), (1, 49152, "prune")):
        S, r = _make_systems(torch, rng, n, R)
        ms = _time_ms(torch, lambda: psd_cuda.gamma_psd(S, r))
        plain_ms = _time_ms(torch, lambda: psd_cuda.gamma_psd_plain(S, r))

        def library():
            L, _ = torch.linalg.cholesky_ex(S)
            return torch.linalg.solve_triangular(L, r[..., None], upper=False)

        library_ms = _time_ms(torch, library)
        # The function needs the lower triangle of S and r, read once, and
        # writes gamma once.
        nbytes = n * (R * (R + 1) // 2 + R) * 4 + n * 4
        flops = n * (R ** 3 / 3.0 + R ** 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        shape = dict(R=R, n=n, stage=where, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     max_abs_err=worst[(R, n)])
        per_shape.append(shape)
        log(f"[kernel] {where} shape R={R} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {shape['bound_ms']:.4f} ms "
            f"({shape['bound_by']}; {nbytes / 1e6:.1f} MB)")
    return per_shape


def serving_config(batch):
    """bench.py:123-164's serving configuration at this batch size."""
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    cfg = MsckfConfig()
    pchunk = 48 if batch <= 1024 else {2048: 24, 4096: 12}.get(batch, 6)
    return dataclasses.replace(
        cfg,
        filter=dataclasses.replace(cfg.filter, fused_updates=True, gating_precision="high"),
        shapes=dataclasses.replace(cfg.shapes, staged_chunk=max(2, 8192 // batch),
                                   max_staged=8, prune_obs_cap=2, marg_obs_cap=22,
                                   prune_chunk=pchunk),
    )


def phase_main(torch, batch, frames):
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.eval.ate import ate_rmse
    from msckf_mono_tpu_torch.ops import psd_cuda
    from msckf_mono_tpu_torch.parallel import montecarlo, sharding

    cfg = serving_config(batch)
    seq = synthetic.generate(cfg, n_frames=frames, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device="cuda")
    frames_dev = montecarlo.broadcast_frames(
        synthetic.to_frame_inputs(seq, torch.float32, device="cuda"), batch)
    run = sharding.batched_run_sequence(cfg)
    make = lambda: montecarlo.make_fleet(cfg, imu, batch, torch.Generator().manual_seed(0),
                                         dtype=torch.float32, device="cuda")

    # Warm-up on two frames (library handles, allocator), outside the count.
    warm = tree_map(lambda x: x[:2], frames_dev)
    run(make(), warm)
    states = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    psd_cuda.gamma_psd.launches = 0
    t0 = time.perf_counter()
    final, outs = run(states, frames_dev)
    metrics = sharding.fleet_metrics(final)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = psd_cuda.gamma_psd.launches

    est = outs.p_I_G.cpu().numpy()                       # (T, B, 3)
    check(np.all(np.isfinite(est)), "non-finite trajectory")
    ate0 = ate_rmse(est[:, 0], seq.gt_p)
    m = {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[main] serving config, {batch} filters x {frames} frames, f32 on cuda: "
        f"{seconds:.2f} s, {batch * frames / seconds:.1f} frame-steps/s, "
        f"peak memory {peak:.2f} GiB")
    log(f"[main] ATE(filter 0) {ate0:.4f} m (BENCH_r05 {BENCH_R05['ate_m']}); "
        f"residualized {int(m['total_residualized'])} ({BENCH_R05['residualized']}), "
        f"row_overflow {int(m['total_row_overflow'])} ({BENCH_R05['row_overflow']}), "
        f"staged_overflow {int(m['total_staged_overflow'])} ({BENCH_R05['staged_overflow']}); "
        f"gamma kernel launches {launches} over {frames} steps")
    check(ate0 < ATE_GATE_M, f"ATE {ate0:.4f} m >= {ATE_GATE_M} m")
    check(launches == 2 * frames, f"{launches} gamma launches, expected {2 * frames}")
    # Mid-sequence frames, the window full: the state after frame `lo` goes on
    # with frames lo, lo + 1, ... as in the main run.
    lo = min(30, frames // 2)
    mid, _ = run(make(), tree_map(lambda x: x[:lo], frames_dev))
    phase_profile(torch, run, mid, tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames_dev),
                  1e3 * seconds / frames)
    phase_gate(torch, cfg, run, mid, tree_map(lambda x: x[lo:lo + GATE_FRAMES], frames_dev))
    return launches


PROFILE_FRAMES = 3
GATE_FRAMES = 4


def phase_gate(torch, cfg, run, state, frames):
    """The kernel against its plain version on the main path's own inputs:
    every launch of a few fleet frames records its (S, r) and its gamma, and
    every gate its dof; afterwards gamma_psd_plain runs on the recorded
    inputs, and its gamma and gate decisions must match the kernel's."""
    from msckf_mono_tpu_torch.core import update
    from msckf_mono_tpu_torch.ops import psd_cuda
    from msckf_mono_tpu_torch.utils.chi2 import gate_threshold

    gate, kernel = update.gating_test_all, psd_cuda.gamma_psd
    launches, dofs = [], []

    def record_launch(Smat, r):
        gamma = kernel(Smat, r)
        launches.append((Smat, r, gamma))
        return gamma

    def record_dof(H_all, r_all, P, dof, *args):
        dofs.append(dof)
        return gate(H_all, r_all, P, dof, *args)

    before = kernel.launches
    psd_cuda.gamma_psd, update.gating_test_all = record_launch, record_dof
    try:
        run(state, frames)
    finally:
        psd_cuda.gamma_psd, update.gating_test_all = kernel, gate
    n_frames = frames.time.shape[0]
    check(len(launches) == len(dofs) == kernel.launches - before == 2 * n_frames,
          f"{len(launches)} kernel calls, {kernel.launches - before} launches and "
          f"{len(dofs)} gates recorded over {n_frames} frames")
    by_rows = {}
    for (Smat, r, got), dof in zip(launches, dofs):
        want = psd_cuda.gamma_psd_plain(Smat, r)
        thr = gate_threshold(dof, reproduce_offbyone=cfg.filter.chi2_offbyone,
                             dtype=torch.float32)
        fin = torch.isfinite(want)
        check(torch.equal(torch.isfinite(got), fin), f"R={r.shape[-1]}: finite lanes differ")
        rel = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)).max().item() \
            if bool(fin.any()) else 0.0
        held = (r != 0).any(-1)
        acc = by_rows.setdefault(r.shape[-1], dict(calls=0, lanes=0, same=0, held=0, passed=0,
                                                   rel=0.0, shape=tuple(Smat.shape)))
        acc["calls"] += 1
        acc["lanes"] += got.numel()
        acc["same"] += int(((got < thr) == (want < thr)).sum())
        acc["held"] += int(held.sum())
        acc["passed"] += int(((want < thr) & held).sum())
        acc["rel"] = max(acc["rel"], rel)
    for rows, a in sorted(by_rows.items(), reverse=True):
        log(f"[gate] R={rows:2d}, {a['calls']} launches on S {a['shape']}: max rel err "
            f"{a['rel']:.2e}; decisions identical on {a['same']}/{a['lanes']} lanes; "
            f"{a['held']} lanes hold rows, {a['passed']} of them pass")
        check(a["rel"] <= 1e-3, f"R={rows}: max relative error {a['rel']:.3e} > 1e-3")
        check(a["same"] == a["lanes"], f"R={rows}: gate decisions differ on "
              f"{a['lanes'] - a['same']} lanes")
        check(a["held"] > 0, f"R={rows}: no lane held rows")


def phase_profile(torch, run, state, frames, frame_ms):
    """Where a frame's time goes: device time by kernel over a few frames of
    the fleet, and the device's busy share of a frame. The profiler slows the
    host, so the busy share is taken against ``frame_ms``, the unprofiled
    frame time of the main run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    busy = busy_ms / PROFILE_FRAMES
    log(f"[profile] {PROFILE_FRAMES} frames under the profiler: wall {wall_ms:.1f} ms, "
        f"{len(kernels) / PROFILE_FRAMES:.0f} device ops/frame, device busy {busy:.2f} ms/frame "
        f"= {100 * busy / frame_ms:.1f}% of the unprofiled {frame_ms:.2f} ms/frame")
    rows = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    for a in rows[:15]:
        log(f"[profile]   {a.self_device_time_total / 1e3 / PROFILE_FRAMES:9.3f} ms/frame "
            f"{a.count / PROFILE_FRAMES:8.1f} calls/frame  {a.key[:90]}")


def _union_ms(spans):
    """Length of the union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    name, _ = phase_device(torch)
    phase_build()
    per_shape = phase_kernel(torch)
    launches = phase_main(torch, args.batch, args.frames)

    kernel = {
        "name": "psd_gamma", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        # One frame step launches the kernel once at each main-path shape.
        "ms": sum(s["ms"] for s in per_shape),
        "plain_ms": sum(s["plain_ms"] for s in per_shape),
        "bound_ms": sum(s["bound_ms"] for s in per_shape),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in per_shape) else "operations",
        "library_ms": sum(s["library_ms"] for s in per_shape),
        "per_shape": per_shape,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
