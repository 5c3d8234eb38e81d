#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msckf_mono_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 1024] [--frames 200]

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. [device]: the card's name, and its name and power limit from nvidia-smi;
2. [build]: compiles csrc/{psd_gamma,fast_nms,klt_level}.cu with nvcc for
   sm_90a (-Xptxas -v), one nvcc process per source, all at once (or reuses
   the libraries and their nvcc reports from an earlier build), and prints
   every kernel instance's registers, stack frame and spills; then the
   launchers' plans for R in 1..400 and windows 3..151, each within the
   card's shared memory a block;
3. [kernel]: the gamma kernel against its plain PyTorch version on the card at
   R in {1, 2, 3, 13, 41, 53, 121, 200} and at R = 345, above what a block's
   shared memory holds (the device-memory scratch variant): within 1e-3
   relative, identical gate decisions, one lane set to -I gives +inf, NaN in
   the upper triangle changes nothing; then times at the filter path's and
   the image path's shapes: the kernel (one call, and device time), the
   plain version, the nearest library calls (cholesky_ex + solve_triangular),
   and the memory bound;
4. [main], [profile], [gate]: the filter path on precomputed tracks, the
   serving configuration of bench.py (fused updates, caps 2/22, max_staged 8)
   on a 1024-filter fleet over the 200-frame synthetic sequence: make_fleet ->
   run_sequence -> fleet_metrics, with launch counts; then, from the fleet's
   state after frame 30, a profile of frames 30-32 (device time by kernel,
   device-busy share) and a run of frames 30-33 that records every gamma
   launch's inputs and holds its gamma and gate decisions against the plain
   version on them;
5. [kernel] FAST and KLT: the FAST-10+NMS kernel equal to its plain version
   bit for bit on random and rendered images at (1, 480, 752), (64, 480, 752)
   and (1, 201, 300), at thresholds 0, 20 and 20.3, and on a view 4 bytes
   past a 16-byte boundary; the LK-level kernel against its plain version on
   rendered frame pairs at all four pyramid level shapes, shared (Bi = 1,
   B = 256, F = 64) and per-stream (Bi = B = 64), and at windows of 51, 71
   and 101 px: good flags identical, and positions within 0.05 px on
   >= 99.9% of good features (the rest counted); then FAST's times at the
   main paths' shapes and on uniform noise, each beside its bound counted on
   the image (the share of pixels that pass the pre-test);
6. [image]: the image-in-the-loop path of bench.py's --images configuration,
   256 filters sharing one rendered 480 x 752 camera over 200 frames
   (make_fleet -> init_frontend_state -> batched_run_images_shared):
   image-frame-steps/s, ATE(filter 0), counters, peak memory and exact launch
   counts (FAST T, KLT 4T, gamma 2T);
7. [image-profile], [replay]: from the shared fleet's state after frame 30, a
   profile of frames 30-32, and a run of frames 30-33 that records every FAST
   and KLT launch's inputs and outputs and replays them through the plain
   versions (FAST exact, with each launch's bound and candidate share; KLT as
   in phase 5), counting the live LK iterations
   and the pixels read for the KLT bound, and timing the KLT kernel on those
   inputs;
8. [image-indep], [replay-indep]: 64 independent streams (per-stream
   brightness offset (b mod 7) * 0.5, as bench.py) over 40 frames
   (batched_run_images), with ATE(filter 0) and launch counts; then the
   replay of phase 7 on frames 20-23 of that path.

Kernel times: ``ms`` is one call's CUDA-event time, the host's launch work
included (the median of 25 calls); ``device_ms`` is device time per launch
(a CUDA graph of 20 back-to-back calls, replayed; CUDA events).

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}. Without CUDA it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
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
# BENCH_IMAGES.json (JAX package on a TPU): the accuracy reference only.
BENCH_IMAGES_ATE = {"shared": 0.2965, "independent": 0.3068}
ATE_GATE_M = 0.45            # bench.py:34
REPLACES = "msckf_mono_tpu/ops/psd_pallas.py:43"
SOURCE = "msckf_mono_tpu_torch/csrc/psd_gamma.cu"
KLT_ATOL_PX = 0.05
KLT_CLOSE_SHARE = 0.999
# Windows the KLT kernel is checked at besides the main path's 21 px.
KLT_WIDE_WINDOWS = (51, 71, 101)
# The gamma sizes checked against the plain version: (R, n). 121 and 200 run
# one block a system, 345 the device-memory scratch variant.
GAMMA_CASES = [(1, 7), (1, 49152), (1, 12288), (2, 7), (2, 2048), (3, 7), (3, 2048), (13, 7),
               (13, 8192), (41, 7), (41, 8192), (41, 2048), (53, 7), (53, 8192), (121, 64),
               (200, 16), (345, 3)]
# Operations of FAST-10+NMS, counted on what an image needs: the exact
# four-point pre-test on every interior pixel (4 differences; per polarity
# 3 mins or maxes and a comparison, min(max(dN, dS), max(dE, dW)) > t and
# max(min(dN, dS), min(dE, dW)) < -t; their OR), then, on the pixels that pass it, the full segment test
# (16 differences; per polarity 48 + 16 mins or maxes of the arc extrema by
# doubling and 15 to take the best arc; the max of the two polarities; the
# threshold test) and the NMS (8 maxes, 2 tests).
FAST_PRETEST_OPS = 4 + 2 * (3 + 1) + 1
FAST_CANDIDATE_OPS = 16 + 2 * (48 + 16 + 15) + 1 + 1 + 8 + 2
# Flops of one bilinear sample of the LK kernel (clamps, four loads, three
# lerps) and of the per-cell product-sum it feeds.
KLT_FLOPS_PER_SAMPLE = 20


SMEM_OPTIN_H100 = 232448    # a block's shared memory on an H100, where torch does not say


def klt_samples(window, n_valid, live):
    """Bilinear samples one LK level needs: the template and its central
    differences at x +- 1, y +- 1 lie on one integer grid around the point, so
    they take (w + 2)^2 - 4 distinct samples a valid feature; then w^2 a live
    Gauss-Newton iteration."""
    return ((window + 2) ** 2 - 4) * n_valid + window ** 2 * live


def klt_level_bytes(args, window, live):
    """Bytes one LK level must move, each once: the pixels its samples read,
    the points and flags in and the points and flags out. Of the previous
    level, the union over the valid features of the template's patch (the
    clamped x0 and y0 of the window +- 1, plus one); of the current level,
    the union over the features that iterate (``live`` > 0) of the first
    iteration's patch (the window, plus one). Returns (bytes, pixels read)."""
    import torch

    img_prev, _, pts_prev, pts_cur, valid = args
    Bi, H, W = img_prev.shape
    B, F = valid.shape
    half = window // 2
    image = torch.arange(B, device=valid.device)[:, None].expand(B, F)   # (B, F): the image read
    if Bi == 1:
        image = torch.zeros_like(image)

    def union(pts, mask, reach):
        b, p = image[mask], pts[mask]

        def span(c, size):
            lo = torch.clamp(torch.floor(c - reach), 0, size - 2).long()
            return lo, torch.clamp(torch.floor(c + reach), 0, size - 2).long() + 1

        (x0, x1), (y0, y1) = span(p[:, 0], W), span(p[:, 1], H)
        # a 2-D difference array of the rectangles, summed up both axes
        d = torch.zeros(Bi * (H + 1) * (W + 1), dtype=torch.int32, device=valid.device)
        for ys, xs, v in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1), (y1 + 1, x1 + 1, 1)):
            d.index_add_(0, (b * (H + 1) + ys) * (W + 1) + xs,
                         torch.full(ys.shape, v, dtype=torch.int32, device=d.device))
        cover = d.view(Bi, H + 1, W + 1).cumsum(1).cumsum(2)[:, :H, :W]
        return int((cover > 0).sum())

    pixels = union(pts_prev, valid, half + 1.0) + union(pts_cur, live > 0, float(half))
    return 4 * pixels + B * F * (2 * 8 + 1 + 8 + 1), pixels


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


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             timeout=30, check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        return names


def phase_build():
    """Build every kernel; returns {source: [ptxas usage of each instance]}."""
    from msckf_mono_tpu_torch.ops import cuda_build, fast_cuda, klt_cuda, psd_cuda

    t0 = time.time()
    logs = cuda_build.build_all()
    for mod in (psd_cuda, fast_cuda, klt_cuda):
        mod._load()
    log(f"[build] {', '.join(cuda_build.library_path(n).name for n in logs)} in "
        f"{time.time() - t0:.2f} s")
    usage = {}
    for name, text in logs.items():
        rows = cuda_build.ptxas_usage(text)
        for row, pretty in zip(rows, _demangle([r["kernel"] for r in rows])):
            row["kernel"] = pretty.replace("(anonymous namespace)::", "").split("(")[0]
            log(f"[build] {name}: {row['kernel']}: {row['registers']} registers, "
                f"{row['stack_bytes']} B stack frame, {row['spill_stores']} B spill stores, "
                f"{row['spill_loads']} B spill loads")
        check(bool(rows), f"[build] no ptxas report for {name}.cu")
        usage[name] = rows
    # The launchers pick each size's variant and shared memory; every plan
    # must fit a block of this card.
    import torch

    limit = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                    SMEM_OPTIN_H100)
    for what, sizes, plan in (("gamma R", range(1, 401), psd_cuda.launch_plan),
                              ("KLT window", range(3, 152, 2), klt_cuda.launch_plan)):
        spans = []
        for size in sizes:
            p = plan(size)
            check(p.smem_bytes <= limit, f"[build] {what} {size}: plan {p} exceeds {limit} B")
            if spans and spans[-1][0] == p.variant:
                spans[-1][2] = size
            else:
                spans.append([p.variant, size, size])
        log(f"[build] {what} plans, each within {limit} B of shared memory a block: "
            + ", ".join(f"{v} {a}-{b}" for v, a, b in spans))
    return usage


def _make_systems(torch, rng, n, R):
    """As tests/test_psd_pallas.py::_make_systems: S = XXᵀ/R + 1e-5 I, r ~ N(0, I)."""
    X = torch.as_tensor(rng.normal(size=(n, R, R + 4)), device="cuda")
    S = X @ X.transpose(-1, -2) / R + 1e-5 * torch.eye(R, dtype=X.dtype, device="cuda")
    r = torch.as_tensor(rng.normal(size=(n, R)), device="cuda")
    return S.float().contiguous(), r.float().contiguous()


def _graph_ms(torch, fn, reps=20, rounds=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph, the
    graph replayed ``rounds`` times, CUDA events around each replay (median).
    The host's launch work is outside the measurement."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


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
    worst = {}
    for R, n in GAMMA_CASES:
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
        log(f"[kernel] R={R:3d} n={n:5d} ({psd_cuda.launch_plan(R).variant}): max rel err "
            f"{rel:.2e}, max abs err {abs_err:.3e}, gate decisions identical on {n}/{n} lanes "
            f"({int((want < thr).sum())} pass; {int(near.sum())} within 1e-3 of the threshold), "
            f"indefinite lane +inf, upper triangle unused")
        worst[(R, n)] = abs_err

    per_shape = []
    shapes = ((41, 8192, "marginalize"), (1, 49152, "prune"),
              (41, 2048, "marginalize, image path"), (1, 12288, "prune, image path"))
    for R, n, where in shapes:
        S, r = _make_systems(torch, rng, n, R)
        ms = _time_ms(torch, lambda: psd_cuda.gamma_psd(S, r))
        device_ms = _graph_ms(torch, lambda: psd_cuda.gamma_psd(S, r))
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
        shape = dict(R=R, n=n, stage=where, variant=psd_cuda.launch_plan(R).variant, ms=ms,
                     device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     max_abs_err=worst.get((R, n), 0.0))
        per_shape.append(shape)
        log(f"[kernel] {where} shape R={R} n={n}: kernel {ms:.4f} ms a call, {device_ms:.4f} ms "
            f"on the device, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {shape['bound_ms']:.5f} ms "
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
    _zero_counts()
    t0 = time.perf_counter()
    final, outs = run(states, frames_dev)
    metrics = sharding.fleet_metrics(final)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fast_n, klt_n, launches = _counts()
    check((fast_n, klt_n) == (0, 0), f"the filter path launched FAST {fast_n}, KLT {klt_n} times")

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
    prof_frames = tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames_dev)
    phase_profile(torch, "profile", lambda: run(mid, prof_frames), 1e3 * seconds / frames)
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


IMAGE_WINDOW = 21
# bench.py's --images configuration: 256 filters sharing one camera over 200
# frames, and 64 independent streams over 40 frames.
IMAGE_BATCH, IMAGE_FRAMES = 256, 200
INDEP_BATCH, INDEP_FRAMES = 64, 40


def image_frontend_config():
    """bench.py:401-409's serving front-end: window 21, 4 pyramid levels, 64 features."""
    from msckf_mono_tpu_torch.frontend.functional import FrontendConfig

    return FrontendConfig(max_features=64, window_size=IMAGE_WINDOW, max_level=3)


def render_world(cfg, frames):
    """bench.py:411-416's world: synthetic.generate(seed 0, no pixel noise, 500
    landmarks), every frame rendered once on the host -> (T, H, W) on the card."""
    import torch

    from msckf_mono_tpu_torch.data import render, synthetic

    seq, world = synthetic.generate(cfg, n_frames=frames, seed=0, pixel_noise=0.0,
                                    n_landmarks=500, return_world=True)
    t0 = time.perf_counter()
    imgs = np.stack([render.render_frame(cfg, world, i) for i in range(frames)])
    log(f"[image] rendered {frames} frames of {imgs.shape[1]}x{imgs.shape[2]} on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    return seq, torch.as_tensor(imgs, device="cuda")


def _klt_compare(torch, tag, got, want):
    """Good flags identical; positions within KLT_ATOL_PX on KLT_CLOSE_SHARE of
    the good features. Returns (good, close, rest, rest max, max abs err)."""
    check(torch.equal(got[1], want[1]), f"{tag}: good flags differ on "
          f"{int((got[1] != want[1]).sum())} of {got[1].numel()} features")
    good = want[1]
    check(torch.equal(got[0][~good], want[0][~good]), f"{tag}: features that are not good moved")
    err = (got[0] - want[0]).abs().amax(-1)[good]
    n, close = err.numel(), int((err <= KLT_ATOL_PX).sum())
    rest = err[err > KLT_ATOL_PX]
    stats = (n, close, rest.numel(), float(rest.max()) if rest.numel() else 0.0,
             float(err.max()) if n else 0.0)
    check(close >= KLT_CLOSE_SHARE * n, f"{tag}: only {close} of {n} good features within "
          f"{KLT_ATOL_PX} px")
    return stats


def _fast_bound(imgs, threshold):
    """FAST's bound on these inputs: bytes, one read and one write of each
    image; operations, the pre-test on every interior pixel and the full test
    and NMS on the pixels that pass it (fast_cuda.fast_pretest_plain, counted
    on the card). Returns (bound_ms, bound_by, candidate share of the pixels)."""
    from msckf_mono_tpu_torch.ops import fast_cuda

    Bi, H, W = imgs.shape
    interior = Bi * max(H - 6, 0) * max(W - 6, 0)
    passing = int(fast_cuda.fast_pretest_plain(imgs, threshold).sum())
    nbytes = 2 * Bi * H * W * 4
    ops = FAST_PRETEST_OPS * interior + FAST_CANDIDATE_OPS * passing
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            passing / (Bi * H * W))


def phase_image_kernels(torch, imgs):
    """FAST and KLT against their plain versions on the card, at the image
    path's shapes; FAST's times at the main path's shapes. Returns FAST's
    times and the largest absolute error of FAST and of KLT."""
    from msckf_mono_tpu_torch.frontend import detect, klt
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda

    rng = np.random.default_rng(1)
    frame = imgs[30:31]
    noise = torch.as_tensor(rng.uniform(0, 255, size=(1, 480, 752)).astype(np.float32), device="cuda")
    batch = (frame + 0.5 * (torch.arange(INDEP_BATCH, device="cuda") % 7)[:, None, None]).contiguous()
    # a contiguous view 4 bytes past a 16-byte boundary: the 4-byte variant
    shifted = torch.empty(frame.numel() + 1, device="cuda")[1:].view(frame.shape)
    shifted.copy_(frame)
    cases = [("random", noise, 20.0), ("random", noise, 0.0), ("rendered", frame, 20.0),
             (f"rendered x{INDEP_BATCH}", batch, 20.0),
             ("rendered crop", frame[:, 101:302, 211:511].contiguous(), 20.0),
             ("random crop", noise[:, :201, :300].contiguous(), 20.0),
             ("rendered, misaligned view", shifted, 20.0), ("rendered", frame, 20.3)]
    fast_err = 0.0
    for name, t, thr in cases:
        got = fast_cuda.fast_nms_score(t, thr)
        torch.cuda.synchronize()
        want = fast_cuda.fast_nms_score_plain(t, thr)
        fast_err = max(fast_err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"FAST {name} {tuple(t.shape)} t={thr}: kernel and plain "
              f"differ on {int((got != want).sum())} pixels")
        log(f"[kernel] FAST {name} {tuple(t.shape)} t={thr} ({fast_cuda.launch_variant(t)} "
            f"variant): equal to the plain version bit for bit ({int((want > 0).sum())} corners)")

    fast = {}
    for shape_name, t in (("shared", frame), ("independent", batch), ("random", noise)):
        bound_ms, bound_by, share = _fast_bound(t, 20.0)
        fast[shape_name] = dict(
            shape=list(t.shape), ms=_time_ms(torch, lambda: fast_cuda.fast_nms_score(t, 20.0)),
            device_ms=_graph_ms(torch, lambda: fast_cuda.fast_nms_score(t, 20.0)),
            plain_ms=_time_ms(torch, lambda: fast_cuda.fast_nms_score_plain(t, 20.0), reps=10),
            bound_ms=bound_ms, bound_by=bound_by, candidate_share=share)
        log(f"[kernel] FAST {shape_name} {tuple(t.shape)}: kernel {fast[shape_name]['ms']:.4f} ms "
            f"a call, {fast[shape_name]['device_ms']:.4f} ms on the device, plain "
            f"{fast[shape_name]['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{100 * share:.3f}% of the pixels pass the pre-test)")

    # KLT on rendered frame pairs: features at detected corners of frame 30,
    # each filter with its own jitter, predicted at zero motion plus noise.
    pyr0, pyr1 = klt.build_pyramid(imgs[30:31], 3), klt.build_pyramid(imgs[31:32], 3)
    xy, _, ok = detect.detect_features(imgs[30:31], torch.zeros(1, 100, dtype=torch.bool,
                                                                  device="cuda"))
    corners = xy[0][ok[0]].cpu().numpy()
    check(len(corners) >= 30, f"only {len(corners)} corners on frame 30")
    worst = 0.0
    for shared, B in ((True, IMAGE_BATCH), (False, INDEP_BATCH)):
        F = 64
        pick = rng.integers(0, len(corners), size=(B, F))
        pts0 = corners[pick] + rng.normal(0, 0.5, size=(B, F, 2))
        pred0 = pts0 + rng.normal(0, 1.5, size=(B, F, 2))
        valid = torch.as_tensor(rng.uniform(size=(B, F)) < 0.9, device="cuda")
        offs = 0.5 * (torch.arange(B, device="cuda") % 7)[:, None, None]
        for lvl in range(4):
            s = 2.0 ** lvl
            p0 = pyr0[lvl] if shared else (pyr0[lvl] + offs).contiguous()
            p1 = pyr1[lvl] if shared else (pyr1[lvl] + offs).contiguous()
            pts = torch.as_tensor(pts0 / s, dtype=torch.float32, device="cuda")
            pred = torch.as_tensor(pred0 / s, dtype=torch.float32, device="cuda")
            args = (p0, p1, pts, pred, valid)
            kw = dict(window_size=IMAGE_WINDOW, max_iters=30, eps=1.0, min_eigen_threshold=1e-5)
            got = klt_cuda.track_level(*args, **kw)
            torch.cuda.synchronize()
            want = klt_cuda.track_level_plain(*args, **kw)
            tag = f"KLT {'shared' if shared else 'per-stream'} level {lvl} {tuple(p0.shape)}"
            n, close, rest, rest_max, mx = _klt_compare(torch, tag, got, want)
            worst = max(worst, mx)
            log(f"[kernel] {tag}, B={B}, F={F}: good flags identical ({n} good of {B * F}); "
                f"{close}/{n} within {KLT_ATOL_PX} px (max abs err {mx:.2e} px), {rest} beyond "
                f"(max {rest_max:.4f} px)")

    # Wider windows than the main path's: the same frame pair and points,
    # shared images, B = 64 (the plain version's window tensors grow as w^2).
    B, F = INDEP_BATCH, 64
    pts0, pred0 = pts0[:B], pred0[:B]
    for window in KLT_WIDE_WINDOWS:
        plan = klt_cuda.launch_plan(window)
        for lvl in range(4):
            s = 2.0 ** lvl
            pts = torch.as_tensor(pts0 / s, dtype=torch.float32, device="cuda")
            pred = torch.as_tensor(pred0 / s, dtype=torch.float32, device="cuda")
            args = (pyr0[lvl], pyr1[lvl], pts, pred, valid[:B].contiguous())
            kw = dict(window_size=window, max_iters=30, eps=1.0, min_eigen_threshold=1e-5)
            got = klt_cuda.track_level(*args, **kw)
            torch.cuda.synchronize()
            want = klt_cuda.track_level_plain(*args, **kw)
            tag = f"KLT window {window} ({plan.variant}) level {lvl} {tuple(pyr0[lvl].shape)}"
            n, close, rest, rest_max, mx = _klt_compare(torch, tag, got, want)
            worst = max(worst, mx)
            log(f"[kernel] {tag}, B={B}, F={F}: good flags identical ({n} good of {B * F}); "
                f"{close}/{n} within {KLT_ATOL_PX} px (max abs err {mx:.2e} px), {rest} beyond "
                f"(max {rest_max:.4f} px)")
    return fast, fast_err, worst


def image_frames(seq, imgs, B, independent):
    """ImageFrameInput of the first T frames: images (T, H, W) shared, or
    (T, B, H, W) with the per-stream brightness offset (b mod 7) * 0.5 of
    bench.py:476-477; the IMU fields (T, B, ...) views of one copy."""
    import torch

    from msckf_mono_tpu_torch.core.pipeline import ImageFrameInput

    T = imgs.shape[0]

    def b(x, dtype=torch.float32):
        x = torch.as_tensor(np.asarray(x)[:T], dtype=dtype, device="cuda")
        return x[:, None].expand((T, B) + tuple(x.shape[1:]))

    if independent:
        offs = 0.5 * (torch.arange(B, device="cuda", dtype=torch.float32) % 7)
        image = imgs[:, None] + offs[None, :, None, None]
    else:
        image = imgs
    return ImageFrameInput(
        image=image, imu_omega=b(seq.imu_omega), imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt),
        state_id=b(np.arange(1, T + 1), torch.int32), time=b(seq.time),
        frame_valid=b(np.ones(T, bool), torch.bool),
    )


def _counts():
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

    return (fast_cuda.fast_nms_score.launches, klt_cuda.track_level.launches,
            psd_cuda.gamma_psd.launches)


def _zero_counts():
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

    fast_cuda.fast_nms_score.launches = 0
    klt_cuda.track_level.launches = 0
    psd_cuda.gamma_psd.launches = 0


def phase_image(torch, tag, seq, imgs, B, independent):
    """The image-in-the-loop path at bench.py's --images configuration."""
    from msckf_mono_tpu_torch.core import pipeline
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.eval.ate import ate_rmse
    from msckf_mono_tpu_torch.frontend.functional import init_frontend_state
    from msckf_mono_tpu_torch.parallel import montecarlo, sharding

    cfg = serving_config(B)
    fcfg = image_frontend_config()
    T, H, W = imgs.shape
    frames = image_frames(seq, imgs, B, independent)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device="cuda")
    run = (pipeline.batched_run_images if independent else pipeline.batched_run_images_shared)(cfg, fcfg)
    Bi = B if independent else 1

    def make():
        return (montecarlo.make_fleet(cfg, imu, B, torch.Generator().manual_seed(0),
                                      dtype=torch.float32, device="cuda"),
                init_frontend_state(H, W, fcfg, B, Bi, torch.float32, device="cuda"))

    run(*make(), tree_map(lambda x: x[:2], frames))        # warm-up, outside the count
    states, fstates = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    final, ffinal, outs = run(states, fstates, frames)
    metrics = sharding.fleet_metrics(final)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fast_n, klt_n, gamma_n = _counts()

    est = outs.p_I_G.cpu().numpy()                       # (T, B, 3)
    check(np.all(np.isfinite(est)), f"[{tag}] non-finite trajectory")
    ate0 = ate_rmse(est[:, 0], seq.gt_p[:T])
    m = {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref = BENCH_IMAGES_ATE["independent" if independent else "shared"]
    log(f"[{tag}] {B} filters x {T} frames, {'independent streams' if independent else 'one shared camera'}, "
        f"{H}x{W}, f32 on cuda: {seconds:.2f} s, {B * T / seconds:.1f} image-frame-steps/s, "
        f"peak memory {peak:.2f} GiB")
    log(f"[{tag}] ATE(filter 0) {ate0:.4f} m (JAX package on a TPU, BENCH_IMAGES.json: {ref}); "
        f"residualized {int(m['total_residualized'])}, row_overflow {int(m['total_row_overflow'])}, "
        f"staged_overflow {int(m['total_staged_overflow'])}, mean cam count "
        f"{m['mean_cam_count']:.1f}; live tracks at the end {int(ffinal.valid.sum())} "
        f"({int(ffinal.valid[0].sum())} for filter 0), next id of filter 0 {int(ffinal.next_id[0])}")
    log(f"[{tag}] launches over {T} frames: FAST {fast_n}, KLT {klt_n}, gamma {gamma_n}")
    check(ate0 < ATE_GATE_M, f"[{tag}] ATE {ate0:.4f} m >= {ATE_GATE_M} m")
    check((fast_n, klt_n, gamma_n) == (T, 4 * T, 2 * T),
          f"[{tag}] launches FAST {fast_n}, KLT {klt_n}, gamma {gamma_n}; expected "
          f"{T}, {4 * T}, {2 * T}")
    result = dict(B=B, T=T, seconds=seconds, steps_per_s=B * T / seconds, ate0=ate0,
                  peak_gib=peak, launches=dict(fast=fast_n, klt=klt_n, gamma=gamma_n), **m)

    # Mid-sequence frames from the path's own state after frame lo.
    lo = min(30, T // 2)
    mid, fmid, _ = run(*make(), tree_map(lambda x: x[:lo], frames))
    if not independent:
        prof_frames = tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames)
        phase_profile(torch, "image-profile", lambda: run(mid, fmid, prof_frames),
                      1e3 * seconds / T)
    result["replay"] = phase_replay(torch, "replay-indep" if independent else "replay", run, mid,
                                    fmid, tree_map(lambda x: x[lo:lo + GATE_FRAMES], frames))
    return result


def phase_replay(torch, tag, run, state, fstate, frames):
    """FAST and KLT against their plain versions on the image path's own
    inputs: every launch of a few frames records its inputs and outputs, which
    then go through the plain versions. Also counts the live LK iterations
    and the pixels read (for the KLT bound) and times the KLT kernel on the
    first frame's inputs."""
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda

    fast, track = fast_cuda.fast_nms_score, klt_cuda.track_level
    fast_calls, klt_calls = [], []

    def rec_fast(imgs, threshold=20.0):
        out = fast(imgs, threshold)
        fast_calls.append((imgs.clone(), threshold, out.clone()))
        return out

    def rec_klt(*args, **kw):
        out = track(*args, **kw)
        klt_calls.append((tuple(a.clone() for a in args), kw, tuple(o.clone() for o in out)))
        return out

    before = _counts()
    fast_cuda.fast_nms_score, klt_cuda.track_level = rec_fast, rec_klt
    try:
        run(state, fstate, frames)
    finally:
        fast_cuda.fast_nms_score, klt_cuda.track_level = fast, track
    n_frames = frames.time.shape[0]
    after = _counts()
    check((len(fast_calls), len(klt_calls)) == (n_frames, 4 * n_frames)
          and (after[0] - before[0], after[1] - before[1]) == (n_frames, 4 * n_frames),
          f"{len(fast_calls)} FAST and {len(klt_calls)} KLT calls recorded over {n_frames} frames")
    fast_err = 0.0
    for i, (imgs, thr, got) in enumerate(fast_calls):
        want = fast_cuda.fast_nms_score_plain(imgs, thr)
        fast_err = max(fast_err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"[{tag}] FAST differs on {int((got != want).sum())} pixels")
        bound_ms, bound_by, share = _fast_bound(imgs, thr)
        log(f"[{tag}] FAST frame {i} {tuple(imgs.shape)}: bound {bound_ms:.5f} ms ({bound_by}); "
            f"{100 * share:.3f}% of the pixels pass the pre-test")
    log(f"[{tag}] FAST: {len(fast_calls)} launches on {tuple(fast_calls[0][0].shape)}, each equal "
        f"to the plain version bit for bit ({sum(int((c[2] > 0).sum()) for c in fast_calls)} corners)")

    levels = []
    worst = 0.0
    for i, (args, kw, got) in enumerate(klt_calls):
        want = klt_cuda.track_level_plain(*args, **kw, count_iters=True)
        lvl = 3 - i % 4
        n, close, rest, rest_max, mx = _klt_compare(torch, f"[{tag}] KLT call {i} level {lvl}",
                                                    got, want[:2])
        worst = max(worst, mx)
        valid = args[4]
        window = 2 * (kw["window_size"] // 2) + 1
        n_valid = int(valid.sum())
        live = int(want[2].sum())
        Bi, H, W = args[0].shape
        B, F = valid.shape
        nbytes, pixels = klt_level_bytes(args, window, want[2])
        flops = KLT_FLOPS_PER_SAMPLE * klt_samples(window, n_valid, live)
        worst_flops = KLT_FLOPS_PER_SAMPLE * klt_samples(window, n_valid, kw["max_iters"] * n_valid)
        levels.append(dict(call=i, level=lvl, shape=[Bi, H, W], good=n, close=close, rest=rest,
                           rest_max=rest_max, valid=n_valid, live_iters=live, pixels_read=pixels,
                           bytes=nbytes, flops=flops, flops_30_iters=worst_flops))
        log(f"[{tag}] KLT frame {i // 4} level {lvl} {(Bi, H, W)}: {n_valid} valid, {n} good, "
            f"flags identical, {close}/{n} within {KLT_ATOL_PX} px (max abs err {mx:.2e} px), "
            f"{rest} beyond (max {rest_max:.4f} px); {live} live iterations "
            f"({live / max(n, 1):.2f} a good feature); {pixels} pixels read of "
            f"{2 * Bi * H * W} in the two levels")

    # times and bounds on the first recorded frame's launches (4 levels)
    klt = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_ms_30_iters=0.0,
               per_level=[])
    for (args, kw, _), info in zip(klt_calls[:4], levels[:4]):
        ms = _time_ms(torch, lambda: track(*args, **kw))
        device_ms = _graph_ms(torch, lambda: track(*args, **kw))
        plain_ms = _time_ms(torch, lambda: klt_cuda.track_level_plain(*args, **kw), reps=5)
        bytes_ms = info["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = info["flops"] / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_30 = max(bytes_ms, info["flops_30_iters"] / F32_FLOPS_PER_S * 1e3)
        klt["ms"] += ms
        klt["device_ms"] += device_ms
        klt["plain_ms"] += plain_ms
        klt["bound_ms"] += bound_ms
        klt["bound_ms_30_iters"] += bound_30
        klt["per_level"].append(dict(level=info["level"], shape=info["shape"], ms=ms,
                                     device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_ms_30_iters=bound_30,
                                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                     valid=info["valid"], live_iters=info["live_iters"],
                                     pixels_read=info["pixels_read"]))
        log(f"[{tag}] KLT level {info['level']} {tuple(info['shape'])}: kernel {ms:.4f} ms a "
            f"call, {device_ms:.4f} ms on the device, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
            f"{info['bytes'] / 1e6:.2f} MB, {info['live_iters']} live iterations; "
            f"{bound_30:.4f} ms if all {info['valid']} valid features ran 30)")
    # the frame's bound is the sum of the levels'; named by what bounds most of it
    by_bytes = sum(p["bound_ms"] for p in klt["per_level"] if p["bound_by"] == "bytes")
    klt["bound_by"] = "bytes" if 2 * by_bytes >= klt["bound_ms"] else "operations"
    klt["max_abs_err"] = worst
    klt["fast_max_abs_err"] = fast_err
    return klt


def phase_profile(torch, tag, go, frame_ms):
    """Where a frame's time goes: device time by kernel over PROFILE_FRAMES
    frames of a fleet (``go`` runs them), and the device's busy share of a
    frame. The profiler slows the host, so the busy share is taken against
    ``frame_ms``, the unprofiled frame time of the path's main run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    busy = busy_ms / PROFILE_FRAMES
    check(busy > 0, f"[{tag}] the profiler saw no device time")
    log(f"[{tag}] {PROFILE_FRAMES} frames under the profiler: wall {wall_ms:.1f} ms, "
        f"{len(kernels) / PROFILE_FRAMES:.0f} device ops/frame, device busy {busy:.2f} ms/frame "
        f"= {100 * busy / frame_ms:.1f}% of the unprofiled {frame_ms:.2f} ms/frame")
    rows = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    for a in rows[:15]:
        log(f"[{tag}]   {a.self_device_time_total / 1e3 / PROFILE_FRAMES:9.3f} ms/frame "
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
    usage = phase_build()
    per_shape = phase_kernel(torch)
    launches = phase_main(torch, args.batch, args.frames)

    seq, imgs = render_world(serving_config(IMAGE_BATCH), max(IMAGE_FRAMES, INDEP_FRAMES))
    fast_shapes, fast_err, klt_err = phase_image_kernels(torch, imgs)
    shared = phase_image(torch, "image", seq, imgs[:IMAGE_FRAMES], IMAGE_BATCH, False)
    indep = phase_image(torch, "image-indep", seq, imgs[:INDEP_FRAMES], INDEP_BATCH, True)
    replay, replay_indep = shared["replay"], indep["replay"]

    by_path = {k: {"image": shared["launches"][k], "image-indep": indep["launches"][k]}
               for k in ("fast", "klt", "gamma")}
    # One filter-path frame step launches gamma once at each of its two shapes.
    main_shapes = per_shape[:2]
    gamma = {
        "name": "psd_gamma", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "launches_by_path": {"main": launches, **by_path["gamma"]},
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        **{k: sum(s[k] for s in main_shapes)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in main_shapes) else "operations",
        "per_shape": per_shape,
        "registers": usage["psd_gamma"],
    }
    fast = {
        "name": "fast_nms", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/fast_nms.cu",
        "replaces": "msckf_mono_tpu/ops/fast_pallas.py:37",
        "launches": shared["launches"]["fast"], "launches_by_path": by_path["fast"],
        "max_abs_err": max(fast_err, replay["fast_max_abs_err"], replay_indep["fast_max_abs_err"]),
        # one launch a frame on the shared camera's (1, 480, 752) image
        **{k: fast_shapes["shared"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "candidate_share")},
        # uniform noise, the pre-test's worst case
        "random": {k: fast_shapes["random"][k] for k in ("ms", "device_ms", "bound_ms", "bound_by",
                                                         "candidate_share")},
        # no single PyTorch call computes the FAST-10 score
        "library_ms": None,
        "per_shape": fast_shapes,
        "registers": usage["fast_nms"],
    }
    klt = {
        "name": "klt_level", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/klt_level.cu",
        "replaces": "msckf_mono_tpu/ops/klt_pallas.py:60",
        "launches": shared["launches"]["klt"], "launches_by_path": by_path["klt"],
        "max_abs_err": max(klt_err, replay["max_abs_err"], replay_indep["max_abs_err"]),
        # the four level launches of one main-path frame, on its recorded inputs
        **{k: replay[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_30_iters")},
        # no single PyTorch call computes an LK level
        "library_ms": None,
        "per_level": replay["per_level"],
        # the same on the 64-stream path's recorded launches (frame 20)
        "image_indep": {k: replay_indep[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "per_level")},
        "registers": usage["klt_level"],
    }
    paths = {k: {kk: v for kk, v in r.items() if kk != "replay"}
             for k, r in (("image", shared), ("image-indep", indep))}
    print(json.dumps({"kernels": [gamma, fast, klt], "paths": paths}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
