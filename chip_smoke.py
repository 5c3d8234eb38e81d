#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msckf_mono_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 1024] [--frames 200]

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. [device]: the card's name, and its name and power limit from nvidia-smi;
2. [build]: compiles csrc/{psd_gamma,fast_nms,klt_level,triangulate,shi_tomasi}.cu
   with nvcc for sm_90a (-Xptxas -v), one nvcc process per source, all at
   once (or reuses the libraries and their nvcc reports from an earlier
   build), and prints every kernel instance's registers, stack frame and
   spills; then the launchers' plans for R in 1..400, windows 3..151 and
   the Shi-Tomasi kernel's sub-tile at 480 x 752 (grids 10 x 10 and 1 x 1),
   each within the card's shared memory a block;
3. [kernel]: the gamma kernel against its plain PyTorch version on the card at
   R in {1, 2, 3, 13, 41, 53, 121, 200} and at R = 345, above what a block's
   shared memory holds (the device-memory scratch variant): within 1e-3
   relative, identical gate decisions, one lane set to -I gives +inf, NaN in
   the upper triangle changes nothing; then times at the filter path's and
   the image path's shapes: the kernel (one call, and device time), the
   plain version, the nearest library calls (cholesky_ex + solve_triangular),
   and the memory bound;
   [prng]: utils/prng (the JAX package's threefry2x32 draws) on the card
   against the same calls on the CPU: split, random_bits (32 and 64),
   randint at RANSAC's shapes with a device maxval and RANSAC's
   sample_pairs bit-equal; normal (1024, 3) f32 within 2 eps relative, f64
   within 1e-12; a captured graph that splits a carried key and samples the
   pairs equal to an eager loop over 10 replays, and the draw's device time;
   [triangulate]: the triangulation kernel (motion gate + LM) against its
   plain version at the frame step's three call shapes, (1024, 8, 28) and
   (1024, 16, 28) of a 1024-filter fleet at the serving configuration and
   (1, 16, 28) of one filter's sequential updates, on the inputs eager runs
   give (the fleet's 32 frames, the live path's 60; of each kind the call
   with the most tracks that two slots or more observe): motion_ok
   identical, tri_ok identical away from the cost limit, a floor of tracks
   valid in both at each shape, every point within 1e-3 of its distance
   and the kernel's points no farther from the float64 plain version's
   than the float32 plain version's are, the kernel's time (one call, and
   device time), its bound counted on those inputs, the plain version's
   time and the kernel's registers; every path below counts the kernel's
   launches, 2 a frame step (and one a pass of finish());
4. [main], [profile], [gate]: the filter path on precomputed tracks, the
   serving configuration of bench.py (fused updates, caps 2/22, max_staged 8)
   on a 1024-filter fleet over the 200-frame synthetic sequence: make_fleet
   (key 0, the JAX package's draws: filter 0 is BENCH_r05's) ->
   run_sequence (one captured CUDA graph of the step, replayed a frame) ->
   fleet_metrics, with launch counts and peak memory with the graph's pool;
   then, from the fleet's state after frame 30, a profile of frames 30-32
   (device time by kernel, device-busy share, device operations and graph
   launches a frame) and an eager run of frames 30-33 that records every
   gamma launch's inputs and holds its gamma and gate decisions against the
   plain version on them;
   [graph]: the step replayed from the cached graph against the same step
   run eagerly (ops/cuda_graph.disabled()), frame by frame over the first 60
   frames: bit-equal, or every counter and launch count equal and positions
   within 1e-3 m; per-frame p50/p99, rates, synchronizing calls, and the
   eager run's profile beside the replayed one;
   [timing]: eval/timing.stage_timing at this configuration and batch on
   bench.py --stages' inputs: each stage's device time (4 chained calls in
   one replayed graph), flops and bytes counted by hand;
   [sharded]: the filter path through parallel/sharding.make_sharded_run
   on the main run's fleet (drawn once, then split) and frames, in three
   setups: (a) make_mesh() in a one-rank NCCL group, bit-equal to [main]
   with its metrics equal to [main]'s fleet_metrics (means within 1e-6
   relative); (b) two shards of B/2 on cuda:0, each bit-equal to its half
   of the fleet run alone at B/2 (batched_run_sequence), and bit-equal to
   [main] or residualized and row_overflow equal to [main]'s,
   staged_overflow within STAGED_OVERFLOW_SLACK of it and positions within
   2e-2 m (tests/test_sharding.py:65; other GEMM shapes round
   differently); (c) python -m
   msckf_mono_tpu_torch.parallel.two_host_sim: two processes on the card
   joined by gloo, one shard each, whose ``ok`` must hold and whose totals
   must equal (b)'s; each with its frame time, rate, gamma launches (2 a
   frame per shard), peak memory, capture time and all-reduce time;
   [checkpoint]: the main fleet run half-way, saved (parallel/checkpoint),
   restored into a fresh template on the card and resumed through the
   replayed graph: P, p_I_G and every counter bit-equal to [main]; file
   size, save and restore seconds;
   [golden]: eval/golden.compare_to_golden() on the CPU (f64, the golden's
   definition, rtol = atol = 1e-9), then the same spec in f32 on the card
   through the gamma kernel, with its largest position gap to the golden;
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
   [kernel] Shi-Tomasi: the score, FAST/NMS gate and per-cell best kernel
   (ops/shi_tomasi_cuda.shi_tomasi_cells) at (1, 480, 752) and
   (64, 480, 752) on the rendered frame and on uniform noise: its best
   within 1e-5 relative (+ 1e-4) of the plain version's in float64, the
   float32 plain version's gap beside it, its cell indices equal where the
   float64 top two are further apart; its times (one call, and device
   time), its bound (bytes: each pixel and its FAST/NMS value read once)
   and the plain version's time; no library call computes it;
6. [image]: the image-in-the-loop path of bench.py's --images configuration,
   256 filters sharing one rendered 480 x 752 camera over 200 frames
   (make_fleet -> init_frontend_state -> batched_run_images_shared, one
   replayed graph a frame): image-frame-steps/s, ATE(filter 0), counters,
   peak memory and exact launch counts (FAST T, KLT 4T, gamma 2T,
   triangulate 2T, Shi-Tomasi T);
7. [image-profile], [image-graph], [replay]: from the shared fleet's state
   after frame 30, a profile of frames 30-32; the replay-against-eager
   comparison of [graph] on this path; and an eager run of frames 30-33
   that records every FAST
   and KLT launch's inputs and outputs and replays them through the plain
   versions (FAST exact, with each launch's bound and candidate share; KLT as
   in phase 5), counting the live LK iterations
   and the pixels read for the KLT bound, and timing the KLT kernel on those
   inputs;
   [image-precision]: the same path with image_precision="default" (TF32
   for the pyramid's and Shi-Tomasi's products): rate and ATE beside
   [image]'s and both tiers timed in turn (highest, default, default,
   highest), exact launches (no Shi-Tomasi kernel: the TF32 tier keeps the
   banded products), frame 30's largest gap against "highest" on
   each pyramid level and the Shi-Tomasi map, the share of features whose
   KLT good flags agree, the products' device time (TF32 kernels in a
   profile of frames 30-32, and the products alone); then [main]'s first 10
   frames rerun, bit-equal to before (TF32 stayed out of the filter);
8. [image-indep], [replay-indep]: 64 independent streams (per-stream
   brightness offset (b mod 7) * 0.5, as bench.py) over 40 frames
   (batched_run_images), with ATE(filter 0) and launch counts; then the
   replay of phase 7 on frames 20-23 of that path;
9. the live path, one filter (B = 1) at the default MsckfConfig (28 slots,
   128 tracks, sequential marginalize and prune updates, gamma at R = 53)
   over the same rendered world's 200 frames:
   [live-data] the world written as a EuRoC tree by data/write_asl.py and
   read back by data/asl.py (images bit-equal; which decoder served);
   [live-cli] cli/run_euroc on that tree (GT init, --finish);
   [live] VioInterface driven by imu_callback at 200 Hz and image_callback
   (the frame replayed from one captured graph from the second image on;
   frames 30-33 eager, their launches recorded), then finish(): the
   image_callback latency p50/p99 against the camera's 50 ms, frames/s,
   ATE and drift, the getters, exact launch counts, device->host copies and
   synchronizing CUDA calls a frame (by site; at most the frame's one copy
   back from the third frame on);
   [live-profile] frames 30-32 of a fresh run under the profiler;
   [live-graph] the same interface under ops/cuda_graph.disabled() over 60
   frames: ids equal to [live]'s on every frame, positions within 1e-3 m,
   latency, syncs and profile beside [live]'s;
   [live-ransac] the same interface with two-point RANSAC on over the 200
   frames, then finish(): the pairs drawn on the card from the tracker's
   carried key inside the frame's graph, one graph launch an image from the
   second on; p50/p99 against 50 ms beside an eager run of the first 60
   frames (cuda_graph.disabled()), which must equal the replayed frames bit
   for bit (ids and positions), with the gamma, FAST and KLT launches of
   its frames 30-33 held against the plain versions as [live-replay] holds
   [live]'s; syncs a frame, exact launches, ATE. A smoke and launch-count
   check only: the timed measurement of this path is the benchmark cell
   live-b1-ransac (portbench/run.py --workload live-b1-ransac);
   [live-parity] 60 frames with use_qr_compression and use_anisotropic_r;
   [live-replay] every gamma, FAST and KLT launch of frames 30-33 of
   [live] against the plain versions (as phase 7), then each kernel's
   times and bound at the live shapes.

The entry points replay CUDA graphs by default (ops/cuda_graph.py); the
phases that record kernel launches in Python run their frames eagerly.

Kernel times: ``ms`` is one call's CUDA-event time, the host's launch work
included (the median of 25 calls); ``device_ms`` is device time per launch
(a CUDA graph of 20 back-to-back calls, replayed; CUDA events).

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}. Without CUDA it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
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
# The JAX package's filter 0 (key 0) on the shared-camera image path at
# image_precision="highest", 200 frames, run on the CPU
# (tests/test_torch_image_ate.py): the accuracy reference only.
JAX_CPU_IMAGE_ATE = 0.3429
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
    from msckf_mono_tpu_torch.ops import (cuda_build, fast_cuda, klt_cuda, psd_cuda, shi_tomasi_cuda,
                                          triangulate_cuda)

    t0 = time.time()
    logs = cuda_build.build_all()
    for mod in (psd_cuda, fast_cuda, klt_cuda, triangulate_cuda, shi_tomasi_cuda):
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
    for grid in ((10, 10), (1, 1)):
        th, tw, smem = shi_tomasi_cuda.launch_plan(480, 752, 15, *grid)
        check(smem <= limit, f"[build] Shi-Tomasi plan {th} x {tw}, {smem} B exceeds {limit} B")
        log(f"[build] Shi-Tomasi at 480 x 752, grid {grid[0]} x {grid[1]}, half-width 15: "
            f"sub-tiles of up to {th} x {tw} pixels, {smem} B of shared memory a block")
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


# The frame step's triangulation calls: (stage, configuration, filters); the
# window has 28 slots. The serving fleet stages 8 tracks and 16 prune
# candidates a filter, the live path (sequential updates) 16 of each.
TRI_CASES = (("marginalize", "serving", 1024), ("prune", "serving", 1024),
             ("live marginalize", "live", 1), ("live prune", "live", 1))
# The eager runs whose calls are recorded, (frames, sequence seed): the
# window fills at frame 20; the fleet triangulates 16 prune candidates a
# filter on frames 21-25, the live filter up to 5 staged tracks and 16 prune
# candidates a frame.
TRI_RUNS = {"serving": (32, 0), "live": (60, 1)}
# Tracks valid in both at least, at each shape (the busiest calls give
# ~3,000 and ~16,000 in the fleet, 5 and 16 in the live filter).
TRI_MIN_VALID = {"marginalize": 1024, "prune": 1024, "live marginalize": 3, "live prune": 8}
# Operations a track needs at least, over its m observing slots: each slot's
# pose relative to the first camera (rotation 21, A = R R0^T 45, t 18), its
# motion-gate baseline 22, its initial cost 22, its Huber-weighted normal
# equations 100 (one outer step) and its cost 22 (one trial), its
# cheirality test 7; and one damped 3 x 3 solve 70 a track. A track takes
# more outer steps and trials than one; counted at one, the operations stay
# below the bytes' bound at every shape, so the bound is the bytes either way.
TRI_SLOT_OPS, TRI_SOLVE_OPS = 257, 70


def triangulations_per_step(cfg):
    """Triangulation launches a frame step: marginalize, and prune when on."""
    return 1 + int(cfg.filter.use_prune_redundant)


def _triangulation_calls(torch, which, batch):
    """The inputs of two triangulation calls of an eager run (TRI_RUNS),
    [(args, kwargs, frame)] for marginalize, then prune: of each kind the call with
    the most tracks that two slots or more observe (the world's tracks die on
    some frames only, and prune triangulates only where it finds a redundant
    slot)."""
    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.core import triangulate
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import init_filter_state
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import montecarlo
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    cfg = serving_config(batch) if which == "serving" else MsckfConfig()
    n_frames, seed = TRI_RUNS[which]
    seq = synthetic.generate(cfg, n_frames=n_frames, seed=seed, pixel_noise=0.5)
    imu = ground_truth_init(**GT_INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device="cuda")
    frames = montecarlo.broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device="cuda"),
                                         batch)
    state = (montecarlo.make_fleet(cfg, imu, batch, dtype=torch.float32, device="cuda")
             if which == "serving" else init_filter_state(cfg, imu, dtype=torch.float32, device="cuda"))
    calls, dispatch = [], triangulate.triangulate_tracks

    def record(obs, mask, q, p, thr, max_cost, n_iters=11, n_trials=11):
        calls.append(((obs.clone(), mask.clone(), q.clone(), p.clone(), thr, max_cost),
                      dict(n_iters=n_iters, n_trials=n_trials)))
        return dispatch(obs, mask, q, p, thr, max_cost, n_iters=n_iters, n_trials=n_trials)

    triangulate.triangulate_tracks = record
    try:
        with cuda_graph.disabled():      # a replayed graph calls no Python
            msckf_filter.run_sequence(state, frames, cfg)
    finally:
        triangulate.triangulate_tracks = dispatch
    per_step = triangulations_per_step(cfg)
    check(per_step == 2 and len(calls) == per_step * n_frames,
          f"{len(calls)} triangulation calls recorded over {n_frames} frames")
    busiest = lambda k: max(range(k, len(calls), 2),
                            key=lambda i: int((calls[i][0][1].sum(-1) >= 2).sum()))
    return [calls[i] + (i // per_step,) for i in (busiest(0), busiest(1))]


def triangulation_work(args):
    """(operations, bytes) one call needs at least on these inputs: the
    operations of TRI_SLOT_OPS a slot that observes and TRI_SOLVE_OPS a
    track that some slot observes; the bytes of the observations, masks and
    window poses read once and the three outputs written once."""
    obs, mask, q, p = args[:4]
    m = mask.sum(-1)
    ops = float(TRI_SLOT_OPS * m.sum() + TRI_SOLVE_OPS * (m > 0).sum())
    n, N = mask.numel() // mask.shape[-1], mask.shape[-1]
    nbytes = n * N * (2 * 4 + 1) + (q.numel() + p.numel()) * 4 + n * (1 + 1 + 3 * 4)
    return ops, nbytes


def triangulation_cost(torch, args, p_f_G):
    """The normalised cost, total / (2 max(m, 1)^2), of the points p_f_G,
    recomputed in float64 as the plain version computes it."""
    from msckf_mono_tpu_torch.core import triangulate

    obs, mask, q, p = args[:4]
    obs, q, p, p_f_G = (x.double() for x in (obs, q, p, p_f_G))
    qe, pe = triangulate._expand_window(obs, q, p)
    A, t, A0, t0 = triangulate._relative_poses(mask, qe, pe)
    x = (A0.transpose(-1, -2) @ (p_f_G - t0)[..., None])[..., 0]
    sol = torch.stack([x[..., 0] / x[..., 2], x[..., 1] / x[..., 2], 1.0 / x[..., 2]], dim=-1)
    m = mask.sum(-1).clamp(min=1).double()
    return triangulate._total_cost(A, t, obs, mask, sol) / (2.0 * m * m)


def phase_triangulate(torch, usage):
    """[triangulate]: kernel against plain version, times and bound at the
    frame step's call shapes: motion_ok identical; tri_ok identical except
    where the plain version's normalised cost lies within 1e-4 relative of
    the limit; at least TRI_MIN_VALID tracks valid in both; their points
    within 1e-3 of the distance (or 1e-5 m) on every one; and, over 200
    tracks or more, the kernel's distance to the float64 plain version no
    larger than the float32 plain version's (median and 99th percentile,
    25% slack). Points within 1e-4 of the plain version's on 99% of the
    tracks (the card tests' rule on the fleet's last frames) does not hold
    on every call: on a window of a few poses a float32 LM stops ~1e-4 of
    the distance from where the float64 one does, on a few % of the tracks,
    and moves as far when its inputs move by one ulp; it is printed."""
    from msckf_mono_tpu_torch.core import triangulate
    from msckf_mono_tpu_torch.ops import triangulate_cuda

    kernel, plain = triangulate_cuda.triangulate_tracks, triangulate.triangulate_tracks_plain
    recorded = {}
    for which, batch in (("serving", 1024), ("live", 1)):
        recorded[which] = _triangulation_calls(torch, which, batch)
    check(len(usage["triangulate"]) == 1, f"[triangulate] {len(usage['triangulate'])} kernel instances")
    registers = usage["triangulate"][0]["registers"]
    per_shape = []
    for (stage, which, batch), (args, kw, frame) in zip(
            TRI_CASES, recorded["serving"] + recorded["live"]):
        shape = tuple(args[0].shape[:-1])
        before = kernel.launches
        mk, pk, tk = kernel(*args, **kw)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"[triangulate] {stage}: launches not counted")
        mp, pp, tp = plain(*args, **kw)
        check(torch.equal(mk, mp), f"[triangulate] {stage}: motion_ok differs on "
              f"{int((mk != mp).sum())} tracks")
        limit = args[5]
        near = (triangulation_cost(torch, args, pp) - limit).abs() <= 1e-4 * limit
        differ = (tk != tp) & ~near
        check(not bool(differ.any()), f"[triangulate] {stage}: tri_ok differs on "
              f"{int(differ.sum())} tracks away from the cost limit")
        both = tk & tp
        n_both = int(both.sum())
        check(n_both >= TRI_MIN_VALID[stage], f"[triangulate] {stage}: {n_both} tracks valid in "
              f"both, fewer than {TRI_MIN_VALID[stage]}")
        dist = torch.linalg.norm(pp, dim=-1)[both]
        d = torch.linalg.norm(pk - pp, dim=-1)[both]
        rel = d / dist.clamp(min=1e-30)
        worst = float(rel.max())
        over = int((d > torch.clamp(1e-4 * dist, min=1e-5)).sum())
        obs, mask, q, p = args[:4]
        _, p64, t64 = plain(obs.double(), mask, q.double(), p.double(), *args[4:], **kw)
        all3 = both & t64
        e32 = torch.linalg.norm(pp.double() - p64, dim=-1)[all3]
        ek = torch.linalg.norm(pk.double() - p64, dim=-1)[all3]
        dist64 = torch.linalg.norm(p64, dim=-1)[all3]
        over32 = int((e32 > torch.clamp(1e-4 * dist64, min=1e-5)).sum())
        overk = int((ek > torch.clamp(1e-4 * dist64, min=1e-5)).sum())
        qs = torch.tensor([0.5, 0.99], dtype=torch.float64, device=pp.device)
        q32, qk = ((torch.quantile(e, qs).tolist() if e.numel() else [0.0, 0.0]) for e in (e32, ek))
        ops, nbytes = triangulation_work(args)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
        row = dict(stage=stage, shape=shape, registers=registers,
                   ms=_time_ms(torch, lambda: kernel(*args, **kw)),
                   device_ms=_graph_ms(torch, lambda: kernel(*args, **kw)),
                   plain_ms=_time_ms(torch, lambda: plain(*args, **kw)),
                   bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   ops=ops, bytes=nbytes, frame=frame, observed=int((args[1].sum(-1) >= 2).sum()),
                   motion_ok=int(mk.sum()), tri_ok=[int(tk.sum()), int(tp.sum())],
                   valid_in_both=n_both, tri_ok_differ=int((tk != tp).sum()),
                   tri_ok_near_limit=int(near.sum()), max_rel_p=worst, over_1e4=over,
                   f64_median_99=dict(plain=q32, kernel=qk),
                   f64_over_1e4=dict(plain=over32, kernel=overk, tracks=int(all3.sum())))
        per_shape.append(row)
        log(f"[triangulate] {stage} {shape}, frame {frame} ({registers} registers): kernel "
            f"{row['ms']:.4f} ms a call, {row['device_ms']:.4f} ms on the device, plain "
            f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
            f"at least {ops / 1e6:.2f} MFLOP, {nbytes / 1e6:.2f} MB); {row['observed']} tracks "
            f"seen twice or more; motion_ok identical ({row['motion_ok']} pass), tri_ok "
            f"{row['tri_ok'][0]} / plain {row['tri_ok'][1]} ({row['tri_ok_differ']} differ, "
            f"{row['tri_ok_near_limit']} within 1e-4 of the cost limit), {n_both} valid in both "
            f"(at least {TRI_MIN_VALID[stage]}), points within {worst:.2e} of their distance "
            f"({over} beyond 1e-4); to the float64 plain version (median, 99th) plain f32 "
            f"{q32[0]:.3e}, {q32[1]:.3e} m, kernel {qk[0]:.3e}, {qk[1]:.3e} m, beyond 1e-4 of the "
            f"distance {over32} / {overk} of {int(all3.sum())}")
        check(bool(torch.all(d <= torch.clamp(1e-3 * dist, min=1e-5))),
              f"[triangulate] {stage}: a point {worst:.3e} of its distance apart")
        if e32.numel() >= 200:
            check(all(b <= 1.25 * a + 1e-7 for a, b in zip(q32, qk)),
                  f"[triangulate] {stage}: the kernel's distance to the float64 plain version "
                  f"(median, 99th) {qk} exceeds the float32 plain version's {q32}")
    return per_shape


PRNG_SEEDS = (0, 1, 2**32 - 1)
PRNG_REPLAYS = 10
RANSAC_F = 128               # the live tracker's feature slots: RANSAC's points


def phase_prng(torch):
    """[prng]: utils/prng (JAX's threefry2x32) on the card against the same
    calls on the CPU: split, random_bits (32 and 64), randint at RANSAC's
    shapes with a device maxval and RANSAC's sample_pairs bit-equal, normal
    (1024, 3) f32 within 2 eps relative and f64 within 1e-12; then a
    captured graph that splits a carried key and samples the pairs, against
    an eager loop over PRNG_REPLAYS replays, and the draw's device time."""
    from msckf_mono_tpu_torch.frontend import ransac
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.utils import prng

    n_int = 0
    for seed in PRNG_SEEDS:
        k = prng.PRNGKey(seed)
        kd = k.cuda()
        check(torch.equal(prng.split(kd, 5).cpu(), prng.split(k, 5)), f"[prng] split, key {seed}")
        for width in (32, 64):
            for shape in ((300,), (1024, 3)):
                got, want = prng.random_bits(kd, width, shape).cpu(), prng.random_bits(k, width, shape)
                check(torch.equal(got, want), f"[prng] random_bits {width} {shape}, key {seed}")
                n_int += want.numel()
        for bits in (32, 64):
            for n in (2, 5, 37, RANSAC_F):
                got = prng.randint(kd, (300,), 0, torch.tensor(n, device="cuda"), bits).cpu()
                want = prng.randint(k, (300,), 0, torch.tensor(n), bits)
                check(torch.equal(got, want), f"[prng] randint [0, {n}) {bits}-bit, key {seed}")
                n_int += want.numel()
            for n_valid in (0, 3, 40, RANSAC_F):
                valid = torch.zeros(RANSAC_F, dtype=torch.bool)
                valid[torch.randperm(RANSAC_F, generator=torch.Generator().manual_seed(n_valid))[:n_valid]] = True
                got = ransac.sample_pairs(valid.cuda(), kd, int_bits=bits)
                want = ransac.sample_pairs(valid, k, int_bits=bits)
                check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                      f"[prng] sample_pairs {n_valid} valid, {bits}-bit, key {seed}")
                n_int += 2 * want[0].numel()
    eps = float(np.finfo(np.float32).eps)
    k = prng.PRNGKey(0)
    got = prng.normal(k.cuda(), (1024, 3), torch.float32).cpu().double()
    want = prng.normal(k, (1024, 3), torch.float32).double()
    gap_eps = float(((got - want).abs() / (eps * want.abs())).max())
    same32 = float((got == want).double().mean())
    got64 = prng.normal(k.cuda(), (1024, 3), torch.float64).cpu()
    want64 = prng.normal(k, (1024, 3), torch.float64)
    rel64 = float(((got64 - want64).abs() / want64.abs()).max())
    log(f"[prng] integers bit-equal to the CPU's ({n_int} values: split, random_bits 32/64, randint "
        f"[0, n) with a device maxval, sample_pairs at F = {RANSAC_F}, 32- and 64-bit, keys "
        f"{list(PRNG_SEEDS)}); normal (1024, 3) f32 max gap {gap_eps:.3f} eps relative, "
        f"{100 * same32:.2f}% bit-equal; f64 max relative gap {rel64:.3e}")
    check(gap_eps <= 2.0, f"[prng] f32 normal {gap_eps:.3f} eps from the CPU's")
    check(rel64 <= 1e-12, f"[prng] f64 normal {rel64:.3e} from the CPU's")

    valid = torch.zeros(RANSAC_F, dtype=torch.bool, device="cuda")
    valid[:40] = True

    def step(key, v):
        key, sub = prng.split(key)
        return key, ransac.sample_pairs(v, sub)

    graph = cuda_graph.StepGraph(step, prng.PRNGKey(0, "cuda"), (valid,))
    key, eager = prng.PRNGKey(0, "cuda"), prng.PRNGKey(0, "cuda")
    for i in range(PRNG_REPLAYS):
        key, (i1, i2) = graph(key, valid)
        eager, (w1, w2) = step(eager, valid)
        check(torch.equal(key, eager) and torch.equal(i1, w1) and torch.equal(i2, w2),
              f"[prng] replay {i}: keys or pairs differ from the eager loop")
    draw_ms = _graph_ms(torch, lambda: step(eager, valid))
    log(f"[prng] a captured key split + RANSAC pair draw: {PRNG_REPLAYS} replays equal to the "
        f"eager loop (keys and pairs); device time {draw_ms:.4f} ms a draw (300 pairs)")
    return dict(integers_checked=n_int, normal_f32_max_gap_eps=gap_eps,
                normal_f32_bit_equal_share=same32, normal_f64_max_rel=rel64,
                replays_equal=PRNG_REPLAYS, ransac_draw_device_ms=draw_ms)


def serving_config(batch):
    """bench.py:123-164's serving configuration at this batch size."""
    from msckf_mono_tpu_torch.utils.config import serving_config as config

    return config(batch)


def phase_main(torch, batch, frames):
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.eval.ate import ate_rmse
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import montecarlo, sharding

    cfg = serving_config(batch)
    seq = synthetic.generate(cfg, n_frames=frames, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device="cuda")
    frames_dev = montecarlo.broadcast_frames(
        synthetic.to_frame_inputs(seq, torch.float32, device="cuda"), batch)
    run = sharding.batched_run_sequence(cfg)
    # key 0: the JAX package's fleet, drawn on the CPU (filter 0 is BENCH_r05's)
    make = lambda: montecarlo.make_fleet(cfg, imu, batch, dtype=torch.float32, device="cuda")

    # Warm-up on two frames, outside the count: on the card it captures the
    # step's graph (library handles, allocator, the graph's pool).
    warm = tree_map(lambda x: x[:2], frames_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(make(), warm)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    states = make()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    final, outs = run(states, frames_dev)
    metrics = sharding.fleet_metrics(final)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fast_n, klt_n, launches, tri_n, st_n = _counts()
    check((fast_n, klt_n, st_n) == (0, 0, 0), f"the filter path launched FAST {fast_n}, KLT "
          f"{klt_n}, Shi-Tomasi {st_n} times")

    est = outs.p_I_G.cpu().numpy()                       # (T, B, 3)
    check(np.all(np.isfinite(est)), "non-finite trajectory")
    ate0 = ate_rmse(est[:, 0], seq.gt_p)
    m = {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    log(f"[main] serving config, {batch} filters x {frames} frames, f32 on cuda, one replayed "
        f"graph a frame: {seconds:.2f} s, {batch * frames / seconds:.1f} frame-steps/s, "
        f"peak memory {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved with the graph's "
        f"pool (capture and 2 warm-up frames {capture_s:.2f} s)")
    log(f"[main] ATE(filter 0) {ate0:.4f} m (the same filter, the JAX package's key 0, on a TPU: "
        f"BENCH_r05 {BENCH_R05['ate_m']} m; a record, not a gate); "
        f"residualized {int(m['total_residualized'])} ({BENCH_R05['residualized']}), "
        f"row_overflow {int(m['total_row_overflow'])} ({BENCH_R05['row_overflow']}), "
        f"staged_overflow {int(m['total_staged_overflow'])} ({BENCH_R05['staged_overflow']}); "
        f"gamma kernel launches {launches}, triangulate {tri_n} over {frames} steps")
    check(ate0 < ATE_GATE_M, f"ATE {ate0:.4f} m >= {ATE_GATE_M} m")
    check(launches == 2 * frames, f"{launches} gamma launches, expected {2 * frames}")
    check(tri_n == 2 * frames, f"{tri_n} triangulate launches, expected {2 * frames}")
    # Mid-sequence frames, the window full: the state after frame `lo` goes on
    # with frames lo, lo + 1, ... as in the main run.
    lo = min(30, frames // 2)
    mid, _ = run(make(), tree_map(lambda x: x[:lo], frames_dev))
    prof_frames = tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames_dev)
    frame_ms = 1e3 * seconds / frames
    profile = phase_profile(torch, "profile", lambda: run(mid, prof_frames), frame_ms)
    phase_gate(torch, cfg, run, mid, tree_map(lambda x: x[lo:lo + GATE_FRAMES], frames_dev))
    main = dict(cfg=cfg, final=final, outs=outs, frames=frames_dev, make=make,
                steps_per_s=batch * frames / seconds, frame_ms=frame_ms, peak_gib=peak,
                reserved_gib=reserved, capture_s=capture_s, profile=profile,
                profile_go=lambda: run(mid, prof_frames), triangulate_launches=tri_n)
    return launches, main


PROFILE_FRAMES = 3
GATE_FRAMES = 4


def phase_gate(torch, cfg, run, state, frames):
    """The kernel against its plain version on the main path's own inputs:
    every launch of a few fleet frames records its (S, r) and its gamma, and
    every gate its dof; afterwards gamma_psd_plain runs on the recorded
    inputs, and its gamma and gate decisions must match the kernel's."""
    from msckf_mono_tpu_torch.core import update
    from msckf_mono_tpu_torch.ops import cuda_graph, psd_cuda
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
        with cuda_graph.disabled():        # a replayed graph calls no Python
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


def _shi_tomasi_kernel(torch, name, t):
    """The Shi-Tomasi kernel on images ``t`` against the plain version in
    float64 (and the float32 plain version's gap beside it), then its times
    and its bound: bytes, each pixel and its FAST/NMS value read once and
    each cell's best and index written once."""
    from msckf_mono_tpu_torch.ops import fast_cuda, shi_tomasi_cuda

    nms = fast_cuda.fast_nms_score(t, 20.0)
    kernel = shi_tomasi_cuda.shi_tomasi_cells
    before = kernel.launches
    best, local = kernel(t, nms)
    torch.cuda.synchronize()
    check(kernel.launches == before + 1, f"[kernel] Shi-Tomasi {name}: launches not counted")
    st64 = shi_tomasi_cuda.shi_tomasi_score_plain(t.double())
    b64, l64 = shi_tomasi_cuda.cell_best_plain(st64, nms)
    b32, _ = shi_tomasi_cuda.shi_tomasi_cells_plain(t, nms)
    err = (best.double() - b64).abs()
    err32 = float((b32.double() - b64).abs().max())
    check(bool((err <= 1e-5 * b64.abs() + 1e-4).all()), f"[kernel] Shi-Tomasi {name}: best off "
          f"the float64 plain version by {float(err.max()):.3e}")
    marked = torch.where(nms > 0, st64, torch.full_like(st64, -1.0))
    top2 = shi_tomasi_cuda.cell_tiles(marked).topk(2).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5 * b64.abs() + 1e-4
    check(torch.equal(local[clear], l64[clear]), f"[kernel] Shi-Tomasi {name}: cell indices differ")
    Bi, H, W = t.shape
    nbytes = 2 * Bi * H * W * 4 + Bi * 100 * (4 + 8)
    out = dict(shape=list(t.shape), max_abs_err=float(err.max()),
               max_rel_err=float((err / b64.abs().clamp_min(1.0)).max()), f32_plain_max_abs_err=err32,
               ms=_time_ms(torch, lambda: kernel(t, nms)),
               device_ms=_graph_ms(torch, lambda: kernel(t, nms)),
               plain_ms=_time_ms(torch, lambda: shi_tomasi_cuda.shi_tomasi_cells_plain(t, nms),
                                 reps=10),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
               corners=int((b64 > 40).sum()), indices_checked=int(clear.sum()))
    log(f"[kernel] Shi-Tomasi {name} {tuple(t.shape)}: best within {out['max_abs_err']:.3e} "
        f"(relative {out['max_rel_err']:.3e}) of the float64 plain version, the float32 plain "
        f"version within {err32:.3e}; indices equal on {out['indices_checked']} cells whose top "
        f"two are apart; {out['corners']} cells above 40; kernel {out['ms']:.4f} ms a call, "
        f"{out['device_ms']:.4f} ms on the device, plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.5f} ms (bytes; {nbytes / 1e6:.1f} MB); library: none")
    return out


def phase_image_kernels(torch, imgs):
    """FAST, KLT and Shi-Tomasi against their plain versions on the card, at
    the image path's shapes; FAST's and Shi-Tomasi's times at the main
    path's shapes. Returns FAST's times, the largest absolute error of FAST
    and of KLT, and Shi-Tomasi's checks and times."""
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
    shi_tomasi = {name: _shi_tomasi_kernel(torch, name, t) for name, t in
                  (("shared", frame), ("independent", batch), ("random", noise),
                   ("random x64", (noise + batch - frame).contiguous()))}

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
    return fast, fast_err, worst, shi_tomasi


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
    """Launches of (FAST, KLT, gamma, triangulate, Shi-Tomasi)."""
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda, shi_tomasi_cuda, triangulate_cuda

    return (fast_cuda.fast_nms_score.launches, klt_cuda.track_level.launches,
            psd_cuda.gamma_psd.launches, triangulate_cuda.triangulate_tracks.launches,
            shi_tomasi_cuda.shi_tomasi_cells.launches)


def _zero_counts():
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda, shi_tomasi_cuda, triangulate_cuda

    fast_cuda.fast_nms_score.launches = 0
    klt_cuda.track_level.launches = 0
    psd_cuda.gamma_psd.launches = 0
    triangulate_cuda.triangulate_tracks.launches = 0
    shi_tomasi_cuda.shi_tomasi_cells.launches = 0


LAUNCH_KEYS = ("fast", "klt", "gamma", "triangulate", "shi_tomasi")


def image_run(torch, tag, seq, imgs, B, independent, fcfg):
    """The image-in-the-loop path at bench.py's --images configuration with
    the front-end ``fcfg``: capture, then the timed run and its checks.
    Returns (result, run, make, frames, cfg)."""
    from msckf_mono_tpu_torch.core import pipeline
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.eval.ate import ate_rmse
    from msckf_mono_tpu_torch.frontend.functional import init_frontend_state
    from msckf_mono_tpu_torch.parallel import montecarlo, sharding

    cfg = serving_config(B)
    T, H, W = imgs.shape
    frames = image_frames(seq, imgs, B, independent)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device="cuda")
    run = (pipeline.batched_run_images if independent else pipeline.batched_run_images_shared)(cfg, fcfg)
    Bi = B if independent else 1

    def make():
        return (montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device="cuda"),
                init_frontend_state(H, W, fcfg, B, Bi, torch.float32, device="cuda"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(*make(), tree_map(lambda x: x[:2], frames))        # capture and warm-up, outside the count
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    states, fstates = make()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    final, ffinal, outs = run(states, fstates, frames)
    metrics = sharding.fleet_metrics(final)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fast_n, klt_n, gamma_n, tri_n, st_n = _counts()
    # the kernel runs at "highest"; the TF32 tier keeps the banded products
    st_want = T if fcfg.image_precision == "highest" else 0

    est = outs.p_I_G.cpu().numpy()                       # (T, B, 3)
    check(np.all(np.isfinite(est)), f"[{tag}] non-finite trajectory")
    ate0 = ate_rmse(est[:, 0], seq.gt_p[:T])
    m = {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    ref = BENCH_IMAGES_ATE["independent" if independent else "shared"]
    log(f"[{tag}] {B} filters x {T} frames, {'independent streams' if independent else 'one shared camera'}, "
        f"{H}x{W}, f32 on cuda (image products at {fcfg.image_precision!r}), one replayed graph "
        f"a frame: {seconds:.2f} s, "
        f"{B * T / seconds:.1f} image-frame-steps/s, peak memory {peak:.2f} GiB allocated, "
        f"{reserved:.2f} GiB reserved with the graph's pool (capture and 2 warm-up frames "
        f"{capture_s:.2f} s)")
    log(f"[{tag}] ATE(filter 0) {ate0:.4f} m (the same filter, the JAX package's key 0: "
        f"BENCH_IMAGES.json {ref} m on a TPU at its \"default\" tier, "
        f"{JAX_CPU_IMAGE_ATE} m on the CPU at \"highest\"; a record, not a gate); "
        f"residualized {int(m['total_residualized'])}, row_overflow {int(m['total_row_overflow'])}, "
        f"staged_overflow {int(m['total_staged_overflow'])}, mean cam count "
        f"{m['mean_cam_count']:.1f}; live tracks at the end {int(ffinal.valid.sum())} "
        f"({int(ffinal.valid[0].sum())} for filter 0), next id of filter 0 {int(ffinal.next_id[0])}")
    log(f"[{tag}] launches over {T} frames: FAST {fast_n}, KLT {klt_n}, gamma {gamma_n}, "
        f"triangulate {tri_n}, Shi-Tomasi {st_n}")
    check(ate0 < ATE_GATE_M, f"[{tag}] ATE {ate0:.4f} m >= {ATE_GATE_M} m")
    check((fast_n, klt_n, gamma_n, tri_n, st_n) == (T, 4 * T, 2 * T, 2 * T, st_want),
          f"[{tag}] launches FAST {fast_n}, KLT {klt_n}, gamma {gamma_n}, triangulate {tri_n}, "
          f"Shi-Tomasi {st_n}; expected {T}, {4 * T}, {2 * T}, {2 * T}, {st_want}")
    result = dict(B=B, T=T, seconds=seconds, steps_per_s=B * T / seconds, ate0=ate0,
                  peak_gib=peak, reserved_gib=reserved, capture_s=capture_s,
                  launches=dict(zip(LAUNCH_KEYS, (fast_n, klt_n, gamma_n, tri_n, st_n))), **m)
    return result, run, make, frames, cfg


def phase_image(torch, tag, seq, imgs, B, independent):
    """The image-in-the-loop path at bench.py's --images configuration."""
    from msckf_mono_tpu_torch.core import pipeline
    from msckf_mono_tpu_torch.core.types import tree_map

    fcfg = image_frontend_config()
    result, run, make, frames, cfg = image_run(torch, tag, seq, imgs, B, independent, fcfg)
    T = imgs.shape[0]
    seconds = result["seconds"]
    peak, reserved, capture_s = result["peak_gib"], result["reserved_gib"], result["capture_s"]

    # Mid-sequence frames from the path's own state after frame lo.
    lo = min(30, T // 2)
    mid, fmid, _ = run(*make(), tree_map(lambda x: x[:lo], frames))
    if not independent:
        prof_frames = tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames)
        go = lambda: run(mid, fmid, prof_frames)
        profile = phase_profile(torch, "image-profile", go, 1e3 * seconds / T)
        main = dict(profile=profile, profile_go=go, frame_ms=1e3 * seconds / T, peak_gib=peak,
                    reserved_gib=reserved, capture_s=capture_s)
        result["graph"] = phase_graph(
            torch, "image-graph", pipeline.step, (cfg, fcfg), make,
            frames.replace(image=frames.image[:, None]), main)
    result["replay"] = phase_replay(torch, "replay-indep" if independent else "replay", run, mid,
                                    fmid, tree_map(lambda x: x[lo:lo + GATE_FRAMES], frames))
    return result


def phase_replay(torch, tag, run, state, fstate, frames):
    """FAST and KLT against their plain versions on the image path's own
    inputs: every launch of a few frames records its inputs and outputs, which
    then go through the plain versions. Also counts the live LK iterations
    and the pixels read (for the KLT bound) and times the KLT kernel on the
    first frame's inputs."""
    from msckf_mono_tpu_torch.ops import cuda_graph, fast_cuda, klt_cuda

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
        with cuda_graph.disabled():        # a replayed graph calls no Python
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

    klt = _klt_replay(torch, tag, klt_calls, track, *_klt_compare_calls(torch, tag, klt_calls))
    klt["fast_max_abs_err"] = fast_err
    return klt


def _klt_compare_calls(torch, tag, klt_calls):
    """Recorded LK-level launches (4 a frame, top level first) against the
    plain version, with the live LK iterations and the pixels read for the
    bound. Returns each call's record and the largest absolute error."""
    from msckf_mono_tpu_torch.ops import klt_cuda

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
    return levels, worst


def _klt_replay(torch, tag, klt_calls, track, levels, worst):
    """The kernel, device and plain times and the bound of the first
    recorded frame's four LK levels; ``levels`` and ``worst`` are
    _klt_compare_calls' result on the same calls."""
    from msckf_mono_tpu_torch.ops import klt_cuda

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
    return klt


GRAPH_EAGER_FRAMES = 60       # frames run both eagerly and from the graph
GRAPH_POS_ATOL_M = 1e-3       # positions, where replay and eager are not bit-equal


def _tree_equal(torch, a, b):
    from msckf_mono_tpu_torch.ops import cuda_graph

    la, lb = cuda_graph.flatten(a)[0], cuda_graph.flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def phase_graph(torch, tag, step, static, make, frames, main):
    """A path's step replayed from its cached graph against the same step
    run eagerly, on the same inputs: the first GRAPH_EAGER_FRAMES frames,
    one at a time with the device synchronized after each (per-frame times,
    synchronizing calls), then 3 frames of each under the profiler. Replay
    must equal eager bit for bit, or else have every counter and launch
    count equal and positions within GRAPH_POS_ATOL_M."""
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import sharding

    n = GRAPH_EAGER_FRAMES
    at = lambda t: tree_map(lambda x: x[t], frames)
    runs = {}
    for mode in ("eager", "replay"):
        carry = make()
        graph = cuda_graph.step_graph(step, carry, (at(0),), static) if mode == "replay" else None
        replays = graph.replays if graph is not None else 0
        syncs, times, pos = SyncCounter(torch), [], []
        torch.cuda.synchronize()
        _zero_counts()
        for t in range(n):
            t0 = time.perf_counter()
            with syncs:
                if graph is None:
                    carry, out = step(carry, at(t), *static)
                else:
                    carry, out = graph(carry, at(t))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            pos.append(out.p_I_G.clone())
        state = carry[0] if isinstance(carry, tuple) else carry
        runs[mode] = dict(carry=cuda_graph.clone(carry), pos=torch.stack(pos), launches=_counts(),
                          syncs=syncs.count / n, p50=_percentile(times, 50), p99=_percentile(times, 99),
                          rate=n / (sum(times) / 1e3),
                          metrics={k: int(v) for k, v in sharding.fleet_metrics(state).items()
                                   if k.startswith("total")},
                          diag={k: v.clone() for k, v in vars(state.diag).items()},
                          replays=(graph.replays - replays) if graph is not None else 0)
    e, r = runs["eager"], runs["replay"]
    same = _tree_equal(torch, e["carry"], r["carry"]) and torch.equal(e["pos"], r["pos"])
    err = float((e["pos"] - r["pos"]).abs().max())
    log(f"[{tag}] {n} frames, eager against replayed from the cached graph ({r['replays']} "
        f"replays): bit-equal {same}; max position difference {err:.3e} m; counters eager "
        f"{e['metrics']}, replay {r['metrics']}; launches (FAST, KLT, gamma, triangulate, Shi-Tomasi) eager "
        f"{e['launches']}, replay {r['launches']}")
    check(r["replays"] == n, f"[{tag}] {r['replays']} replays over {n} frames")
    check(e["launches"] == r["launches"], f"[{tag}] launches differ")
    check(r["launches"][3] == 2 * n, f"[{tag}] {r['launches'][3]} triangulate launches over {n} frames")
    check(e["metrics"] == r["metrics"], f"[{tag}] counters differ")
    check(all(torch.equal(e["diag"][k], r["diag"][k]) for k in e["diag"]),
          f"[{tag}] per-filter diagnostics differ")
    check(same or err <= GRAPH_POS_ATOL_M, f"[{tag}] positions differ by {err:.3e} m")
    with cuda_graph.disabled():
        eager_profile = phase_profile(torch, f"{tag}-eager-profile", main["profile_go"],
                                      1e3 / e["rate"])
    p = main["profile"]
    log(f"[{tag}] per frame, eager / replay: {e['p50']:.2f} / {r['p50']:.2f} ms p50, "
        f"{e['p99']:.2f} / {r['p99']:.2f} ms p99 (device synchronized each frame); "
        f"{e['rate']:.2f} / {r['rate']:.2f} frames/s over {n} frames, the main run "
        f"{1e3 / main['frame_ms']:.2f} frames/s; device busy {100 * eager_profile['busy_share']:.1f}% / "
        f"{100 * p['busy_share']:.1f}%; device ops {eager_profile['ops']:.0f} / {p['ops']:.0f} and "
        f"graph launches {eager_profile['graph_launches']:.1f} / {p['graph_launches']:.1f} a frame; "
        f"synchronizing calls {e['syncs']:.2f} / {r['syncs']:.2f} a frame; peak memory "
        f"{main['peak_gib']:.2f} GiB allocated, {main['reserved_gib']:.2f} GiB reserved with the "
        f"graph's pool")
    return dict(frames=n, bit_equal=same, max_pos_diff_m=err,
                eager={k: e[k] for k in ("p50", "p99", "rate", "syncs")},
                replay={k: r[k] for k in ("p50", "p99", "rate", "syncs")},
                launches=list(r["launches"]), eager_profile=eager_profile, replay_profile=p,
                main_frames_per_s=1e3 / main["frame_ms"], peak_gib=main["peak_gib"],
                reserved_gib=main["reserved_gib"], capture_s=main["capture_s"])


def phase_timing(torch, main):
    """eval/timing.stage_timing at the filter path's serving configuration
    and batch, on bench.py --stages' inputs: the main run's final state
    propagated, augmented and updated by the last frame, that frame, and
    the tracks it staged. Device time per call of each stage (4 chained
    calls in one replayed graph), with its flops and bytes counted by hand
    over one eager call (the definitions are in stage_timing's docstring)."""
    from msckf_mono_tpu_torch.core import augment, tracks
    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.eval import timing

    cfg, frames = main["cfg"], main["frames"]
    f = msckf_filter.frame_at(frames, frames.time.shape[0] - 1)
    s = msckf_filter.propagate_block(main["final"], f, cfg)
    s = augment.augment_state(s, f.state_id, f.time, cfg)
    s, staged = tracks.update_tracks(s, f.tracked_uv, f.tracked_ids, f.tracked_valid, cfg)
    t0 = time.perf_counter()
    table = timing.stage_timing(s, f, staged, cfg, reps=4, cost=True)
    check(tuple(table) == timing.STAGES, f"[timing] stages {tuple(table)}")
    B = s.P.shape[0]
    log(f"[timing] eval/timing.stage_timing, serving config, {B} filters, f32, 4 chained calls a "
        f"replayed graph ({time.perf_counter() - t0:.1f} s); flops: the matrix-product family only "
        f"(FlopCounterMode); bytes: every non-view operator's operands and results; the "
        f"hand-written kernels' own reads and arithmetic are in neither")
    log(f"[timing]   {'stage':20s} {'ms':>9s} {'GFLOP':>8s} {'GB':>8s} {'GB/s':>8s} {'TFLOP/s':>8s}")
    rows = {}
    for name, (sec, flops, nbytes) in table.items():
        check(sec > 0 and np.isfinite(sec), f"[timing] {name}: {sec} s")
        rows[name] = dict(ms=sec * 1e3, gflop=flops / 1e9, gbytes=nbytes / 1e9)
        log(f"[timing]   {name:20s} {sec * 1e3:9.3f} {flops / 1e9:8.2f} {nbytes / 1e9:8.3f} "
            f"{nbytes / sec / 1e9:8.1f} {flops / sec / 1e12:8.3f}")
    return rows


def phase_profile(torch, tag, go, frame_ms):
    """Where a frame's time goes: device time by kernel over PROFILE_FRAMES
    frames of a path (``go`` runs them; ``eval/profile.trace``), the
    device's busy share of a frame, device operations and graph launches a
    frame, and the hand-written kernels' device time a frame. The profiler
    slows the host, so the busy share is taken against ``frame_ms``, the
    unprofiled frame time of the path's main run."""
    import tempfile

    from msckf_mono_tpu_torch.eval import profile as port_profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with port_profile.trace(logdir):
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    prof = port_profile.trace.last
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                   and e.name in ("cudaGraphLaunch", "cuGraphLaunch"))
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    busy = busy_ms / PROFILE_FRAMES
    check(busy > 0, f"[{tag}] the profiler saw no device time")
    rows = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    mine = {}
    for a in rows:
        for name, prefix in (("gamma", "gamma_"), ("fast", "fast_nms"), ("klt", "klt_"),
                             ("triangulate", "triangulate_"), ("shi_tomasi", "shi_tomasi_")):
            if a.key.startswith(prefix) or f" {prefix}" in a.key or f"::{prefix}" in a.key:
                t, n = mine.get(name, (0.0, 0.0))
                mine[name] = (t + a.self_device_time_total / 1e3 / PROFILE_FRAMES,
                              n + a.count / PROFILE_FRAMES)
    out = dict(wall_ms=wall_ms / PROFILE_FRAMES, busy_ms=busy, busy_share=busy / frame_ms,
               ops=len(kernels) / PROFILE_FRAMES, graph_launches=launches / PROFILE_FRAMES,
               kernels={k: dict(ms=t, calls=n) for k, (t, n) in mine.items()})
    log(f"[{tag}] {PROFILE_FRAMES} frames under the profiler: wall {wall_ms:.1f} ms, "
        f"{out['ops']:.0f} device ops/frame, {out['graph_launches']:.1f} graph launches/frame, "
        f"device busy {busy:.2f} ms/frame = {100 * busy / frame_ms:.1f}% of the unprofiled "
        f"{frame_ms:.2f} ms/frame; hand-written kernels a frame: "
        + ", ".join(f"{k} {v['ms']:.4f} ms in {v['calls']:.0f} launches"
                    for k, v in out["kernels"].items()))
    for a in rows[:15]:
        log(f"[{tag}]   {a.self_device_time_total / 1e3 / PROFILE_FRAMES:9.3f} ms/frame "
            f"{a.count / PROFILE_FRAMES:8.1f} calls/frame  {a.key[:90]}")
    return out


def _union_ms(spans):
    """Length of the union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


# The live path: the default MsckfConfig (28 slots, 128 tracks, state dim
# 183, sequential marginalize and prune updates, max_staged 16) at B = 1.
LIVE_FRAMES, LIVE_PARITY_FRAMES = 200, 60
LIVE_REPLAY = range(30, 34)                  # frames whose launches are recorded
LIVE_TH = dict(window_size=IMAGE_WINDOW, max_level=3)   # VioInterface's default 128 features
CLI_TH_FEATURES = 100                        # run_euroc's TrackHandler
CAMERA_PERIOD_MS = 50.0                      # 20 Hz
GT_INIT = dict(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4])


def live_expected_launches(cfg, frames, finish=True):
    """Exact launches of a live run of ``frames`` frames: FAST once a frame,
    KLT once a level from the second frame on, gamma once a chunk of each
    gated row stack (marginalize, then prune), triangulate once a stack, and
    in finish() gamma once a chunk and triangulate once for each of its
    passes; Shi-Tomasi once a frame (the live front-end's "highest" tier)."""
    shp = cfg.shapes
    marg = shp.max_staged // min(shp.staged_chunk, shp.max_staged)
    prune = shp.max_staged_prune // min(shp.prune_chunk or shp.staged_chunk, shp.max_staged_prune)
    per_frame = marg + (prune if cfg.filter.use_prune_redundant else 0)
    passes = -(-shp.max_tracks // shp.max_staged)
    return (frames, 4 * (frames - 1), per_frame * frames + (passes * marg if finish else 0),
            triangulations_per_step(cfg) * frames + (passes if finish else 0), frames)


class SyncCounter:
    """Counts synchronizing CUDA calls (torch.cuda.set_sync_debug_mode("warn")
    warns on each: device→host copies, blocking host→device copies, stream and
    device syncs) while it is entered, and the Python line of each."""

    def __init__(self, torch):
        import collections

        self.torch, self.count, self.sites = torch, 0, collections.Counter()

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        for w in self._caught:
            if "synchroniz" in str(w.message):
                self.count += 1
                self.sites[f"{'/'.join(w.filename.split('/')[-2:])}:{w.lineno}"] += 1
        self._catch.__exit__(*exc)

    def summary(self, frames):
        return ", ".join(f"{site} {n / frames:.2f}" for site, n in self.sites.most_common())


class LaunchRecorder:
    """While on, records every gamma, FAST and KLT launch's inputs and
    outputs (and each gate's dof) by wrapping the wrappers in their modules;
    the wrapped calls are the path's own launches."""

    def __init__(self):
        from msckf_mono_tpu_torch.core import update
        from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

        self.mods = dict(update=update, fast=fast_cuda, klt=klt_cuda, psd=psd_cuda)
        self.orig = dict(gate=update.gating_test_all, fast=fast_cuda.fast_nms_score,
                         klt=klt_cuda.track_level, gamma=psd_cuda.gamma_psd)
        self.gamma, self.dofs, self.fast, self.klt = [], [], [], []

    def on(self):
        o = self.orig

        def gamma(Smat, r):
            out = o["gamma"](Smat, r)
            self.gamma.append((Smat.clone(), r.clone(), out.clone()))
            return out

        def gate(H_all, r_all, P, dof, *args):
            self.dofs.append(dof.clone())
            return o["gate"](H_all, r_all, P, dof, *args)

        def fast(imgs, threshold=20.0):
            out = o["fast"](imgs, threshold)
            self.fast.append((imgs.clone(), threshold, out.clone()))
            return out

        def klt(*args, **kw):
            out = o["klt"](*args, **kw)
            self.klt.append((tuple(a.clone() for a in args), kw, tuple(x.clone() for x in out)))
            return out

        m = self.mods
        m["psd"].gamma_psd, m["update"].gating_test_all = gamma, gate
        m["fast"].fast_nms_score, m["klt"].track_level = fast, klt

    def off(self):
        m, o = self.mods, self.orig
        m["psd"].gamma_psd, m["update"].gating_test_all = o["gamma"], o["gate"]
        m["fast"].fast_nms_score, m["klt"].track_level = o["fast"], o["klt"]


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_live_data(torch, cfg, imgs, root):
    """The rendered world written as a EuRoC tree by the port's writer and
    read back by its readers: images bit-equal to the rendered frames."""
    from msckf_mono_tpu_torch.data import asl, native_loader, synthetic, write_asl

    T = imgs.shape[0]
    seq, world = synthetic.generate(cfg, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                                    return_world=True)
    t0 = time.perf_counter()
    info = write_asl.write_sequence(root, cfg, seq, world)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = asl.read_sequence(root)
    want = imgs.to(torch.uint8).cpu().numpy()
    with rd.cam.prefetcher() as pf:
        for i in range(T):
            got = pf.get(i)
            check(np.array_equal(got, want[i]), f"[live-data] frame {i} differs from the rendered "
                  f"frame on {int((got != want[i]).sum())} pixels")
    t_read = time.perf_counter() - t0
    check(len(rd.cam.timestamps) == T and rd.gt is not None, "[live-data] tree incomplete")
    log(f"[live-data] EuRoC tree of {T} frames written in {t_write:.1f} s (data/write_asl.py, "
        f"zlib PNG writer) and read back in {t_read:.1f} s; every image bit-equal to the rendered "
        f"frame; decoder: {native_loader.decoder()}; IMU {rd.imu.omega.shape[0]} readings, "
        f"ground truth {rd.gt.p.shape[0]} poses")
    return info, native_loader.decoder()


def phase_live_cli(torch, root, info, frames):
    """cli/run_euroc on the card over the written tree: GT init, --finish."""
    import contextlib
    import io

    from msckf_mono_tpu_torch import interface
    from msckf_mono_tpu_torch.cli import run_euroc
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    out = f"{root}/traj.npz"
    argv = ["--data", root, "--init", "gt", "--stand-still-end", str(info["t0_ns"] / 1e9),
            "--finish", "--out", out]
    copies = [0]
    unpack = interface._unpack                # every host copy of the interface's ends here

    def counted(flat, like):
        copies[0] += 1
        return unpack(flat, like)

    torch.cuda.synchronize()
    _zero_counts()
    interface._unpack = counted
    try:
        with SyncCounter(torch) as syncs, contextlib.redirect_stdout(io.StringIO()):
            report = run_euroc.main(argv)
    finally:
        interface._unpack = unpack
    launches = _counts()
    dat = np.load(out)
    cfg = MsckfConfig()
    want = live_expected_launches(cfg, frames)
    log(f"[live-cli] cli/run_euroc on cuda, {report['frames']} frames, TrackHandler "
        f"{CLI_TH_FEATURES} features / {IMAGE_WINDOW} px / 4 levels, default MsckfConfig: "
        f"{report['fps']} frames/s ({report['wall_s']} s), ATE {report['ate_rmse']:.4f} m "
        f"(limit {ATE_GATE_M}), final drift {report['final_drift']:.4f} m")
    log(f"[live-cli] map {len(dat['map'])} points, {len(dat['pruned_state_id'])} pruned poses; "
        f"launches FAST {launches[0]}, KLT {launches[1]}, gamma {launches[2]}, triangulate "
        f"{launches[3]}, Shi-Tomasi {launches[4]} (expected {want}); device->host copies {copies[0]} "
        f"({copies[0] / frames:.2f} a frame), synchronizing CUDA calls {syncs.count} "
        f"({syncs.count / frames:.2f} a frame: {syncs.summary(frames)})")
    check(report["frames"] == frames, f"[live-cli] {report['frames']} frames, expected {frames}")
    check(np.all(np.isfinite(dat["est"])), "[live-cli] non-finite trajectory")
    check(report["final_drift"] < 1.0, f"[live-cli] final drift {report['final_drift']:.4f} m >= 1 m")
    check(tuple(launches) == want, f"[live-cli] launches {launches}, expected {want}")
    return dict(report=report, map_points=len(dat["map"]), pruned=len(dat["pruned_state_id"]),
                launches=dict(zip(LAUNCH_KEYS, launches)),
                host_copies_per_frame=copies[0] / frames, syncs_per_frame=syncs.count / frames)


def _live_frame(torch, vio, seq, imgs_host, i, latencies=None, syncs=None, per_frame=None):
    """Frame i: its IMU readings at 200 Hz through imu_callback, then the
    image through image_callback, timed with the device synchronized;
    ``per_frame`` gets the frame's count of synchronizing calls."""
    K = seq.imu_omega.shape[1]
    for k in range(K):
        vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                         float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
    t0 = time.perf_counter()
    if syncs is not None:
        before = syncs.count
        with syncs:
            ran = vio.image_callback(imgs_host[i], float(seq.time[i]))
        if per_frame is not None:
            per_frame.append(syncs.count - before)
    else:
        ran = vio.image_callback(imgs_host[i], float(seq.time[i]))
    torch.cuda.synchronize()
    if latencies is not None:
        latencies.append((time.perf_counter() - t0) * 1e3)
    check(ran, f"frame {i}: the filter did not run")


def _live_interface(cfg, seq):
    from msckf_mono_tpu_torch.interface import VioInterface

    vio = VioInterface(cfg, device="cuda", keep_visualizer=True, track_handler_kwargs=LIVE_TH)
    vio.initialize_from_ground_truth(**GT_INIT, b_g=seq.b_g, b_a=seq.b_a)
    return vio


def phase_live(torch, tag, seq, imgs, frames, cfg, recorder=None):
    """VioInterface on the card over the rendered world, then finish();
    ``recorder`` records the launches of frames LIVE_REPLAY."""
    from msckf_mono_tpu_torch.eval.ate import ate_rmse, final_drift

    from msckf_mono_tpu_torch.ops import cuda_graph

    imgs_host = imgs[:frames].cpu().numpy()
    vio = _live_interface(cfg, seq)
    est, lat, ids, per_frame = [], [], [], []
    syncs = SyncCounter(torch)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for i in range(frames):
        if recorder is not None and i in LIVE_REPLAY:
            # the recorded frames run eagerly: a replayed graph calls no Python
            recorder.on()
            with cuda_graph.disabled():
                _live_frame(torch, vio, seq, imgs_host, i, lat, syncs, per_frame)
            recorder.off()
        else:
            _live_frame(torch, vio, seq, imgs_host, i, lat, syncs, per_frame)
        est.append(vio.odometry()["p_I_G"])
        ids.append(vio.track_handler.cur_ids[0].cpu().numpy().copy())
    n_map_before = len(vio.map())
    t1 = time.perf_counter()
    vio.finish()
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t1) * 1e3
    seconds = time.perf_counter() - t0
    launches = _counts()
    want = live_expected_launches(cfg, frames)
    est = np.asarray(est)
    check(np.all(np.isfinite(est)), f"[{tag}] non-finite trajectory")
    ate, drift = ate_rmse(est, seq.gt_p[:frames]), final_drift(est, seq.gt_p[:frames])
    cs, pruned, overlay = vio.cam_states(), vio.pruned_states(), vio.track_overlay()
    # latency of the replayed frames: not the first (eager), the second (the
    # capture) or the recorded ones (eager)
    eager_frames = {0, 1} | (set(LIVE_REPLAY) if recorder is not None else set())
    replayed = [x for i, x in enumerate(lat) if i not in eager_frames]
    p50, p99 = _percentile(replayed, 50), _percentile(replayed, 99)
    log(f"[{tag}] VioInterface on cuda, {frames} frames, default MsckfConfig"
        f"{' + use_qr_compression + use_anisotropic_r' if cfg.filter.use_qr_compression else ''}, "
        f"TrackHandler 128 features / {IMAGE_WINDOW} px / 4 levels: image_callback of the "
        f"{len(replayed)} replayed frames p50 {p50:.2f} ms, p99 {p99:.2f} ms, max {max(replayed):.2f} "
        f"ms (camera period {CAMERA_PERIOD_MS:.0f} ms: "
        f"{'kept up' if p99 <= CAMERA_PERIOD_MS else 'NOT kept up'}); all {frames} frames p50 "
        f"{_percentile(lat, 50):.2f} ms, p99 {_percentile(lat, 99):.2f} ms; the first frame "
        f"{lat[0]:.1f} ms, the second (capture) {lat[1]:.1f} ms; {frames / seconds:.2f} frames/s "
        f"over {seconds:.1f} s incl. finish() {finish_ms:.1f} ms")
    log(f"[{tag}] ATE {ate:.4f} m (limit {ATE_GATE_M}), final drift {drift:.4f} m; map "
        f"{n_map_before} points before finish(), {len(vio.map())} after; {len(pruned['state_id'])} "
        f"pruned poses; window {len(cs['state_id'])} poses; map_points() {vio.map_points().shape}; "
        f"overlay {overlay.shape} {overlay.dtype}")
    log(f"[{tag}] launches FAST {launches[0]}, KLT {launches[1]}, gamma {launches[2]}, triangulate "
        f"{launches[3]}, Shi-Tomasi {launches[4]} (expected {want}); device->host copies "
        f"{vio.host_copies} "
        f"({vio.host_copies / frames:.2f} a frame), synchronizing CUDA calls in image_callback "
        f"{syncs.count} ({syncs.count / frames:.2f} a frame: {syncs.summary(frames)})")
    replays = sum(g.replays for g in vio._live_frame.graphs.values())
    steady = [c for i, c in enumerate(per_frame) if i >= 2]       # after the capture at frame 2
    log(f"[{tag}] {replays} frames replayed from the captured frame graph "
        f"({frames - replays} eager: the first, and the recorded ones); synchronizing calls a "
        f"frame from the third frame on: max {max(steady)}, mean {np.mean(steady):.2f}")
    check(drift < 1.0, f"[{tag}] final drift {drift:.4f} m >= 1 m")
    check(tuple(launches) == want, f"[{tag}] launches {launches}, expected {want}")
    check(overlay.shape == (cfg.camera.height, cfg.camera.width, 3), f"[{tag}] overlay {overlay.shape}")
    check(len(vio.map()) >= n_map_before > 0, f"[{tag}] map {n_map_before} -> {len(vio.map())}")
    check(max(steady) <= 1, f"[{tag}] {max(steady)} synchronizing calls in a frame: more than the "
          f"frame's one copy back")
    n_eager = 1 + (len(LIVE_REPLAY) if recorder is not None else 0)
    check(replays == frames - n_eager, f"[{tag}] {replays} replayed frames of {frames}")
    return dict(frames=frames, p50_ms=p50, p99_ms=p99, max_ms=max(replayed),
                p50_all_ms=_percentile(lat, 50), p99_all_ms=_percentile(lat, 99),
                first_ms=lat[0], capture_frame_ms=lat[1], frames_per_s=frames / seconds,
                finish_ms=finish_ms, ate=ate, final_drift=drift, map_points=len(vio.map()),
                pruned=len(pruned["state_id"]), launches=dict(zip(LAUNCH_KEYS, launches)),
                host_copies_per_frame=vio.host_copies / frames, syncs_per_frame=syncs.count / frames,
                steady_syncs_max=max(steady), replayed_frames=replays,
                _ids=np.asarray(ids), _pos=est, _lat=lat)


def phase_live_profile(torch, seq, imgs, cfg, frame_ms):
    """Where a live frame's time goes: frames 30-32 of a fresh run under the profiler."""
    lo = LIVE_REPLAY[0]
    imgs_host = imgs[:lo + PROFILE_FRAMES].cpu().numpy()
    vio = _live_interface(cfg, seq)
    for i in range(lo):
        _live_frame(torch, vio, seq, imgs_host, i)

    def go():
        for i in range(lo, lo + PROFILE_FRAMES):
            _live_frame(torch, vio, seq, imgs_host, i)

    return phase_profile(torch, "live-profile", go, frame_ms)


def phase_live_graph(torch, seq, imgs, cfg, live, live_profile):
    """VioInterface under cuda_graph.disabled() (every frame eager) over the
    first GRAPH_EAGER_FRAMES frames of [live]'s inputs, against [live]'s
    frames (replayed from the second on, bar the recorded ones): the
    tracker's ids equal on every frame and positions within
    GRAPH_POS_ATOL_M (bit-equality printed), launches as expected; then the
    per-frame latency, synchronizing calls, device-busy share, device
    operations and graph launches of both (frames 30-32 of the eager run
    under the profiler)."""
    from msckf_mono_tpu_torch.ops import cuda_graph

    n = GRAPH_EAGER_FRAMES
    imgs_host = imgs[:n].cpu().numpy()
    vio = _live_interface(cfg, seq)
    lat, ids, pos, per_frame = [], [], [], []
    syncs = SyncCounter(torch)
    lo = LIVE_REPLAY[0]
    profile = None
    torch.cuda.synchronize()
    _zero_counts()
    with cuda_graph.disabled():
        for i in range(n):
            if i == lo:
                def go():
                    for j in range(lo, lo + PROFILE_FRAMES):
                        _live_frame(torch, vio, seq, imgs_host, j)
                        ids.append(vio.track_handler.cur_ids[0].cpu().numpy().copy())
                        pos.append(vio.odometry()["p_I_G"])
                profile = phase_profile(torch, "live-graph-eager-profile", go, live["p50_ms"])
            if lo <= i < lo + PROFILE_FRAMES:
                continue
            _live_frame(torch, vio, seq, imgs_host, i, lat, syncs, per_frame)
            ids.append(vio.track_handler.cur_ids[0].cpu().numpy().copy())
            pos.append(vio.odometry()["p_I_G"])
    launches = _counts()
    want = live_expected_launches(cfg, n, finish=False)
    ids, pos = np.asarray(ids), np.asarray(pos)
    same = np.array_equal(ids, live["_ids"][:n]) and np.array_equal(pos, np.asarray(live["_pos"][:n]))
    err = float(np.abs(pos - np.asarray(live["_pos"][:n])).max())
    p50, p99 = _percentile(lat, 50), _percentile(lat, 99)
    eager_busy = profile["busy_ms"] / p50
    log(f"[live-graph] {n} frames eager against [live]: ids equal on every frame "
        f"{np.array_equal(ids, live['_ids'][:n])}, bit-equal {same}, max position difference "
        f"{err:.3e} m; eager launches {launches} (expected {want})")
    log(f"[live-graph] image_callback eager / replay: p50 {p50:.2f} / {live['p50_ms']:.2f} ms, p99 "
        f"{p99:.2f} / {live['p99_ms']:.2f} ms (camera period {CAMERA_PERIOD_MS:.0f} ms); device busy "
        f"{100 * eager_busy:.1f}% / {100 * live_profile['busy_share']:.1f}%; device ops "
        f"{profile['ops']:.0f} / {live_profile['ops']:.0f} and graph launches "
        f"{profile['graph_launches']:.1f} / {live_profile['graph_launches']:.1f} a frame; "
        f"synchronizing calls {syncs.count / len(lat):.2f} / {live['syncs_per_frame']:.2f} a frame "
        f"({syncs.summary(len(lat))}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved with the "
        f"graphs' pools since the image phases")
    check(np.array_equal(ids, live["_ids"][:n]), "[live-graph] the tracker's ids differ")
    check(same or err <= GRAPH_POS_ATOL_M, f"[live-graph] positions differ by {err:.3e} m")
    check(tuple(launches) == want, f"[live-graph] launches {launches}, expected {want}")
    return dict(frames=n, bit_equal=same, max_pos_diff_m=err,
                eager=dict(p50=p50, p99=p99, syncs=syncs.count / len(lat), busy_share=eager_busy,
                           ops=profile["ops"], graph_launches=profile["graph_launches"]),
                replay=dict(p50=live["p50_ms"], p99=live["p99_ms"], syncs=live["syncs_per_frame"],
                            steady_syncs_max=live["steady_syncs_max"],
                            busy_share=live_profile["busy_share"], ops=live_profile["ops"],
                            graph_launches=live_profile["graph_launches"]),
                eager_profile=profile, replay_profile=live_profile)


def phase_live_ransac(torch, seq, imgs, cfg, live):
    """[live-ransac]: VioInterface with two-point RANSAC on over [live]'s
    frames, GT init, then finish(): the hypothesis pairs drawn on the card
    from the tracker's carried key inside the frame's graph (one replay a
    frame from the second image on); latency, syncs, launches, ATE; then
    the first GRAPH_EAGER_FRAMES frames under cuda_graph.disabled(), whose
    ids and positions must equal the replayed run's bit for bit, with the
    launches of frames LIVE_REPLAY recorded there and held against the
    plain versions (so they are the replayed run's launches too). A smoke
    and launch-count check only: the timed measurement of the path is the
    benchmark cell live-b1-ransac."""
    import contextlib

    from msckf_mono_tpu_torch.eval.ate import ate_rmse, final_drift
    from msckf_mono_tpu_torch.interface import VioInterface
    from msckf_mono_tpu_torch.ops import cuda_graph

    frames = imgs.shape[0]
    imgs_host = imgs.cpu().numpy()

    def run(n, eager, recorder=None):
        vio = VioInterface(cfg, device="cuda", track_handler_kwargs=dict(LIVE_TH, use_ransac=True))
        vio.initialize_from_ground_truth(**GT_INIT, b_g=seq.b_g, b_a=seq.b_a)
        lat, ids, pos, per_frame = [], [], [], []
        syncs = SyncCounter(torch)
        torch.cuda.synchronize()
        _zero_counts()
        with cuda_graph.disabled() if eager else contextlib.nullcontext():
            for i in range(n):
                if recorder is not None and i in LIVE_REPLAY:
                    recorder.on()
                _live_frame(torch, vio, seq, imgs_host, i, lat, syncs, per_frame)
                if recorder is not None:
                    recorder.off()
                pos.append(vio.odometry()["p_I_G"])
                ids.append(vio.track_handler.cur_ids[0].cpu().numpy().copy())
            if not eager:
                vio.finish()
                torch.cuda.synchronize()
        return dict(vio=vio, lat=lat, ids=np.asarray(ids), pos=np.asarray(pos),
                    per_frame=per_frame, syncs=syncs, launches=_counts())

    r = run(frames, eager=False)
    vio = r["vio"]
    replays = sum(g.replays for g in vio._live_frame.graphs.values())
    per_image = replays / (frames - 1)
    replayed = r["lat"][2:]                       # after the eager first frame and the capture
    p50, p99 = _percentile(replayed, 50), _percentile(replayed, 99)
    steady = r["per_frame"][2:]
    want = live_expected_launches(cfg, frames)
    est = r["pos"]
    check(np.all(np.isfinite(est)), "[live-ransac] non-finite trajectory")
    ate, drift = ate_rmse(est, seq.gt_p[:frames]), final_drift(est, seq.gt_p[:frames])
    tracked, tracked_off = int((r["ids"] >= 0).sum()), int((live["_ids"] >= 0).sum())
    n = GRAPH_EAGER_FRAMES
    rec = LaunchRecorder()
    e = run(n, eager=True, recorder=rec)
    e_p50, e_p99 = _percentile(e["lat"], 50), _percentile(e["lat"], 99)
    same = np.array_equal(e["ids"], r["ids"][:n]) and np.array_equal(e["pos"], r["pos"][:n])
    want_e = live_expected_launches(cfg, n, finish=False)
    log(f"[live-ransac] VioInterface on cuda with two-point RANSAC on, {frames} frames, default "
        f"MsckfConfig, GT init, finish(): {replays} frames replayed from the captured frame graph "
        f"({per_image:.2f} graph launches an image from the second on); image_callback p50 "
        f"{p50:.2f} ms, p99 {p99:.2f} ms of the {len(replayed)} replayed frames (camera period "
        f"{CAMERA_PERIOD_MS:.0f} ms: {'kept up' if p99 <= CAMERA_PERIOD_MS else 'NOT kept up'}; "
        f"[live] with RANSAC off p50 {live['p50_ms']:.2f} ms, p99 {live['p99_ms']:.2f} ms); a smoke "
        f"and launch-count check: the timed measurement is the benchmark cell live-b1-ransac")
    log(f"[live-ransac] eager (cuda_graph.disabled()), the first {n} frames: p50 {e_p50:.2f} ms, "
        f"p99 {e_p99:.2f} ms; bit-equal to the replayed run (ids and positions) {same}")
    log(f"[live-ransac] synchronizing calls a frame {r['syncs'].count / frames:.2f} (from the third "
        f"frame on: max {max(steady)}; {r['syncs'].summary(frames)}); launches FAST "
        f"{r['launches'][0]}, KLT {r['launches'][1]}, gamma {r['launches'][2]}, triangulate "
        f"{r['launches'][3]}, Shi-Tomasi {r['launches'][4]} (expected {want}); ATE(filter 0) {ate:.4f} m ([live] {live['ate']:.4f} m), "
        f"final drift {drift:.4f} m; tracked feature-frames {tracked} ({tracked_off} with RANSAC off)")
    check(replays == frames - 1, f"[live-ransac] {replays} replayed frames of {frames}")
    check(same, "[live-ransac] the replayed frames differ from the eager ones")
    check(tuple(r["launches"]) == want, f"[live-ransac] launches {r['launches']}, expected {want}")
    check(tuple(e["launches"]) == want_e, f"[live-ransac] eager launches {e['launches']}, "
          f"expected {want_e}")
    check(max(steady) <= 1, f"[live-ransac] {max(steady)} synchronizing calls in a frame")
    check(drift < 1.0, f"[live-ransac] final drift {drift:.4f} m >= 1 m")
    err = _live_compare(torch, "live-ransac", cfg, rec)
    return dict(max_abs_err={k: err[k] for k in ("gamma", "fast", "klt")},frames=frames, replayed_frames=replays, graph_launches_per_image=per_image,
                p50_ms=p50, p99_ms=p99, max_ms=max(replayed), eager_frames=n, eager_p50_ms=e_p50,
                eager_p99_ms=e_p99, bit_equal=same, syncs_per_frame=r["syncs"].count / frames,
                steady_syncs_max=max(steady), ate=ate, final_drift=drift,
                tracked_feature_frames=tracked, tracked_feature_frames_ransac_off=tracked_off,
                launches=dict(zip(LAUNCH_KEYS, r["launches"])))


def _live_compare(torch, tag, cfg, rec):
    """The launches of the LIVE_REPLAY frames recorded in ``rec`` against
    the plain versions on the same inputs: gamma within 1e-3 relative with
    identical gate decisions, FAST bit-equal, KLT as _klt_compare holds it.
    Returns each kernel's largest absolute error."""
    from msckf_mono_tpu_torch.ops import fast_cuda, psd_cuda
    from msckf_mono_tpu_torch.utils.chi2 import gate_threshold

    n = len(LIVE_REPLAY)
    want = live_expected_launches(cfg, n, finish=False)
    check((len(rec.fast), len(rec.klt), len(rec.gamma), len(rec.dofs)) == (n, 4 * n, want[2], want[2]),
          f"[{tag}] recorded FAST {len(rec.fast)}, KLT {len(rec.klt)}, gamma {len(rec.gamma)}, "
          f"gates {len(rec.dofs)} over {n} frames")
    # gamma: within 1e-3 relative, identical gate decisions
    rel_max, abs_max, lanes, same, passed = 0.0, 0.0, 0, 0, 0
    for (Smat, r, got), dof in zip(rec.gamma, rec.dofs):
        ref = psd_cuda.gamma_psd_plain(Smat, r)
        thr = gate_threshold(dof, reproduce_offbyone=cfg.filter.chi2_offbyone, dtype=torch.float32)
        fin = torch.isfinite(ref)
        check(torch.equal(torch.isfinite(got), fin), f"[{tag}] gamma: finite lanes differ")
        if bool(fin.any()):
            err = (got[fin] - ref[fin]).abs()
            rel_max = max(rel_max, (err / ref[fin].abs().clamp_min(1e-30)).max().item())
            abs_max = max(abs_max, err.max().item())
        lanes += got.numel()
        same += int(((got < thr) == (ref < thr)).sum())
        passed += int(((ref < thr) & (r != 0).any(-1)).sum())
    shape = tuple(rec.gamma[0][0].shape)
    log(f"[{tag}] gamma: {len(rec.gamma)} launches on S {shape} "
        f"({psd_cuda.launch_plan(shape[-1]).variant} variant): max rel err {rel_max:.2e}, max abs err "
        f"{abs_max:.3e}; decisions identical on {same}/{lanes} lanes ({passed} pass with rows)")
    check(rel_max <= 1e-3, f"[{tag}] gamma max relative error {rel_max:.3e} > 1e-3")
    check(same == lanes, f"[{tag}] gamma decisions differ on {lanes - same} lanes")

    fast_err = 0.0
    for i, (img, thr, got) in enumerate(rec.fast):
        ref = fast_cuda.fast_nms_score_plain(img, thr)
        fast_err = max(fast_err, float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"[{tag}] FAST frame {i} differs on "
              f"{int((got != ref).sum())} pixels")
    log(f"[{tag}] FAST: {len(rec.fast)} launches on {tuple(rec.fast[0][0].shape)}, each bit-equal "
        f"to the plain version")
    levels, klt_err = _klt_compare_calls(torch, tag, rec.klt)
    return dict(gamma=abs_max, fast=fast_err, klt=klt_err, gamma_max_rel_err=rel_max,
                klt_levels=levels)


def phase_live_replay(torch, cfg, rec):
    """The recorded live launches against the plain versions, then each
    kernel's times at the live shapes."""
    from msckf_mono_tpu_torch.ops import fast_cuda, psd_cuda

    n = len(LIVE_REPLAY)
    want = live_expected_launches(cfg, n, finish=False)
    err = _live_compare(torch, "live-replay", cfg, rec)
    Smat, r, _ = rec.gamma[0]
    R = Smat.shape[-1]
    nsys = Smat.numel() // (R * R)

    def library():
        L, _ = torch.linalg.cholesky_ex(Smat)
        return torch.linalg.solve_triangular(L, r[..., None], upper=False)

    nbytes = nsys * (R * (R + 1) // 2 + R) * 4 + nsys * 4
    flops = nsys * (R ** 3 / 3.0 + R ** 2)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    gamma = dict(R=R, n=nsys, variant=psd_cuda.launch_plan(R).variant,
                 ms=_time_ms(torch, lambda: psd_cuda.gamma_psd(Smat, r)),
                 device_ms=_graph_ms(torch, lambda: psd_cuda.gamma_psd(Smat, r)),
                 plain_ms=_time_ms(torch, lambda: psd_cuda.gamma_psd_plain(Smat, r)),
                 library_ms=_time_ms(torch, library), bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 max_abs_err=err["gamma"], launches_per_frame=want[2] // n)
    log(f"[live-replay] gamma R={R} n={nsys}: kernel {gamma['ms']:.4f} ms a call, "
        f"{gamma['device_ms']:.4f} ms on the device, plain {gamma['plain_ms']:.4f} ms, library "
        f"{gamma['library_ms']:.4f} ms, bound {gamma['bound_ms']:.6f} ms ({gamma['bound_by']})")

    # FAST: its bound on the first recorded image
    img, thr, _ = rec.fast[0]
    bound_ms, bound_by, share = _fast_bound(img, thr)
    fast = dict(shape=list(img.shape), ms=_time_ms(torch, lambda: fast_cuda.fast_nms_score(img, thr)),
                device_ms=_graph_ms(torch, lambda: fast_cuda.fast_nms_score(img, thr)),
                plain_ms=_time_ms(torch, lambda: fast_cuda.fast_nms_score_plain(img, thr), reps=10),
                bound_ms=bound_ms, bound_by=bound_by, candidate_share=share, library_ms=None,
                max_abs_err=err["fast"])
    log(f"[live-replay] FAST on {tuple(img.shape)}: kernel {fast['ms']:.4f} ms a call, {fast['device_ms']:.4f} ms on the "
        f"device, plain {fast['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
        f"{100 * share:.3f}% of the pixels pass the pre-test)")

    klt = _klt_replay(torch, "live-replay", rec.klt, rec.orig["klt"], err["klt_levels"],
                      err["klt"])
    klt["library_ms"] = None
    return dict(gamma=gamma, fast=fast, klt=klt)

def run_live_phases(torch, imgs):
    """[live-data], [live-cli], [live] with the replay recorded,
    [live-profile], [live-graph], [live-ransac], [live-parity] and
    [live-replay], on the rendered frames."""
    import dataclasses as dc
    import shutil
    import tempfile
    from pathlib import Path

    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    cfg = MsckfConfig()
    T = imgs.shape[0]
    seq = synthetic.generate(cfg, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500)
    build = Path(__file__).resolve().parent / "msckf_mono_tpu_torch" / "build"
    build.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="live_tree_", dir=build)
    try:
        info, decoder = phase_live_data(torch, cfg, imgs, root)
        cli = phase_live_cli(torch, root, info, T)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = LaunchRecorder()
    live = phase_live(torch, "live", seq, imgs, T, cfg, recorder=rec)
    live_profile = phase_live_profile(torch, seq, imgs, cfg, live["p50_ms"])
    graph = phase_live_graph(torch, seq, imgs, cfg, live, live_profile)
    ransac = phase_live_ransac(torch, seq, imgs, cfg, live)
    live = {k: v for k, v in live.items() if not k.startswith("_")}
    parity_cfg = dc.replace(cfg, filter=dc.replace(cfg.filter, use_qr_compression=True,
                                                   use_anisotropic_r=True))
    parity = phase_live(torch, "live-parity", seq, imgs, LIVE_PARITY_FRAMES, parity_cfg)
    replay = phase_live_replay(torch, cfg, rec)
    return {"live": live, "live-cli": cli, "live-parity": {k: v for k, v in parity.items()
                                                          if not k.startswith("_")},
            "live-graph": graph, "live-ransac": ransac, "replay": replay, "decoder": decoder}


SHARDED_POS_ATOL = 2e-2        # tests/test_sharding.py:65
GOLDEN_F32_FINDING_M = 1e-2    # an f32 gap to the golden above this is a finding (ROADMAP Queue 3)
MAIN_RECHECK_FRAMES = 10
COUNTERS = ("total_residualized", "total_row_overflow", "total_staged_overflow")
# [sharded] (b)'s largest staged_overflow gap to [main] on the JAX fleet is 1
# (B = 1024, 200 frames); a lost or doubled row moves it by its own count.
STAGED_OVERFLOW_SLACK = 2


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics_match(got, want):
    """Totals and the maximum exactly, the means within 1e-6 relative (the
    mesh's means are f64 sums over counts, the unsharded ones ``torch.mean``)."""
    exact = all(int(got[k]) == int(want[k]) for k in COUNTERS) and \
        float(got["max_pos_cov_trace"]) == float(want["max_pos_cov_trace"])
    means = all(abs(float(got[k]) - float(want[k])) <= 1e-6 * abs(float(want[k]))
                for k in ("mean_pos_cov_trace", "mean_cam_count"))
    return exact and means


def _sharded_setup(torch, tag, mesh, main):
    """One mesh setup of the filter path at the main run's fleet and frames:
    capture on 2 frames, the timed run, the all-reduce's wall time alone."""
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import sharding

    cfg, frames, make = main["cfg"], main["frames"], main["make"]
    T, B = frames.time.shape[:2]
    cuda_graph.clear_cache()
    torch.cuda.empty_cache()
    run = sharding.make_sharded_run(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(sharding.shard_batch(make(), mesh), tree_map(lambda x: x[:2], frames))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    states = sharding.shard_batch(make(), mesh)     # the fleet drawn once, then split
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    final, outs, metrics = run(states, frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gamma_n, tri_n = _counts()[2:4]
    t0 = time.perf_counter()
    sharding.fleet_metrics(final, mesh)
    torch.cuda.synchronize()
    allreduce_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(shards=len(final.shards), frame_ms=1e3 * seconds / T, seconds=seconds,
               frame_steps_per_s=B * T / seconds, gamma_launches=gamma_n,
               triangulate_launches=tri_n, peak_gib=peak,
               capture_s=capture_s, allreduce_ms=allreduce_ms,
               **{k: float(v) for k, v in metrics.items()})
    log(f"[sharded] ({tag}) {len(final.shards)} shard(s) of {B // mesh.size} on "
        f"{[str(d) for d in mesh.devices]}, world {mesh.world_size}: {rec['frame_ms']:.2f} ms a "
        f"frame, {rec['frame_steps_per_s']:.1f} frame-steps/s, gamma launches {gamma_n}, "
        f"triangulate {tri_n}, peak "
        f"memory {peak:.2f} GiB, capture and 2 warm-up frames {capture_s:.2f} s, all-reduce "
        f"{allreduce_ms:.3f} ms; residualized {int(metrics['total_residualized'])}")
    check(gamma_n == 2 * T * len(final.shards),
          f"[sharded] ({tag}) {gamma_n} gamma launches, expected {2 * T * len(final.shards)}")
    check(tri_n == 2 * T * len(final.shards),
          f"[sharded] ({tag}) {tri_n} triangulate launches, expected {2 * T * len(final.shards)}")
    return rec, final, outs, metrics


def phase_sharded(torch, main):
    """The filter path through make_sharded_run in three setups on one card:
    (a) make_mesh() in a one-rank NCCL group, (b) two shards on cuda:0,
    (c) two processes on the card joined by gloo (parallel/two_host_sim)."""
    import os
    import torch.distributed as dist

    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.parallel import sharding

    final, outs = main["final"], main["outs"]
    want = sharding.fleet_metrics(final)
    T, B = main["frames"].time.shape[:2]

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = sharding.make_mesh()
        check(mesh.group is not None and mesh.size == 1, f"[sharded] (a) mesh of {mesh.size}")
        a, a_final, a_outs, a_metrics = _sharded_setup(torch, "a", mesh, main)
    finally:
        dist.destroy_process_group()
    a_equal = (_tree_equal(torch, a_final.gather(), final)
               and _tree_equal(torch, a_outs.gather(), outs))
    log(f"[sharded] (a) bit-equal to [main]: {a_equal}; metrics equal to [main]'s fleet_metrics: "
        f"{_metrics_match(a_metrics, want)}")
    check(a_equal, "[sharded] (a) differs from [main]")
    check(_metrics_match(a_metrics, want), "[sharded] (a) metrics differ from [main]'s")
    del a_final, a_outs

    b, b_final, b_outs, b_metrics = _sharded_setup(
        torch, "b", sharding.make_mesh(["cuda:0", "cuda:0"]), main)
    b_all, b_outs_all = b_final.gather(), b_outs.gather()
    b_equal = _tree_equal(torch, b_all, final) and _tree_equal(torch, b_outs_all, outs)
    b_gap = float((b_outs_all.p_I_G - outs.p_I_G).abs().max())
    # Batched f32 products at B/2 round unlike those at B, so a filter may
    # cross the staging limit on a frame of its own: staged_overflow is held
    # within STAGED_OVERFLOW_SLACK, the other counters exactly. A split that
    # lost or doubled a row would move the total by that row's own count.
    b_so = b_all.diag.staged_overflow
    so = final.diag.staged_overflow
    so_rows = int((b_so != so).sum())
    so_row_min = int(so[so > 0].min()) if bool((so > 0).any()) else 0
    so_gap = abs(int(b_metrics["total_staged_overflow"]) - int(want["total_staged_overflow"]))
    b_counters = all(int(b_metrics[k]) == int(want[k]) for k in COUNTERS[:2])
    # The split itself: each shard against its half of the fleet run alone at
    # B/2 through batched_run_sequence (the same step graph, the same shapes).
    run = sharding.batched_run_sequence(main["cfg"])
    halves = sharding.shard_batch(main["make"](), sharding.make_mesh(["cuda:0", "cuda:0"]))
    halves_equal = True
    for k, half in enumerate(halves.shards):
        n = B // len(halves.shards)
        h_final, h_outs = run(half, tree_map(lambda x: x[:, k * n:(k + 1) * n], main["frames"]))
        halves_equal &= (_tree_equal(torch, h_final, b_final.shards[k])
                         and _tree_equal(torch, h_outs, b_outs.shards[k]))
    b.update(bit_equal=b_equal, max_pos_gap_m=b_gap, counters_equal_main=b_counters,
             staged_overflow_gap=so_gap, staged_overflow_rows_differing=so_rows,
             staged_overflow_row_min=so_row_min, halves_bit_equal=halves_equal)
    log(f"[sharded] (b) each shard bit-equal to its half of the fleet run alone at B = {B // 2}: "
        f"{halves_equal}; bit-equal to [main] (B = {B}): {b_equal}; max position gap to [main] "
        f"{b_gap:.3e} m (limit {SHARDED_POS_ATOL} m); counters "
        + ", ".join(f"{k} {int(b_metrics[k])} ([main] {int(want[k])})" for k in COUNTERS)
        + f"; staged_overflow gap {so_gap} (limit {STAGED_OVERFLOW_SLACK}) from {so_rows} "
        f"filter(s); the smallest nonzero count of one [main] filter {so_row_min}")
    check(halves_equal, "[sharded] (b) a shard differs from its half of the fleet run alone")
    check(b_equal or (b_counters and so_gap <= STAGED_OVERFLOW_SLACK and b_gap <= SHARDED_POS_ATOL),
          f"[sharded] (b) residualized or row_overflow differ from [main]'s, staged_overflow "
          f"{so_gap} > {STAGED_OVERFLOW_SLACK} from it, or positions {b_gap:.3e} m > "
          f"{SHARDED_POS_ATOL} m")
    check(STAGED_OVERFLOW_SLACK < so_row_min, f"[sharded] (b) a filter of [main] has only "
          f"{so_row_min} staged overflows: the slack {STAGED_OVERFLOW_SLACK} could hide its row")
    del b_final, b_outs, b_all, b_outs_all, halves

    from msckf_mono_tpu_torch.ops import cuda_graph

    cuda_graph.clear_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "msckf_mono_tpu_torch.parallel.two_host_sim", "--batch",
         str(B), "--frames", str(T), "--timeout", "600"],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"[sharded] (c) two_host_sim exit {proc.returncode}: {proc.stderr[-3000:]}")
    c = json.loads(proc.stdout.strip().splitlines()[-1])
    for w in c["workers"]:
        log(f"[sharded] (c) rank {w['rank']} ({w['backend']}, shard {w['shards']} on "
            f"{w['devices']}): {w['frame_ms']:.2f} ms a frame, {w['frame_steps_per_s']:.1f} "
            f"frame-steps/s, gamma launches {w['gamma_launches']}, triangulate "
            f"{w['triangulate_launches']}, peak memory "
            f"{w.get('peak_gib', float('nan')):.2f} GiB, capture {w['capture_s']:.2f} s, "
            f"all-reduce "
            f"{1e3 * w['allreduce_s']:.3f} ms, checkpoint save {w['save_s']:.3f} s, restore "
            f"{w['restore_s']:.3f} s")
    r = c["reference"]
    log(f"[sharded] (c) one process, the same {len(r['shards'])} shards: {r['frame_ms']:.2f} ms a "
        f"frame; checks "
        f"{c['checks']}; launcher wall {wall:.1f} s")
    check(c["ok"], f"[sharded] (c) not ok: {c['checks']}")
    check(all(w["gamma_launches"] == 2 * T for w in c["workers"]),
          f"[sharded] (c) gamma launches {[w['gamma_launches'] for w in c['workers']]}")
    check(all(w["triangulate_launches"] == 2 * T for w in c["workers"]),
          f"[sharded] (c) triangulate launches {[w['triangulate_launches'] for w in c['workers']]}")
    check(all(int(c["metrics"][k]) == int(b_metrics[k]) for k in COUNTERS),
          f"[sharded] (c) totals {c['metrics']} differ from (b)'s")
    return {"a": dict(a, bit_equal=a_equal), "b": b,
            "c": dict(checks=c["checks"], workers=c["workers"], reference=r, wall_s=wall)}


def phase_checkpoint(torch, main):
    """The main fleet run half-way, saved, restored into a fresh template on
    the card and resumed through the replayed graph: bit-equal to [main]."""
    import os
    import tempfile

    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import checkpoint, sharding

    cfg, frames, make, final = main["cfg"], main["frames"], main["make"], main["final"]
    T = frames.time.shape[0]
    half = T // 2
    cuda_graph.clear_cache()
    run = sharding.batched_run_sequence(cfg)
    _zero_counts()
    mid, _ = run(make(), tree_map(lambda x: x[:half], frames))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = checkpoint.save(os.path.join(root, "ckpt"), mid, step=half)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        template = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpoint.restore(path, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(restored.P.device == final.P.device and _tree_equal(torch, restored, mid),
          "[checkpoint] the restored state differs from the saved one")
    resumed, _ = run(restored, tree_map(lambda x: x[half:], frames))
    torch.cuda.synchronize()
    gamma_n, tri_n = _counts()[2:4]
    same = dict(P=torch.equal(resumed.P, final.P),
                p_I_G=torch.equal(resumed.imu.p_I_G, final.imu.p_I_G),
                diag=_tree_equal(torch, resumed.diag, final.diag),
                everything=_tree_equal(torch, resumed, final))
    log(f"[checkpoint] {final.P.shape[0]} filters: {half} frames, save {size / 2**20:.1f} MiB in "
        f"{save_s:.3f} s, restore onto the card {restore_s:.3f} s, resume {T - half} frames; "
        f"bit-equal to the uninterrupted run: {same}; gamma launches {gamma_n}, triangulate {tri_n}")
    check(same["P"] and same["p_I_G"] and same["diag"],
          f"[checkpoint] resumed run differs from the uninterrupted one: {same}")
    check(gamma_n == 2 * T, f"[checkpoint] {gamma_n} gamma launches, expected {2 * T}")
    check(tri_n == 2 * T, f"[checkpoint] {tri_n} triangulate launches, expected {2 * T}")
    return dict(bytes=size, save_s=save_s, restore_s=restore_s, equal=same,
                gamma_launches=gamma_n, triangulate_launches=tri_n)


def phase_golden(torch):
    """compare_to_golden() on the CPU (the golden's definition, f64), then
    the same spec in f32 on the card through the gamma kernel."""
    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import init_filter_state
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.eval import golden
    from msckf_mono_tpu_torch.parallel.montecarlo import broadcast_frames
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    t0 = time.perf_counter()
    errs = golden.compare_to_golden()
    cpu_s = time.perf_counter() - t0
    log(f"[golden] compare_to_golden() on the CPU (f64, rtol = atol = 1e-9): passed in "
        f"{cpu_s:.1f} s; max gaps " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    gold = np.load(golden.DEFAULT_PATH)
    cfg = MsckfConfig()
    seq = synthetic.generate(cfg, **golden.GOLDEN_SPEC)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device="cuda")
    frames = broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device="cuda"), 1)
    _zero_counts()
    final, outs = msckf_filter.run_sequence(init_filter_state(cfg, imu, device="cuda"), frames, cfg)
    gamma_n, tri_n = _counts()[2:4]
    T = frames.time.shape[0]
    p = outs.p_I_G[:, 0].double().cpu().numpy()
    gap = float(np.abs(p - gold["p"]).max())
    res = int(final.num_residualized[0])
    log(f"[golden] the same spec in f32 on the card: max position gap to the golden {gap:.4e} m "
        f"({'above' if gap > GOLDEN_F32_FINDING_M else 'within'} {GOLDEN_F32_FINDING_M} m), "
        f"residualized {res} (golden {int(gold['num_residualized'])}), gamma launches {gamma_n}, "
        f"triangulate {tri_n}")
    check(np.all(np.isfinite(p)), "[golden] f32 run not finite")
    check(gamma_n > 0, "[golden] the f32 run made no gamma kernel launches")
    want_tri = triangulations_per_step(cfg) * T
    check(tri_n == want_tri, f"[golden] {tri_n} triangulate launches, expected {want_tri}")
    return dict(cpu_max_gaps=errs, cpu_s=cpu_s, f32_max_pos_gap_m=gap, f32_residualized=res,
                golden_residualized=int(gold["num_residualized"]), gamma_launches=gamma_n,
                triangulate_launches=tri_n)


def phase_image_precision(torch, seq, imgs, shared, main10):
    """The shared-camera image path at image_precision="default" (TF32 for
    the pyramid and Shi-Tomasi products) beside [image]'s "highest"; frame
    30's products and KLT flags in both tiers; then [main]'s first frames
    again, which must not have moved."""
    import dataclasses as dc

    from msckf_mono_tpu_torch.core import pipeline
    from msckf_mono_tpu_torch.core.types import tree_map
    from msckf_mono_tpu_torch.eval import profile as port_profile
    from msckf_mono_tpu_torch.frontend import detect, functional, klt
    from msckf_mono_tpu_torch.ops import cuda_graph
    from msckf_mono_tpu_torch.parallel import sharding

    fcfg = dc.replace(image_frontend_config(), image_precision="default")
    T = imgs.shape[0]
    result, run, make, frames, cfg = image_run(torch, "image-precision", seq, imgs, IMAGE_BATCH,
                                               False, fcfg)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "[image-precision] TF32 left on")
    log(f"[image-precision] against [image] ('highest'): {result['steps_per_s']:.1f} against "
        f"{shared['steps_per_s']:.1f} image-frame-steps/s, {1e3 * result['seconds'] / T:.2f} "
        f"against {1e3 * shared['seconds'] / T:.2f} ms a frame; ATE(filter 0) "
        f"{result['ate0']:.4f} against {shared['ate0']:.4f} m")

    # both tiers in turn in this call (highest, default, default, highest), each a full timed
    # run from a fresh fleet: the frame times compared where the card and its neighbours are
    # the same
    tiers = {"highest": pipeline.batched_run_images_shared(cfg, image_frontend_config()),
             "default": run}
    tiers["highest"](*make(), tree_map(lambda x: x[:2], frames))       # its capture
    turns = {"highest": [], "default": []}
    for tier in ("highest", "default", "default", "highest"):
        states = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiers[tier](*states, frames)
        torch.cuda.synchronize()
        turns[tier].append(1e3 * (time.perf_counter() - t0) / T)
    del tiers
    log(f"[image-precision] in turn, ms a frame: 'highest' {turns['highest'][0]:.2f}, 'default' "
        f"{turns['default'][0]:.2f}, 'default' {turns['default'][1]:.2f}, 'highest' "
        f"{turns['highest'][1]:.2f}")

    # frame lo's products in both tiers
    lo = min(30, T // 2)
    img = imgs[lo:lo + 1]
    gaps = [float((a - b).abs().max()) for a, b in
            zip(klt.build_pyramid(img, fcfg.max_level, precision="default"),
                klt.build_pyramid(img, fcfg.max_level))]
    st_h = detect.shi_tomasi_score(img)
    st_gap = float((detect.shi_tomasi_score(img, precision="default") - st_h).abs().max())
    st_max = float(st_h.abs().max())
    # the front-end's tracked flags of frame lo in both tiers from one state, this path's after
    # frame lo - 1, each tier tracking from its own pyramid of frame lo - 1 with the same gyro
    # rotation
    mid, fmid, _ = run(*make(), tree_map(lambda x: x[:lo], frames))
    frame = tree_map(lambda x: x[lo], frames)
    dR = pipeline._gyro_dR(frame, mid.imu.b_g, pipeline._q_CI(cfg, torch.float32, "cuda"),
                           torch.float32)
    tracked = {}
    with cuda_graph.disabled():
        for fc in (image_frontend_config(), fcfg):
            f0 = fmid.replace(pyramid=klt.build_pyramid(imgs[lo - 1:lo], fc.max_level,
                                                        precision=fc.image_precision))
            _, feats = functional.frontend_step(f0, img, dR, cfg, fc)
            tracked[fc.image_precision] = feats.tracked_valid
    live = fmid.valid & fmid.has_prev[:, None]
    agree = float((tracked["highest"] == tracked["default"])[live].float().mean())
    log(f"[image-precision] frame {lo}, 'default' against 'highest': pyramid max gaps by level "
        + ", ".join(f"{g:.4g}" for g in gaps) + f" (intensity 0..255); Shi-Tomasi max gap "
        f"{st_gap:.4g} of a largest response {st_max:.4g}; KLT good flags agree on "
        f"{100 * agree:.3f}% of {int(live.sum())} tracked features")

    # device time of the image products, in the step (profile) and alone
    prof_frames = tree_map(lambda x: x[lo:lo + PROFILE_FRAMES], frames)
    profile = phase_profile(torch, "image-precision-profile", lambda: run(mid, fmid, prof_frames),
                            1e3 * result["seconds"] / T)
    rows = [a for a in port_profile.trace.last.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA]
    tf32_ms = sum(a.self_device_time_total for a in rows
                  if "tf32" in a.key.lower()) / 1e3 / PROFILE_FRAMES

    def products(tier):
        return (klt.build_pyramid(img, fcfg.max_level, precision=tier),
                detect.shi_tomasi_score(img, precision=tier))

    alone = {tier: _graph_ms(torch, lambda t=tier: products(t)) for tier in ("highest", "default")}
    log(f"[image-precision] device time of the image products: TF32 kernels in the step "
        f"{tf32_ms:.4f} ms a frame; pyramid + Shi-Tomasi alone (a graph of 20) 'highest' "
        f"{alone['highest']:.4f} ms, 'default' {alone['default']:.4f} ms")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "[image-precision] TF32 left on")
    del mid, fmid

    # [main]'s first frames again, in this process, after the TF32 captures
    cuda_graph.clear_cache()
    n = MAIN_RECHECK_FRAMES
    _, outs = sharding.batched_run_sequence(main10["cfg"])(main10["make"](), main10["frames"])
    same = _tree_equal(torch, outs, main10["outs"])
    log(f"[image-precision] [main]'s first {n} frames rerun after it: bit-equal {same}")
    check(same, "[image-precision] the filter path moved after the TF32 image run")
    return dict(result, turns_ms=turns, pyramid_gaps=gaps, st_gap=st_gap, st_max=st_max,
                klt_flag_agree=agree,
                klt_features=int(live.sum()), tf32_step_ms=tf32_ms, products_alone_ms=alone,
                profile=profile, main_recheck_equal=same)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    name, _ = phase_device(torch)
    usage = phase_build()
    per_shape = phase_kernel(torch)
    prng_check = phase_prng(torch)
    tri_shapes = phase_triangulate(torch, usage)
    launches, main_path = phase_main(torch, args.batch, args.frames)
    tri_main = main_path["triangulate_launches"]
    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.ops import cuda_graph

    graph = phase_graph(torch, "graph", msckf_filter.step, (main_path["cfg"],), main_path["make"],
                        main_path["frames"], main_path)
    timing = phase_timing(torch, main_path)
    sharded = phase_sharded(torch, main_path)
    ckpt = phase_checkpoint(torch, main_path)
    from msckf_mono_tpu_torch.core.types import tree_map

    first = lambda x: x[:MAIN_RECHECK_FRAMES]
    main10 = dict(cfg=main_path["cfg"], make=main_path["make"],
                  frames=tree_map(first, main_path["frames"]),
                  outs=tree_map(lambda x: first(x).clone(), main_path["outs"]))
    del main_path
    cuda_graph.clear_cache()                 # the filter path's graph and its pool
    golden = phase_golden(torch)
    cuda_graph.clear_cache()

    seq, imgs = render_world(serving_config(IMAGE_BATCH), max(IMAGE_FRAMES, INDEP_FRAMES))
    fast_shapes, fast_err, klt_err, st_shapes = phase_image_kernels(torch, imgs)
    shared = phase_image(torch, "image", seq, imgs[:IMAGE_FRAMES], IMAGE_BATCH, False)
    cuda_graph.clear_cache()
    precision = phase_image_precision(torch, seq, imgs[:IMAGE_FRAMES], shared, main10)
    cuda_graph.clear_cache()
    indep = phase_image(torch, "image-indep", seq, imgs[:INDEP_FRAMES], INDEP_BATCH, True)
    cuda_graph.clear_cache()
    replay, replay_indep = shared["replay"], indep["replay"]
    live = run_live_phases(torch, imgs[:LIVE_FRAMES])

    by_path = {k: {"image": shared["launches"][k], "image-indep": indep["launches"][k],
                   "image-precision": precision["launches"][k],
                   **{path: live[path]["launches"][k]
                      for path in ("live", "live-cli", "live-parity", "live-ransac")}}
               for k in LAUNCH_KEYS}
    for k in ("gamma", "triangulate"):
        by_path[k].update({
            "sharded-a": sharded["a"][f"{k}_launches"], "sharded-b": sharded["b"][f"{k}_launches"],
            "sharded-c": [w[f"{k}_launches"] for w in sharded["c"]["workers"]],
            "checkpoint": ckpt[f"{k}_launches"], "golden-f32": golden[f"{k}_launches"]})
    # One filter-path frame step launches gamma once at each of its two shapes.
    main_shapes = per_shape[:2]
    gamma = {
        "name": "psd_gamma", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "launches_by_path": {"main": launches, **by_path["gamma"]},
        "max_abs_err": max(*(s["max_abs_err"] for s in per_shape), live["replay"]["gamma"]["max_abs_err"],
                           live["live-ransac"]["max_abs_err"]["gamma"]),
        **{k: sum(s[k] for s in main_shapes)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in main_shapes) else "operations",
        "per_shape": per_shape,
        # R = 53, n = 8: every launch of the live path (8 a frame, 16 in finish())
        "live": live["replay"]["gamma"],
        "registers": usage["psd_gamma"],
    }
    fast = {
        "name": "fast_nms", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/fast_nms.cu",
        "replaces": "msckf_mono_tpu/ops/fast_pallas.py:37",
        "launches": shared["launches"]["fast"], "launches_by_path": by_path["fast"],
        "max_abs_err": max(fast_err, replay["fast_max_abs_err"], replay_indep["fast_max_abs_err"],
                           live["replay"]["fast"]["max_abs_err"],
                           live["live-ransac"]["max_abs_err"]["fast"]),
        # one launch a frame on the shared camera's (1, 480, 752) image
        **{k: fast_shapes["shared"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "candidate_share")},
        # uniform noise, the pre-test's worst case
        "random": {k: fast_shapes["random"][k] for k in ("ms", "device_ms", "bound_ms", "bound_by",
                                                         "candidate_share")},
        # no single PyTorch call computes the FAST-10 score
        "library_ms": None,
        "per_shape": fast_shapes,
        # B = 1 on the live path's recorded frame
        "live": live["replay"]["fast"],
        "registers": usage["fast_nms"],
    }
    klt = {
        "name": "klt_level", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/klt_level.cu",
        "replaces": "msckf_mono_tpu/ops/klt_pallas.py:60",
        "launches": shared["launches"]["klt"], "launches_by_path": by_path["klt"],
        "max_abs_err": max(klt_err, replay["max_abs_err"], replay_indep["max_abs_err"],
                           live["replay"]["klt"]["max_abs_err"],
                           live["live-ransac"]["max_abs_err"]["klt"]),
        # the four level launches of one main-path frame, on its recorded inputs
        **{k: replay[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_30_iters")},
        # no single PyTorch call computes an LK level
        "library_ms": None,
        "per_level": replay["per_level"],
        # the same on the 64-stream path's recorded launches (frame 20)
        "image_indep": {k: replay_indep[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "per_level")},
        # B = Bi = 1, F = 128: the four levels of a recorded live frame
        "live": {k: live["replay"]["klt"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                       "bound_by", "max_abs_err", "per_level")},
        "registers": usage["klt_level"],
    }
    triangulate = {
        "name": "triangulate", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/triangulate.cu",
        # the JAX package triangulates in plain JAX (core/triangulate.py)
        "replaces": None,
        "launches": tri_main, "launches_by_path": {"main": tri_main, **by_path["triangulate"]},
        # the fleet's two calls of one frame step (marginalize, prune)
        **{k: sum(s[k] for s in tri_shapes[:2]) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "library_ms": None,
        "per_shape": tri_shapes,
        "registers": usage["triangulate"],
    }
    shi_tomasi = {
        "name": "shi_tomasi", "route": "cuda", "source": "msckf_mono_tpu_torch/csrc/shi_tomasi.cu",
        # the JAX package computes the score in plain JAX (frontend/detect.py)
        "replaces": None,
        "launches": shared["launches"]["shi_tomasi"], "launches_by_path": by_path["shi_tomasi"],
        "max_abs_err": max(s["max_abs_err"] for s in st_shapes.values()),
        # one launch a frame on the shared camera's (1, 480, 752) image
        **{k: st_shapes["shared"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                               "bound_by")},
        # no single PyTorch call computes it
        "library_ms": None,
        "per_shape": st_shapes,
        "registers": usage["shi_tomasi"],
    }
    # each kernel's device time a frame inside the replayed step (profiles of 3 frames)
    profiles = {"filter": graph["replay_profile"], "image": shared["graph"]["replay_profile"],
                "live": live["live-graph"]["replay_profile"]}
    for entry, key in ((gamma, "gamma"), (fast, "fast"), (klt, "klt"), (triangulate, "triangulate"),
                       (shi_tomasi, "shi_tomasi")):
        entry["in_graph_per_frame"] = {path: prof["kernels"].get(key) for path, prof in profiles.items()}
    paths = {k: {kk: v for kk, v in r.items() if kk not in ("replay", "graph")}
             for k, r in (("image", shared), ("image-indep", indep))}
    paths.update({k: live[k] for k in ("live", "live-cli", "live-parity", "live-graph",
                                       "live-ransac")})
    paths["prng"] = prng_check
    paths.update({"graph": graph, "image-graph": shared["graph"], "timing": timing,
                  "sharded": sharded, "checkpoint": ckpt, "golden": golden,
                  "image-precision": {k: v for k, v in precision.items() if k != "profile"}})
    paths["live-data"] = {"decoder": live["decoder"]}
    print(json.dumps({"kernels": [gamma, fast, klt, triangulate, shi_tomasi], "paths": paths}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
