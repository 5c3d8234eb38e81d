"""The live driver: one filter behind ``interface.VioInterface``, fed in open loop.

Frame i of the window is due at t0 + i / rate_hz. When it is due, its K IMU
readings go through ``imu_callback`` and its image, a host array, through
``image_callback``, which returns once the frame's pose is on the host. A
frame's latency runs from its due time to that return, so a frame that
waits for the previous one counts the wait. The frames are rendered on the
card in set-up and held on the host. Warm-up runs ``warmup_frames`` frames
back to back first: the sliding window fills and the frame's graph is
captured (the first frame runs eagerly, the second captures).

The module gives what ``run.py`` and ``control.py`` call of a driver:
:func:`serve`, :func:`served_once` and :func:`reference`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import cell as cellmod
from portbench.harness import kernels, stats, world
from portbench.harness.fleet import gt_init, seq_arrays
from portbench.harness.render import Renderer
from portbench.harness.trace import Trace, profiled, span, spans_named


class LiveRun:
    kind = "live"

    def __init__(self, cell, seed, dev, log, seconds):
        from msckf_mono_tpu_torch.interface import VioInterface
        from msckf_mono_tpu_torch.utils import config as prog_config

        tr = cell.traffic
        self.cell, self.seed, self.dev, self.log = cell, seed, dev, log
        self.rate = float(tr["rate_hz"])
        self.warm = int(tr["warmup_frames"])
        self.n_window = int(math.ceil(seconds * self.rate))
        self.dtype = cellmod.dtype_of(cell.config)
        self.cfg = cellmod.build_config(cell.config, 1, prog_config)
        n = self.warm + self.n_window
        w = tr["world"]
        self.seq, self.world = world.generate(self.cfg, n_frames=n, seed=seed,
                                              pixel_noise=w["pixel_noise"],
                                              n_landmarks=w["n_landmarks"], return_world=True)
        self.imu0 = dict(gt_init(self.world), b_g=self.seq.b_g.tolist(), b_a=self.seq.b_a.tolist())
        t0 = time.perf_counter()
        imgs = Renderer(self.cfg, dev.kind).frames(self.world, n, seed, w.get("sensor_noise", 1.0))
        self.images = imgs.cpu().numpy()
        del imgs
        log(f"[traffic] rendered {n} frames of {self.images.shape[1:]} on {dev.kind} and held "
            f"them on the host in {time.perf_counter() - t0:.2f} s")
        self.vio = VioInterface(self.cfg, dtype=self.dtype, device=dev.kind,
                                track_handler_kwargs=dict(cell.config["track_handler"]))
        self.vio.initialize_from_ground_truth(**self.imu0)
        self.pos = np.full((n, 3), np.nan)
        self.ran = np.zeros(n, bool)

    def frame(self, i):
        seq, vio, K = self.seq, self.vio, self.seq.imu_omega.shape[1]
        with span("imu_callback"):
            for k in range(K):
                vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                                 float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        with span("image_callback"):
            self.ran[i] = vio.image_callback(self.images[i], float(seq.time[i]))
        self.pos[i] = vio.odometry()["p_I_G"]

    # ---- set-up ----

    def warm_up(self):
        """The warm-up frames. Returns the seconds of the first two (the
        eager first frame and the capture of the frame's graph)."""
        t0 = time.perf_counter()
        with span("capture"):
            for i in range(2):
                self.frame(i)
            self.dev.sync()
        capture_s = time.perf_counter() - t0
        syncs = stats.SyncCounter(torch) if self.dev.cuda else None
        steady = range(2, self.warm)
        for i in steady:
            if syncs is not None:
                with syncs:
                    self.frame(i)
            else:
                self.frame(i)
        if syncs is not None and len(steady):
            self.log(f"[warm-up] synchronizing CUDA calls a frame (frames {steady.start}-"
                     f"{steady.stop - 1}): {syncs.count / len(steady):.2f} ({syncs.summary(len(steady))})")
        self.dev.sync()
        return capture_s

    # ---- the window ----

    def window(self, seconds, trace_spec=None):
        """The window's frames in open loop. Returns (latencies ms, lateness
        ms, seconds). With ``trace_spec`` the window's last ``steps`` +
        ``kernel_steps`` frames run under the profiler: the ``steps`` replayed
        as always (``self.trace``), the rest eagerly with every kernel launch
        recorded (``self.shares``)."""
        from msckf_mono_tpu_torch.ops import cuda_graph

        lat, late = [], []
        lo = hi = end = self.n_window
        if trace_spec is not None:
            k = int(trace_spec["kernel_steps"])
            lo = max(0, self.n_window - int(trace_spec["steps"]) - k)
            hi = self.n_window - k
        prof = recorder = None
        t0 = time.perf_counter() + 1.0 / self.rate
        for j in range(self.n_window):
            if j == lo:
                prof = profiled(self.dev.cuda)
                traced = prof.__enter__()
            if j == hi:
                recorder = kernels.KernelRecorder()
                recorder.on()
                eager = cuda_graph.disabled()
                eager.__enter__()
            due = t0 + j / self.rate
            while (wait := due - time.perf_counter()) > 0:
                time.sleep(wait if wait > 2e-3 else 0)
            late.append((time.perf_counter() - due) * 1e3)
            with span("frame" if j < hi else "kernel_frame"):
                self.frame(self.warm + j)
            lat.append((time.perf_counter() - due) * 1e3)
        self.dev.sync()
        seconds = time.perf_counter() - t0
        self.shares = {}
        if prof is not None:
            if recorder is not None:
                eager.__exit__(None, None, None)
                recorder.off()
            prof.__exit__(None, None, None)
            frames = spans_named(traced["spans"], "frame")
            self.trace = Trace([e for e in traced["device"] if e[1] < frames[-1][1]],
                               traced["spans"], frames, len(frames))
            self.log(f"[trace] {len(frames)} frames replayed under the profiler (service "
                     f"{self.trace.window_s:.4f} s), {end - hi} eagerly with the kernels recorded; "
                     f"{len(traced['device'])} device events, graph launches "
                     f"{traced['graph_launch_s']:.4f} s on the host; read in {traced['read_s']:.2f} s")
            if recorder is not None:
                eager_frames = Trace([e for e in traced["device"] if e[1] >= frames[-1][1]],
                                     traced["spans"], [], end - hi)
                self.shares = kernels.shares(
                    recorder, lambda kernel, n: eager_frames.kernel_events(kernel), self.log)
        return lat, late, seconds

    def close(self):
        w = slice(self.warm, self.warm + self.n_window)
        ok = self.ran[w] & np.all(np.isfinite(self.pos[w]), axis=1)
        n = self.warm + self.n_window
        if np.all(np.isfinite(self.pos)):
            self.log(f"[window] ATE over all {n} frames {world.ate_rmse(self.pos, self.seq.gt_p[:n]):.4f} m, "
                     f"final drift {float(np.linalg.norm(self.pos[-1] - self.seq.gt_p[n - 1])):.4f} m; "
                     f"device->host copies {self.vio.host_copies} over {n} frames")
        return self.n_window, int((~ok).sum())


def serve(cell, args, dev, clock, log):
    run = LiveRun(cell, args.seed, dev, log, args.seconds)
    spec = cell.traffic["trace"]
    out = dict(kind=run.kind, capture_s=run.warm_up())
    out["setup_s"] = clock.now()
    out["clocks_before"] = cellmod.clocks(dev)
    launches = cellmod.launch_counts()
    lat, late, seconds = run.window(args.seconds, spec if args.trace else None)
    launches = [a - b for a, b in zip(cellmod.launch_counts(), launches)]
    log(f"[window] kernel launches: gamma {launches[0]}, FAST {launches[1]}, KLT {launches[2]}")
    out["clocks_after"] = cellmod.clocks(dev)
    if args.trace:
        out["trace"], out["shares"] = run.trace, run.shares
    attempted, failed = run.close()
    out["metrics"] = {"live_latency_p50_ms": stats.percentile(lat, 50),
                      "live_latency_p95_ms": stats.percentile(lat, 95)}
    out["attempted"], out["failed"] = attempted, failed
    log(f"[window] {attempted} frames due at {run.rate:g} Hz over {seconds:.3f} s: latency p50 "
        f"{stats.percentile(lat, 50):.3f} ms, p95 {stats.percentile(lat, 95):.3f} ms, max "
        f"{max(lat):.3f} ms; the generator ran late by p50 {stats.percentile(late, 50):.3f} ms, "
        f"max {max(late):.3f} ms")
    if args.trace:
        log(f"[trace] a traced frame's service {1e3 * out['trace'].window_s / out['trace'].steps:.3f} "
            f"ms; the window's latency p50 {stats.percentile(lat, 50):.3f} ms")
    out["device"] = dev.describe(cell.chips)
    out["served"], out["run"] = [run.pos.copy()], run
    del run.vio
    cellmod.free_program(dev)
    return out


def served_once(cell, seed, dev, log, seconds):
    """The frames a run of ``seconds`` compares (warm-up and window), served
    once by the program back to back, outside a timed window."""
    run = LiveRun(cell, seed, dev, log, seconds)
    for i in range(run.warm + run.n_window):
        run.frame(i)
    dev.sync()
    out = dict(kind=run.kind, served=[run.pos.copy()], run=run)
    del run.vio
    cellmod.free_program(dev)
    return out


def reference(out, cell, dev, dtype, tf32=False, positions=True):
    """The plain reference's trail of the frames ``out`` served (positions
    are all it compares)."""
    from portbench.reference import runner

    run = out["run"]
    n = run.warm + run.n_window
    return runner.live(cell.config, seq_arrays(run.seq), run.imu0, run.images[:n], dtype,
                       dev.kind, tf32=tf32)
