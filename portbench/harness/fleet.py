"""The fleet driver: back-to-back Monte-Carlo jobs of B filters.

A job draws a new fleet with the program's ``parallel/montecarlo.make_fleet``
from the key of (seed, job) and steps it through the traffic's sequence,
``chunk_frames`` frames a call, the state carried between calls. The
traffic's ``input`` names what a frame brings, one class of
:data:`INPUTS` each: precomputed tracks through
``parallel/sharding.batched_run_sequence`` ("tracks"), or one rendered
camera through ``core/pipeline.batched_run_images_shared``
("images_shared"). Another input is a driver module of its own: a
subclass of :class:`FleetRun`, and this module's functions called with
``inputs={name: that class}``. The window ends at the first chunk boundary past
``--seconds``; every chunk ends in a device sync, so the window's seconds
cover all of its work.

The module gives what ``run.py`` and ``control.py`` call of a driver:
:func:`serve` (one run), :func:`served_once` (the rows a run compares,
served once outside a window) and :func:`reference` (the plain reference
of what was served).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import cell as cellmod
from portbench.harness import kernels, world
from portbench.harness.render import Renderer
from portbench.harness.trace import Trace, profiled, span, spans_named
from portbench.reference.msckf.utils import prng

MAX_JOBS = 4096            # keys drawn for a run's jobs; a window runs a few


def job_keys(seed: int):
    """(MAX_JOBS, 2) uint32 words: job j's fleet key, split from the seed's."""
    return prng.split(prng.PRNGKey(seed), MAX_JOBS).numpy()


def gt_init(w):
    """The world's true state at t = 0 (velocity from the first IMU step)."""
    dt = 0.005
    return dict(p_I_G=w.p_seq[0].tolist(), q_IG=w.q_seq[0].tolist(),
                v_I_G=((w.p_seq[1] - w.p_seq[0]) / dt).tolist())


def seq_arrays(seq):
    return {k: getattr(seq, k) for k in ("imu_omega", "imu_acc", "imu_dt", "tracked_uv",
                                         "tracked_ids", "tracked_valid", "new_uv", "new_ids",
                                         "new_valid", "time")}


class FleetRun:
    """A fleet cell's traffic, its set-up and its window. A subclass gives
    the input: :meth:`_frames`, :meth:`_runner`, :meth:`make`,
    :meth:`chunk` and :meth:`reference`."""

    kind = None            # the metrics' variant: "<kind>_frames_per_s"

    def __init__(self, cell, seed, dev, log):
        from msckf_mono_tpu_torch.core.init import ground_truth_init
        from msckf_mono_tpu_torch.utils import config as prog_config

        tr = cell.traffic
        self.cell, self.seed, self.dev, self.log = cell, seed, dev, log
        self.B, self.T, self.C = int(tr["batch"]), int(tr["frames"]), int(tr["chunk_frames"])
        self.dtype = cellmod.dtype_of(cell.config)
        self.cfg = cellmod.build_config(cell.config, self.B, prog_config)
        w = tr["world"]
        self.seq, self.world = world.generate(self.cfg, n_frames=self.T, seed=seed,
                                              pixel_noise=w["pixel_noise"],
                                              n_landmarks=w["n_landmarks"], return_world=True)
        self.imu0 = dict(gt_init(self.world), b_g=self.seq.b_g.tolist(), b_a=self.seq.b_a.tolist())
        self.imu = ground_truth_init(**self.imu0, dtype=self.dtype, device=dev.kind)
        self.keys = job_keys(seed)
        self.kept = []
        self.frames = self._frames(w, self._common())
        self.run = self._runner()

    def _b(self, x, dtype=None):
        """A (T, ...) sequence array as (T, B, ...) on the device."""
        x = torch.as_tensor(np.asarray(x)[:self.T], device=self.dev.kind).to(dtype or self.dtype)
        return x[:, None].expand((self.T, self.B) + tuple(x.shape[1:]))

    def _common(self):
        """The frame fields every input has: the IMU block, ids and times."""
        b, seq, T = self._b, self.seq, self.T
        return dict(imu_omega=b(seq.imu_omega), imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt),
                    state_id=b(np.arange(1, T + 1), torch.int32), time=b(seq.time),
                    frame_valid=b(np.ones(T, bool), torch.bool))

    def _fleet(self, job):
        from msckf_mono_tpu_torch.parallel import montecarlo

        return montecarlo.make_fleet(self.cfg, self.imu, self.B, key=self.keys[job],
                                     dtype=self.dtype, device=self.dev.kind)

    def _frames(self, w, common):
        """The (T, B, ...) frame inputs of the sequence."""
        raise NotImplementedError

    def _runner(self):
        """The program's entry the window drives."""
        raise NotImplementedError

    def make(self, job):
        """Job ``job``'s carry for its first chunk."""
        raise NotImplementedError

    def chunk(self, carry, f0, f1):
        """Frames [f0, f1) from ``carry``: (carry, the frames' FrameOutput)."""
        raise NotImplementedError

    def keep(self, carry, frame):
        """After a chunk that ended with ``frame``: keep what of the carry
        the comparison reads besides the positions (nothing, unless an input
        says otherwise)."""

    def kept_arrays(self):
        """What :meth:`keep` kept, on the host, for the comparison."""
        return {}

    def reference(self, out, dtype, tf32=False, positions=True):
        """The plain reference's trail (``reference/runner.py``) of what
        ``out`` served: its (job, filter) ``rows`` over as many frames as
        the longest was served (``positions``), and the reference's own
        reading of whatever :meth:`keep` kept."""
        raise NotImplementedError


    # ---- set-up ----

    def warm_up(self, n):
        """``n`` frames of a fleet that no job uses, before the window. The
        path's first call (its first two frames) captures the step's graph;
        returns that call's seconds. The rest run as the window does: the
        first job after the capture ran ~10% slower on the image path (the
        host, not the device: the same busy time, more idle) until some
        seconds of load had passed (my chip runs, PR 12)."""
        t0 = time.perf_counter()
        with span("capture"):
            carry, _ = self.chunk(self.make(MAX_JOBS - 1), 0, 2)
            self.dev.sync()
        capture_s = time.perf_counter() - t0
        for f in range(2, n, self.C):
            carry, _ = self.chunk(carry, f, min(f + self.C, n))
        self.dev.sync()
        return capture_s

    # ---- the traced stretch ----

    def traced(self, spec):
        """Steady steps [from, from + steps) of a fleet that no job uses,
        replayed under the profiler; and the first ``kernel_steps`` of them
        again, eagerly, with every kernel launch recorded and profiled."""
        from msckf_mono_tpu_torch.ops import cuda_graph

        lo, steps, ksteps = int(spec["from_frame"]), int(spec["steps"]), int(spec["kernel_steps"])
        carry = self.make(MAX_JOBS - 2)
        for f in range(0, lo, self.C):
            carry, _ = self.chunk(carry, f, min(f + self.C, lo))
        self.dev.sync()
        start = cuda_graph.clone(carry)
        recorder = kernels.KernelRecorder()
        with profiled(self.dev.cuda) as p:
            with span("steps"):
                with span("chunk"):
                    self.chunk(carry, lo, lo + steps)
                with span("sync"):
                    self.dev.sync()
            recorder.on()
            try:
                with cuda_graph.disabled(), span("kernels"):
                    self.chunk(start, lo, lo + ksteps)
                    self.dev.sync()
            finally:
                recorder.off()
        windows = spans_named(p["spans"], "steps")
        steady = Trace([e for e in p["device"] if e[1] < windows[-1][1]], p["spans"], windows,
                       steps)
        self.log(f"[trace] {steps} steps replayed under the profiler in {steady.window_s:.4f} s, "
                 f"{ksteps} eagerly with the kernels recorded; {len(p['device'])} device events, "
                 f"graph launches {p['graph_launch_s']:.4f} s on the host; read in "
                 f"{p['read_s']:.2f} s")

        def replayed(kernel, n):
            # the replay started from the state the recorded steps started
            # from: its first n launches of the kernel are the recorded ones
            events = steady.kernel_events(kernel)
            return events[:n] if len(events) * ksteps == n * steps else None

        shares = kernels.shares(recorder, replayed, self.log)
        return steady, shares

    # ---- the window ----

    def window(self, seconds):
        """Jobs back to back until the first chunk boundary past ``seconds``."""
        jobs, job, f, carry = [], 0, 0, None
        t0 = time.perf_counter()
        while True:
            if f == 0:
                with span("draw"):
                    carry = self.make(job)
                jobs.append(dict(job=job, pos=[], final=None))
            with span("chunk"):
                carry, outs = self.chunk(carry, f, min(f + self.C, self.T))
            jobs[-1]["pos"].append(outs.p_I_G)
            f = min(f + self.C, self.T)
            self.keep(carry, f - 1)
            with span("sync"):
                self.dev.sync()
            now = time.perf_counter()
            if f == self.T:
                jobs[-1]["final"] = carry
                jobs[-1]["end"] = now
                job, f = job + 1, 0
            if now - t0 >= seconds:
                break
        for j in jobs:
            j["pos"] = torch.cat(j["pos"])
        ends = [t0] + [j["end"] for j in jobs if "end" in j]
        self.log("[window] ms a frame by job: " + ", ".join(
            f"{1e3 * (b - a) / self.T:.3f}" for a, b in zip(ends, ends[1:])))
        return jobs, now - t0

    def close(self, jobs):
        """After the window: filter-frames delivered and non-finite, filter
        0's ATE, the last complete job's fleet counters."""
        from msckf_mono_tpu_torch.parallel import sharding

        delivered = sum(int(j["pos"].shape[0]) * self.B for j in jobs)
        failed = sum(int((~torch.isfinite(j["pos"]).all(-1)).sum()) for j in jobs)
        first = jobs[0]["pos"][:, 0].double().cpu().numpy()
        if np.all(np.isfinite(first)) and first.shape[0] >= 3:
            self.log(f"[window] ATE(filter 0 of job 0) "
                     f"{world.ate_rmse(first, self.seq.gt_p[:first.shape[0]]):.4f} m over "
                     f"{first.shape[0]} frames")
        done = [j for j in jobs if j["final"] is not None]
        if done:
            final = done[-1]["final"]
            m = sharding.fleet_metrics(final[0] if isinstance(final, tuple) else final)
            self.log("[window] fleet counters of job " + str(done[-1]["job"]) + ": " + ", ".join(
                f"{k} {float(v):.6g}" for k, v in m.items()))
        for j in jobs:
            j["final"] = None
        return delivered, failed

    def check_rows(self, jobs, n):
        """``n`` (job, filter) pairs drawn from the seed, job 0's filter 0
        (the longest-running) among them."""
        rng = np.random.default_rng([self.seed % 2**63, 1])
        rows = {(0, 0)}
        while len(rows) < min(n, len(jobs) * self.B):
            j = int(rng.integers(len(jobs)))
            rows.add((j, int(rng.integers(self.B))))
        return sorted(rows)


class TrackRun(FleetRun):
    """Precomputed tracks: the front-end is bypassed."""

    kind = "track"

    def _frames(self, w, common):
        from msckf_mono_tpu_torch.core.filter import FrameInput

        b, seq = self._b, self.seq
        return FrameInput(tracked_uv=b(seq.tracked_uv), tracked_ids=b(seq.tracked_ids, torch.int32),
                          tracked_valid=b(seq.tracked_valid, torch.bool), new_uv=b(seq.new_uv),
                          new_ids=b(seq.new_ids, torch.int32),
                          new_valid=b(seq.new_valid, torch.bool), **common)

    def _runner(self):
        from msckf_mono_tpu_torch.parallel import sharding

        return sharding.batched_run_sequence(self.cfg)

    def make(self, job):
        return self._fleet(job)

    def chunk(self, carry, f0, f1):
        from msckf_mono_tpu_torch.core.types import tree_map

        return self.run(carry, tree_map(lambda x: x[f0:f1], self.frames))

    def reference(self, out, dtype, tf32=False, positions=True):
        from portbench.reference import runner

        n = max(p.shape[0] for p in out["served"])
        return runner.fleet_tracks(self.cell.config, self.B, seq_arrays(self.seq), self.imu0,
                                   self.keys, out["rows"], self.B, n, dtype, self.dev.kind,
                                   tf32=tf32)


class SharedCameraRun(FleetRun):
    """One camera, rendered on the card in set-up, that every filter shares."""

    kind = "image"

    def _frames(self, w, common):
        from msckf_mono_tpu_torch.core.pipeline import ImageFrameInput

        t0 = time.perf_counter()
        self.camera = Renderer(self.cfg, self.dev.kind).frames(self.world, self.T, self.seed,
                                                               w.get("sensor_noise", 1.0))
        self.dev.sync()
        self.log(f"[traffic] rendered {self.T} frames of {tuple(self.camera.shape[1:])} on "
                 f"{self.dev.kind} in {time.perf_counter() - t0:.2f} s")
        return ImageFrameInput(image=self.camera, **common)

    def _runner(self):
        from msckf_mono_tpu_torch.core import pipeline
        from msckf_mono_tpu_torch.frontend.functional import FrontendConfig

        self.fcfg = FrontendConfig(**self.cell.config["frontend"])
        return pipeline.batched_run_images_shared(self.cfg, self.fcfg)

    def make(self, job):
        from msckf_mono_tpu_torch.frontend.functional import init_frontend_state

        H, W = self.camera.shape[1:]
        return self._fleet(job), init_frontend_state(H, W, self.fcfg, self.B, 1, self.dtype,
                                                     device=self.dev.kind)

    def chunk(self, carry, f0, f1):
        from msckf_mono_tpu_torch.core.types import tree_map

        st, fst, outs = self.run(*carry, tree_map(lambda x: x[f0:f1], self.frames))
        return (st, fst), outs

    def keep(self, carry, frame):
        """The pyramid the front-end carries out of the chunk, the image
        products that the configuration's ``image_precision`` governs
        (levels 1 and up: level 0 is the frame itself)."""
        self.kept.append((frame, carry[1].pyramid[1:]))

    def kept_arrays(self):
        pyramids = [(f, [lv[0].double().cpu().numpy() for lv in levels])
                    for f, levels in self.kept]
        self.kept = []
        return {"pyramids": pyramids}

    def reference(self, out, dtype, tf32=False, positions=True):
        from portbench.reference import runner

        trail = {}
        if positions:
            n = max(p.shape[0] for p in out["served"])
            with torch.no_grad():
                trail = runner.fleet_images(self.cell.config, self.B, seq_arrays(self.seq),
                                            self.imu0, self.keys, out["rows"], self.B,
                                            self.camera[:n], dtype, self.dev.kind, tf32=tf32)
        trail["pyramids"] = runner.pyramids(self.cell.config, self.camera,
                                            [f for f, _ in out["pyramids"]], dtype,
                                            self.dev.kind, tf32=tf32)
        return trail


INPUTS = {"tracks": TrackRun, "images_shared": SharedCameraRun}


def fleet_run(cell, seed, dev, log, inputs=INPUTS):
    """The run of the traffic's ``input``, which has to be one of ``inputs``."""
    name = cell.traffic.get("input")
    if name not in inputs:
        raise ValueError(f"fleet traffic input {name!r}: this driver serves {sorted(inputs)}; "
                         "another input is a driver module of its own")
    return inputs[name](cell, seed, dev, log)


def serve(cell, args, dev, clock, log, inputs=INPUTS):
    """One run of a fleet cell: set-up, the window, the served positions of
    the rows the comparison samples."""
    run = fleet_run(cell, args.seed, dev, log, inputs)
    out = dict(kind=run.kind, capture_s=run.warm_up(int(cell.traffic["warmup_frames"])))
    if args.trace:
        out["trace"], out["shares"] = run.traced(cell.traffic["trace"])
    dev.sync()
    out["setup_s"] = clock.now()
    out["clocks_before"] = cellmod.clocks(dev)
    launches = cellmod.launch_counts()
    jobs, seconds = run.window(args.seconds)
    launches = [a - b for a, b in zip(cellmod.launch_counts(), launches)]
    log(f"[window] kernel launches: gamma {launches[0]}, FAST {launches[1]}, KLT {launches[2]}")
    out["clocks_after"] = cellmod.clocks(dev)
    delivered, failed = run.close(jobs)
    out["metrics"] = {f"{run.kind}_frames_per_s": delivered / seconds}
    out["attempted"], out["failed"] = delivered, failed
    log(f"[window] {len(jobs)} jobs of {run.B} filters, {delivered} filter-frames in "
        f"{seconds:.4f} s ({delivered / seconds:.1f} frames/s), {failed} non-finite")
    if args.trace:
        log(f"[trace] a traced step {1e3 * out['trace'].window_s / out['trace'].steps:.3f} ms, an "
            f"untraced one in the window {1e3 * seconds * run.B / delivered:.3f} ms")
    out["device"] = dev.describe(cell.chips)
    rows = run.check_rows(jobs, int(cell.traffic["check"]["filters"]))
    served = [jobs[j]["pos"][:, f].double().cpu().numpy() for j, f in rows]
    del jobs
    out.update(run.kept_arrays())
    out["served"], out["rows"], out["run"] = served, rows, run
    cellmod.free_program(dev)
    return out


def served_once(cell, seed, dev, log, seconds=None, inputs=INPUTS):
    """The rows a run compares, served once by the program outside a timed
    window and at the cell's size: job 0 over the whole sequence, the
    longest a window serves. Adds each row's decisions (``runner.DECISIONS``)
    after each frame."""
    run = fleet_run(cell, seed, dev, log, inputs)
    carry, pos, dec = run.make(0), [], []
    for f in range(0, run.T, run.C):
        carry, outs = run.chunk(carry, f, min(f + run.C, run.T))
        run.keep(carry, min(f + run.C, run.T) - 1)
        pos.append(outs.p_I_G)
        dec.append(outs.num_residualized)
    dev.sync()
    pos, dec = torch.cat(pos), torch.cat(dec)
    rows = run.check_rows([None], int(cell.traffic["check"]["filters"]))
    out = dict(kind=run.kind, rows=rows, run=run,
               served=[pos[:, f].double().cpu().numpy() for _, f in rows],
               num_residualized=np.stack([dec[:, f].cpu().numpy() for _, f in rows], 1),
               **run.kept_arrays())
    del carry, pos, dec
    cellmod.free_program(dev)
    return out


def reference(out, cell, dev, dtype, tf32=False, positions=True):
    """The plain reference's trail of what ``out`` served
    (:meth:`FleetRun.reference`)."""
    return out["run"].reference(out, dtype, tf32, positions)
