"""Multi-robot traffic: back-to-back jobs of B robots, each with its own camera and IMU.

Robot b flies the world's loop as robot 0 does, ``phase_step_frames`` (k)
frames later: at its frame t it sees the loop's frame k·b + t, with that
frame's IMU block, time and state id, and starts from the loop's true state
at the start of frame k·b. The loop (T + (B - 1)·k frames) is rendered once
on the card; the (T, B, H, W) frames are gathered from it in set-up, and the
loop itself is kept on the host for the reference. Each robot is one filter
of the port's per-stream front-end, ``core/pipeline.batched_run_images``
(images with Bi = B). Job j's fleet is ``make_fleet`` under the job's key
at B filters, centred on each robot's own true start (:func:`robot_starts`):
filter b is the draw ``make_fleet`` gives filter b, applied to robot b's
state. Everything else (jobs, chunks, window, trace) is ``fleet.py``'s, whose
functions this module calls with ``inputs={"images_indep": ...}``.

The traced run adds the eager steps' device time by the program's stage
ranges (``step.*``, ``frontend.*``, ``update.*``), each device event put in
every range open at its launch (matched by the profiler's correlation id):
``Trace.stage_ms``, read by ``metrics/frontend_device_ms.py``.
"""

from __future__ import annotations

import bisect
import collections
import time

import numpy as np
import torch

from portbench.harness import cell as cellmod
from portbench.harness import fleet, world
from portbench.harness.render import Renderer

IMU_DT = 0.005
# Launches of the CUDA runtime and driver API that put work on the device; a
# device event shares its correlation id with one of them.
LAUNCH_PREFIXES = ("cuda", "cu")
STAGE_PREFIXES = ("step.", "frontend.", "update.")


def robot_starts(w, seq, phases):
    """Each robot's true state at the start of its first frame (the loop's
    IMU index k·b·K; velocity from the next IMU step, as ``fleet.gt_init``),
    with the loop's biases: lists of (B, ...) for ``ground_truth_init``."""
    K = seq.imu_omega.shape[1]
    i = np.asarray(phases) * K
    return dict(p_I_G=w.p_seq[i].tolist(), q_IG=w.q_seq[i].tolist(),
                v_I_G=((w.p_seq[i + 1] - w.p_seq[i]) / IMU_DT).tolist(),
                b_g=seq.b_g.tolist(), b_a=seq.b_a.tolist())


def stage_split(events, steps):
    """Device time (ms) and device operations a step by the program's stage
    ranges, from the ``events`` of a profiled stretch of ``steps`` eager
    steps: each device event belongs to every range that holds its launch
    (the host's runtime call with the same correlation id). ``"step"`` is
    every device event of the stretch. Returns {name: (ms, ops)}."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = collections.defaultdict(list)
    launches, device = {}, []
    for e in events:
        if e.device_type == cuda:
            if not e.is_user_annotation:
                device.append(e)
        elif e.name.startswith(STAGE_PREFIXES):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(LAUNCH_PREFIXES):
            launches[e.id] = e.time_range.start
    if not device:
        return {}
    out = {"step": (sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps,
                    len(device) / steps)}
    for name, spans in ranges.items():
        spans.sort()
        starts = [s for s, _ in spans]
        us, n = 0.0, 0
        for e in device:
            t = launches.get(e.id)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                us += e.time_range.elapsed_us()
                n += 1
        out[name] = (us / 1e3 / steps, n / steps)
    return out


class IndependentStreamsRun(fleet.FleetRun):
    """B robots, each its own rendered camera and IMU (Bi = B)."""

    kind = "image"

    def __init__(self, cell, seed, dev, log):
        from msckf_mono_tpu_torch.core.init import ground_truth_init
        from msckf_mono_tpu_torch.utils import config as prog_config

        tr = cell.traffic
        self.cell, self.seed, self.dev, self.log = cell, seed, dev, log
        self.B, self.T, self.C = int(tr["batch"]), int(tr["frames"]), int(tr["chunk_frames"])
        self.k = int(tr["phase_step_frames"])
        self.dtype = cellmod.dtype_of(cell.config)
        self.cfg = cellmod.build_config(cell.config, self.B, prog_config)
        w = tr["world"]
        self.n_loop = self.T + (self.B - 1) * self.k
        self.seq, self.world = world.generate(self.cfg, n_frames=self.n_loop, seed=seed,
                                              pixel_noise=w["pixel_noise"],
                                              n_landmarks=w["n_landmarks"], return_world=True)
        self.phases = self.k * np.arange(self.B)
        self.index = np.arange(self.T)[:, None] + self.phases[None, :]   # (T, B): loop frames
        self.starts = robot_starts(self.world, self.seq, self.phases)
        self.imu = ground_truth_init(**self.starts, dtype=self.dtype, device=dev.kind)
        self.keys = fleet.job_keys(seed)
        self.robots = self._sampled_robots(int(tr["check"]["filters"]))
        self.robot_index = torch.as_tensor(self.robots, device=dev.kind)
        self.kept = []
        self.frames = self._frames(w, self._common())
        self.run = self._runner()

    def _sampled_robots(self, n):
        """The robots the comparison samples, robot 0 among them, drawn from
        the seed before the window, so that :meth:`keep` can keep their
        pyramids."""
        rng = np.random.default_rng([self.seed % 2**63, 2])
        others = rng.choice(np.arange(1, self.B), size=min(n, self.B) - 1, replace=False)
        return [0] + sorted(int(b) for b in others)

    def _b(self, x, dtype=None):
        """A (n_loop, ...) loop array as each robot's (T, B, ...) slice, on the device."""
        x = torch.as_tensor(np.asarray(x)[self.index], device=self.dev.kind)
        return x.to(dtype or self.dtype)

    def _common(self):
        b, seq = self._b, self.seq
        return dict(imu_omega=b(seq.imu_omega), imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt),
                    state_id=b(np.arange(1, self.n_loop + 1), torch.int32), time=b(seq.time),
                    frame_valid=b(np.ones(self.n_loop, bool), torch.bool))

    def _frames(self, w, common):
        from msckf_mono_tpu_torch.core.pipeline import ImageFrameInput

        t0 = time.perf_counter()
        loop = Renderer(self.cfg, self.dev.kind).frames(self.world, self.n_loop, self.seed,
                                                        w.get("sensor_noise", 1.0))
        images = loop[torch.as_tensor(self.index, device=loop.device)]
        self.loop = loop.cpu()
        del loop
        if self.dev.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self.log(f"[traffic] rendered a loop of {self.n_loop} frames of "
                 f"{tuple(images.shape[2:])} on {self.dev.kind} and gathered {self.B} robots' "
                 f"{self.T} frames, phases {self.k} frames apart ({images.numel() * 4} bytes), in "
                 f"{time.perf_counter() - t0:.2f} s")
        return ImageFrameInput(image=images, **common)

    def _runner(self):
        from msckf_mono_tpu_torch.core import pipeline
        from msckf_mono_tpu_torch.frontend.functional import FrontendConfig

        self.fcfg = FrontendConfig(**self.cell.config["frontend"])
        return pipeline.batched_run_images(self.cfg, self.fcfg)

    def make(self, job):
        from msckf_mono_tpu_torch.frontend.functional import init_frontend_state

        H, W = self.frames.image.shape[2:]
        return self._fleet(job), init_frontend_state(H, W, self.fcfg, self.B, self.B, self.dtype,
                                                     device=self.dev.kind)

    def chunk(self, carry, f0, f1):
        from msckf_mono_tpu_torch.core.types import tree_map

        st, fst, outs = self.run(*carry, tree_map(lambda x: x[f0:f1], self.frames))
        return (st, fst), outs

    def keep(self, carry, frame):
        """The sampled robots' pyramid levels 1 and up out of the chunk."""
        self.kept.append((frame, [lv[self.robot_index] for lv in carry[1].pyramid[1:]]))

    def kept_arrays(self):
        pyramids = [(f, [lv.double().cpu().numpy() for lv in levels]) for f, levels in self.kept]
        self.kept = []
        return {"pyramids": pyramids}

    def check_rows(self, jobs, n):
        """One row a sampled robot: robot 0 in job 0 (the longest-running),
        each other robot in a job drawn from the seed."""
        rng = np.random.default_rng([self.seed % 2**63, 1])
        return [(0 if b == 0 else int(rng.integers(len(jobs))), b) for b in self.robots[:n]]

    def reference(self, out, dtype, tf32=False, positions=True):
        from portbench.reference import runner_indep

        trail = {}
        args = (self.cell.config, self.B, fleet.seq_arrays(self.seq), self.loop, self.phases)
        if positions:
            n = max(p.shape[0] for p in out["served"])
            trail = runner_indep.fleet_images_indep(*args, self.starts, self.keys, out["rows"],
                                                    n, dtype, self.dev.kind, tf32=tf32)
        trail["pyramids"] = runner_indep.pyramids_indep(*args, self.robots,
                                                        [f for f, _ in out["pyramids"]], dtype,
                                                        self.dev.kind, tf32=tf32)
        return trail

    def traced(self, spec):
        """``fleet.FleetRun.traced``, then the same ``kernel_steps`` eager
        steps of another spare fleet once more under a profiler of their
        own, split by the program's stage ranges (:func:`stage_split`)."""
        from msckf_mono_tpu_torch.ops import cuda_graph

        steady, shares = super().traced(spec)
        lo, ksteps = int(spec["from_frame"]), int(spec["kernel_steps"])
        for kernel in ("gamma", "fast", "klt"):
            events = steady.kernel_events(kernel)
            self.log(f"[kernels] {kernel}: {sum(e - s for _, s, e in events) / 1e3 / steady.steps:.4f}"
                     f" ms of device time a replayed step in {len(events) / steady.steps:g} launches")
        carry = self.make(fleet.MAX_JOBS - 3)
        for f in range(0, lo, self.C):
            carry, _ = self.chunk(carry, f, min(f + self.C, lo))
        self.dev.sync()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with cuda_graph.disabled():
                self.chunk(carry, lo, lo + ksteps)
            self.dev.sync()
        steady.stage_ms = stage_split(prof.events(), ksteps)
        for name, (ms, ops) in sorted(steady.stage_ms.items()):
            self.log(f"[stages] {name}: {ms:.4f} ms ({ops:g} device operations) a step over "
                     f"{ksteps} eager steps")
        return steady, shares


INPUTS = {"images_indep": IndependentStreamsRun}


def serve(*args):
    return fleet.serve(*args, inputs=INPUTS)


def served_once(*args):
    return fleet.served_once(*args, inputs=INPUTS)


reference = fleet.reference
