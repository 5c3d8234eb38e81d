"""The live driver with two-point RANSAC on: ``harness/live.py``'s, with three additions.

The frames, the open-loop window, the trace and the comparison are
``live.py``'s, whose ``serve`` and ``served_once`` run here with
:class:`RansacRun` as their run. It adds:

- under ``--trace 1``, the last ``kernel_steps`` warm-up frames run eagerly
  (``cuda_graph.disabled()``, which gives the replayed frames' results)
  under a profiler of their own, and their device time is split by the
  program's stage ranges (``fleet_indep.stage_split``) into
  ``Trace.stage_ms``, where ``metrics/ransac_device_ms.py`` reads
  ``frontend.ransac``;
- after the window, the tracker's counters ``ransac_frames`` and
  ``ransac_rejected``, read once, and logged beside the reference's as a
  ``[ransac]`` line (a program without them logs them as absent);
- :func:`reference` runs ``reference/live_ransac.py``, which draws RANSAC's
  pairs at the program's integer width from the same carried key.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from portbench.harness import fleet_indep, live
from portbench.harness.fleet import seq_arrays

COUNTERS = ("ransac_frames", "ransac_rejected")


class RansacRun(live.LiveRun):
    """``live.LiveRun``; with ``split`` its warm-up ends in the profiled
    eager frames, and :meth:`close` reads RANSAC's counters."""

    def __init__(self, cell, seed, dev, log, seconds, split=False):
        super().__init__(cell, seed, dev, log, seconds)
        self.split_frames = int(cell.traffic["trace"]["kernel_steps"]) if split else 0
        self.stage_ms = None
        self.counters = None

    def warm_up(self):
        k = min(self.split_frames, self.warm - 2)
        if k <= 0:
            return super().warm_up()
        self.warm -= k
        try:
            capture_s = super().warm_up()
        finally:
            self.warm += k
        self.stage_ms = self.split(range(self.warm - k, self.warm))
        return capture_s

    def split(self, frames):
        """Device time (ms) and operations a frame by the program's stage
        ranges over ``frames``, run eagerly under a profiler."""
        from msckf_mono_tpu_torch.ops import cuda_graph

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with cuda_graph.disabled():
                for i in frames:
                    self.frame(i)
            self.dev.sync()
        split = fleet_indep.stage_split(prof.events(), len(frames))
        for name, (ms, ops) in sorted(split.items()):
            self.log(f"[stages] {name}: {ms:.4f} ms ({ops:g} device operations) a frame over "
                     f"{len(frames)} eager frames (warm-up frames {frames.start}-{frames.stop - 1})")
        return split

    def window(self, seconds, trace_spec=None):
        out = super().window(seconds, trace_spec)
        if trace_spec is not None and self.stage_ms is not None:
            self.trace.stage_ms = self.stage_ms
        return out

    def close(self):
        th = self.vio.track_handler
        self.counters = {k: int(getattr(th, k)) if hasattr(th, k) else None for k in COUNTERS}
        return super().close()


@contextlib.contextmanager
def _runs(make):
    """``live``'s functions with ``make`` as the run they make (they look up
    ``LiveRun`` by name when called)."""
    before, live.LiveRun = live.LiveRun, make
    try:
        yield
    finally:
        live.LiveRun = before


def serve(cell, args, dev, clock, log):
    with _runs(functools.partial(RansacRun, split=bool(args.trace))):
        return live.serve(cell, args, dev, clock, log)


def served_once(cell, seed, dev, log, seconds):
    with _runs(RansacRun):
        return live.served_once(cell, seed, dev, log, seconds)


def _counted(counters):
    if counters is None or counters["ransac_frames"] is None:
        return "counters absent"
    f, r = counters["ransac_frames"], counters["ransac_rejected"]
    return f"{f} frames decided, {r} tracks rejected ({r / max(f, 1):.3f} a decided frame)"


def reference(out, cell, dev, dtype, tf32=False, positions=True):
    """The plain reference's trail of the frames ``out`` served, RANSAC's
    pairs drawn at the program's width; logs the ``[ransac]`` line."""
    from portbench.reference import live_ransac

    run = out["run"]
    n = run.warm + run.n_window
    trail = live_ransac.live(cell.config, seq_arrays(run.seq), run.imu0, run.images[:n], dtype,
                             dev.kind, tf32=tf32)
    program = "not read (served once)" if run.counters is None else _counted(run.counters)
    run.log(f"[ransac] over {n} frames: the program {program}; the reference "
            f"({str(dtype).removeprefix('torch.')}, TF32 {'on' if tf32 else 'off'}) "
            f"{_counted(trail['ransac'])}")
    return trail
