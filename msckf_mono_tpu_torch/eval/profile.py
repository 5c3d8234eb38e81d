"""Device profiling helpers (port of ``msckf_mono_tpu/eval/profile.py``).

The replacement for the reference's perf-record launch mode
(launch/asl_msckf.launch:48: ``perf record -g --call-graph dwarf``): a
``torch.profiler`` trace of the enclosed work, with the card's kernels when
there is a card, viewable in Perfetto or ``chrome://tracing``; and a stage
wall-clock timer that mirrors the TSTART/TEND macros
(datasets/asl_msckf.cpp:207-212).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from msckf_mono_tpu_torch.ops import cuda_graph


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed work (host operators, and the card's kernels
    when CUDA is available) and write ``<logdir>/trace.json``, a Chrome
    trace. ``logdir`` defaults to ``msckf_torch_trace`` under the system's
    temporary directory. Yields the logdir; the profiler object is
    ``trace.last`` afterwards (its ``key_averages()`` sum time by kernel)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "msckf_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace.last = prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


trace.last = None


class StageTimer:
    """Accumulating per-stage wall timer (the StageTiming msg analogue).

    >>> st = StageTimer()
    >>> with st.stage("imu_prop"): ...
    >>> st.summary()   # {stage: {"total_s":..., "calls":..., "mean_ms":...}}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        """Times the block; pass ``block`` (a tensor or a tree of them) to
        include the device's completion: the current stream of its device
        is synchronized before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                on_card = [x for x in cuda_graph.flatten(block)[0] if x.is_cuda]
                if on_card:
                    torch.cuda.current_stream(on_card[0].device).synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {
                "total_s": round(v, 4),
                "calls": self.calls[k],
                "mean_ms": round(1e3 * v / max(self.calls[k], 1), 3),
            }
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
