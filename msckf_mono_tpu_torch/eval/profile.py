"""Tracing and profiling (port of ``msckf_mono_tpu/eval/profile.py``, extended).

The replacement for the reference's perf-record launch mode
(launch/asl_msckf.launch:48: ``perf record -g --call-graph dwarf``) and its
TSTART/TEND stage timers (datasets/asl_msckf.cpp:207-212). One recorder, on
the host's ``time.perf_counter_ns`` clock:

* :func:`span` opens a host span at one of the program's layer boundaries
  (``live.frame``, ``graph.replay``, ``scan.step``, ...). While recording
  is on (:func:`recording`, :func:`set_recording`) the span is kept in a
  bounded buffer (name, start and end in ns, the index of its enclosing
  span, its request id, and whether a profiler was active); :func:`spans`
  reads it back. Whenever a ``torch.profiler`` is active the span is also a
  range of the same name on the profiler's clock (:func:`_range`). With
  recording off and no profiler it is one shared no-op context.
* :func:`stage` marks device work inside a step function that is captured
  into a CUDA graph (``step.update``, ``frontend.track``, ...): a range
  while a profiler is active, nothing otherwise. A replayed graph runs no
  Python, so a stage costs nothing on replay and adds no node to any graph;
  in an eager step under the profiler each device operation belongs to the
  innermost stage open at its launch (the operation and its launch share
  the profiler's correlation id; the launch lies inside the range).
* :func:`trace` writes a Chrome trace of the enclosed work, and
  :class:`StageTimer` sums a :class:`Recorder`'s spans by name.

Names speak of the program only, dot-separated: ``<layer>.<what>``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from typing import NamedTuple

import torch

# Spans kept by the default recorder; the oldest are dropped beyond it.
CAPACITY = 1 << 16

_autograd_profiler = torch.autograd.profiler
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def _range(name: str):
    """A profiler range named ``name``, entered. It is a host operator in
    the trace (``torch.profiler.record_function`` would make a user
    annotation, which the profiler mirrors onto the device's timeline as one
    more device event spanning the range's work)."""
    rf = _RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Noop:
    """The shared no-op context of a span or stage that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NOOP = _Noop()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records now."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """One recorded span. ``end_ns`` is None while it is open; ``parent`` is
    the ``index`` of the span it opened inside, or None."""

    index: int
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    request: int | None
    profiled: bool
    attrs: dict


class _Open:
    """An open span of a recording :class:`Recorder`."""

    __slots__ = ("rec", "name", "request", "attrs", "row", "rf")

    def __init__(self, rec, name, request, attrs):
        self.rec, self.name, self.request = rec, name, request
        self.attrs = {} if attrs is None else attrs

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent[5]
        prof = profiling()
        self.rf = _range(self.name) if prof else None
        # [index, name, start, end, parent, request, profiled, attrs]
        self.row = [rec._count, self.name, time.perf_counter_ns(), None,
                    None if parent is None else parent[0], request, prof, self.attrs]
        rec._count += 1
        rec._buf.append(self.row)
        rec._stack.append(self.row)
        return self

    def __exit__(self, *exc):
        self.row[3] = time.perf_counter_ns()
        stack = self.rec._stack
        if stack and stack[-1] is self.row:
            stack.pop()
        else:
            self.rec._stack = [r for r in stack if r is not self.row]
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Recorder:
    """A buffer of host spans, off until switched on. ``capacity`` spans are
    kept (None: all), the oldest dropped first; :attr:`dropped` counts them.
    The spans nest by the order they open and close in: the recorder
    follows one thread."""

    def __init__(self, capacity: int | None = CAPACITY):
        self.on = False
        self._buf = collections.deque(maxlen=capacity)
        self._stack = []
        self._count = 0

    def span(self, name: str, request: int | None = None, attrs: dict | None = None):
        """A context for one span named ``name``. ``request`` is the id of
        what it serves (a frame, a step), by default its enclosing span's;
        ``attrs`` are kept with it (a dict, not keywords: a ``**`` parameter
        would build a dict on every call, recording or not)."""
        if self.on:
            return _Open(self, name, request, attrs)
        if _autograd_profiler._is_profiler_enabled:
            return _RecordFunctionFast(name)
        return _NOOP

    def spans(self) -> list[Span]:
        """The kept spans, in the order they opened."""
        return [Span(*row) for row in self._buf]

    @property
    def dropped(self) -> int:
        return self._count - len(self._buf)

    def reset(self):
        self._buf.clear()
        self._count = 0


RECORDER = Recorder()
span = RECORDER.span


def stage(name: str):
    """A profiler range named ``name`` while a profiler is active; the shared
    no-op otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NOOP


def set_recording(on: bool) -> bool:
    """Keep the spans of :data:`RECORDER` (``on``) or not, from now on;
    returns whether it kept them before."""
    before, RECORDER.on = RECORDER.on, bool(on)
    return before


@contextlib.contextmanager
def recording(on: bool = True):
    """:func:`set_recording` inside the block."""
    before = set_recording(on)
    try:
        yield RECORDER
    finally:
        set_recording(before)


def spans() -> list[Span]:
    """The spans :data:`RECORDER` kept, in the order they opened."""
    return RECORDER.spans()


def reset():
    """Empty :data:`RECORDER`'s buffer."""
    RECORDER.reset()


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
    """Accumulating per-stage wall timer (the StageTiming msg analogue): a
    view of its own always-on :class:`Recorder`.

    >>> st = StageTimer()
    >>> with st.stage("imu_prop"): ...
    >>> st.summary()   # {stage: {"total_s":..., "calls":..., "mean_ms":...}}
    """

    def __init__(self):
        self.recorder = Recorder(capacity=None)
        self.recorder.on = True

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        """Times the block as a span; pass ``block`` (a tensor or a tree of
        them) to include the device's completion: the current stream of its
        device is synchronized before the span closes."""
        with self.recorder.span(name):
            try:
                yield
            finally:
                if block is not None:
                    from msckf_mono_tpu_torch.ops import cuda_graph

                    on_card = [x for x in cuda_graph.flatten(block)[0] if x.is_cuda]
                    if on_card:
                        torch.cuda.current_stream(on_card[0].device).synchronize()

    def summary(self) -> dict:
        totals, calls = collections.defaultdict(float), collections.Counter()
        for s in self.recorder.spans():
            if s.end_ns is not None:
                totals[s.name] += (s.end_ns - s.start_ns) / 1e9
                calls[s.name] += 1
        return {
            k: {
                "total_s": round(v, 4),
                "calls": calls[k],
                "mean_ms": round(1e3 * v / max(calls[k], 1), 3),
            }
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
        }
