"""The traced run's readings: spans the harness opens, and the device's trace.

Spans are ``torch.profiler.record_function`` ranges named ``pb:<what>``,
opened by the harness's own files around its calls into the program, so an
idle gap on the device can be labelled with what the host was doing. The
device's activity is every CUDA kernel, memcpy and memset event of a
``torch.profiler`` trace (CUPTI), read once into plain tuples.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from portbench.harness import stats

SPAN_PREFIX = "pb:"
# The hand-written kernels by the prefix of their CUDA function names
# (csrc/psd_gamma.cu, csrc/fast_nms.cu, csrc/klt_level.cu).
KERNEL_PREFIXES = {"gamma": "gamma_", "fast": "fast_nms", "klt": "klt_"}


def span(name: str):
    """A host span that shows in the trace (and costs nothing untraced)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def kernel_of(name: str):
    """Which hand-written kernel a device event's name belongs to, if any:
    its function name (after the return type, or after a namespace, as in
    ``void (anonymous namespace)::gamma_rows_kernel<56>(float const*, ...)``)
    starts with the kernel's prefix."""
    for kernel, prefix in KERNEL_PREFIXES.items():
        if name.startswith(prefix) or f" {prefix}" in name or f"::{prefix}" in name:
            return kernel
    return None


class Trace:
    """One profiled stretch: ``device`` events (name, start µs, end µs),
    harness ``spans`` (name, start µs, end µs), and the ``windows`` (start,
    end µs) the stretch's readings are taken over."""

    def __init__(self, device, spans, windows, steps):
        self.device, self.spans, self.windows, self.steps = device, spans, windows, steps

    @property
    def window_s(self):
        return sum(e - s for s, e in self.windows) / 1e6

    @property
    def busy_s(self):
        return stats.clipped_union_ms([(s, e) for _, s, e in self.device], self.windows) / 1e3

    def ops(self):
        lo, hi = self.windows[0][0], self.windows[-1][1]
        return sum(1 for _, s, e in self.device if lo <= s < hi)

    def kernel_events(self, kernel):
        return [(n, s, e) for n, s, e in self.device if kernel_of(n) == kernel]

    def top_ops(self, n=10):
        by = collections.Counter()
        for name, s, e in self.device:
            by[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """Idle time on the device inside the windows, summed by the
        innermost harness span open at each gap's start."""
        busy = [(s, e) for _, s, e in self.device]
        by = collections.Counter()
        for lo, hi in self.windows:
            for g0, g1 in stats.gaps(busy, lo, hi):
                open_ = [(s, -e, name) for name, s, e in self.spans if s <= g0 < e]
                label = max(open_)[2] if open_ else "outside any span"
                by[label] += (g1 - g0) / 1e6
        return [[k, v] for k, v in by.most_common(n)]


@contextlib.contextmanager
def profiled(cuda: bool):
    """Profile the body; yields a dict that holds, on exit, ``device`` (the
    device events) and ``spans`` (the harness spans), both (name, start,
    end) in µs on the profiler's clock, ``graph_launch_s`` (the host's time
    in CUDA graph launches) and ``read_s`` (the seconds spent reading the
    trace)."""
    out = {}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with span("traced"):
            yield out
            if cuda:
                torch.cuda.synchronize()
    t = time.perf_counter()
    device, spans, launch_us = [], [], 0.0
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            # a span shows on the device's timeline too, as an annotation
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.name[len(SPAN_PREFIX):], start, end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, start, end))
        elif e.name in ("cudaGraphLaunch", "cuGraphLaunch"):
            launch_us += end - start
    out["device"] = sorted(device, key=lambda x: x[1])
    out["spans"] = spans
    out["graph_launch_s"] = launch_us / 1e6
    out["read_s"] = time.perf_counter() - t


def spans_named(spans, name):
    return sorted((s, e) for n, s, e in spans if n == name)
