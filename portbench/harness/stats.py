"""Arithmetic of the benchmark's numbers: interval unions, idle gaps,
percentiles, and a count of synchronizing calls.

``union_ms``, ``percentile`` and ``SyncCounter`` are copies of
``chip_smoke.py``'s ``_union_ms``, ``_percentile`` and ``SyncCounter``.
"""

from __future__ import annotations

import numpy as np


def union_ms(spans):
    """Length of the union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def clipped_union_ms(spans, windows):
    """Length of the union of ``spans`` inside the union of ``windows``
    (both (start, end) in µs), in ms."""
    clipped = [(max(s, ws), min(e, we)) for s, e in spans for ws, we in windows
               if min(e, we) > max(s, ws)]
    return union_ms(clipped)


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))



def gaps(spans, lo, hi):
    """The idle intervals of [lo, hi] that no span of ``spans`` covers, as
    (start, end) pairs in µs, longest first."""
    out, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


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
