"""The comparison that decides ``correct``: the program's answers against
the reference's, each number beside its limit.

A traffic file's ``check.limits`` names the numbers a cell compares; each is
a function of :data:`NUMBERS`, of ``out`` (what the program served:
``served``, a list of (T_i, 3) arrays, row i's positions over the frames it
was served; and, where the driver keeps them, ``pyramids``, a list of
(frame, [level arrays])) and ``ref`` (the reference's trail of the same:
``p`` (T, rows, 3), ``pyramids`` a list of [level arrays]).
"""

from __future__ import annotations

import numpy as np


def row_gaps(program, reference):
    """Per row, the gaps in metres between its served positions and the
    reference's, frame by frame; a gap that is not finite reads infinite."""
    out = []
    for i, got in enumerate(program):
        want = reference[: got.shape[0], i]
        gap = np.linalg.norm(np.asarray(got, np.float64) - want, axis=-1)
        out.append(np.where(np.isfinite(gap), gap, np.inf))
    return out


def position_gap_m(out, ref):
    """The widest gap between a served position and the reference's."""
    return max((float(g.max(initial=0.0)) for g in row_gaps(out["served"], ref["p"])),
               default=0.0)


def pyramid_gap(out, ref):
    """The widest gap, in grey levels, between a pyramid level the program
    carried out of a frame and the level the reference builds from the same
    frame. It reads the image products alone, which no decision of the
    filter or the tracker feeds back into."""
    got, want = out["pyramids"], ref["pyramids"]
    if not got or len(got) != len(want):
        raise ValueError(f"{len(got)} pyramids served, {len(want)} from the reference")
    worst = 0.0
    for (_, levels), ref_levels in zip(got, want):
        for a, b in zip(levels, ref_levels):
            gap = np.abs(np.asarray(a, np.float64) - b)
            if not np.all(np.isfinite(gap)):
                return float("inf")
            worst = max(worst, float(gap.max(initial=0.0)))
    return worst


NUMBERS = {"pos_gap_m": position_gap_m, "pyramid_gap": pyramid_gap}


def numbers(out, ref, names):
    """{name: value} of the numbers ``names``, each of :data:`NUMBERS`."""
    unknown = sorted(set(names) - set(NUMBERS))
    if unknown:
        raise ValueError(f"no comparison named {unknown}: expected one of {sorted(NUMBERS)}")
    return {k: NUMBERS[k](out, ref) for k in names}


def verdict(numbers, limits):
    """{name: {"value", "limit"}} and whether every value is within its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
