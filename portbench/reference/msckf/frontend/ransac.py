"""Two-point translation RANSAC with gyro-known rotation (port of ``msckf_mono_tpu/frontend/ransac.py``).

``TrackHandler::twoPointRansac`` (reference corner_detector.cpp:445-546):
300 hypotheses, the 2-point translation kernel (the cross product of the two
rows of the 2x3 constraint matrix, what FullPivLU::kernel computes up to
scale), Sampson-error inliers; every hypothesis is scored at once.

Sampling is split from scoring: :func:`sample_pairs` draws the hypotheses'
point pairs from a ``utils/prng`` key, the JAX package's own ``jax.random``
draws, on the points' device and without a host read (a captured CUDA graph
runs it); :func:`score_pairs` scores any given pairs. The reference ships the
filter disabled (``&& false``, corner_detector.cpp:366), and so does the
track handler.
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.core.window import stable_order
from portbench.reference.msckf.utils import prng, quat


def sample_pairs(valid, key, num_iters: int = 300, int_bits: int = 32):
    """Index pairs (i1, i2) (num_iters,) of two distinct valid points each,
    as the JAX package draws them (ransac.py:44-49): of n = max(n_valid, 2)
    valid points, a uniform first rank and an offset in [1, n - 2].
    valid: (F,) bool; ``int_bits``: the width of JAX's default int (32, or
    64 under x64)."""
    k1, k2 = prng.split(key.to(valid.device))
    pool = stable_order(~valid)                                     # valid first
    n = torch.clamp(torch.sum(valid), min=2)
    # randint(k1, .., 0, n) and randint(k2, .., 1, max(n - 1, 1)) in one call
    draws = prng.randint(torch.stack([k1, k2]), (num_iters,),
                         torch.stack([torch.zeros_like(n), torch.ones_like(n)])[:, None],
                         torch.stack([n, torch.clamp(n - 1, min=1)])[:, None], int_bits)
    r1, off = draws[0], draws[1]
    return pool[r1], pool[(r1 + off) % n]


def score_pairs(dR, old_pts, new_pts, valid, i1, i2, threshold: float = 2e-7):
    """Inlier mask (F,) of the best of the hypotheses given by the pairs.

    old_pts/new_pts: (F, 2) normalized coords; dR (3, 3) rotates the old frame
    to the new one. With fewer than 5 valid points every valid point is an
    inlier (corner_detector.cpp:480-483).
    """
    ones = torch.ones_like(old_pts[:, :1])
    x1 = torch.cat([old_pts, ones], dim=-1)                         # (F, 3)
    x2 = torch.cat([new_pts, ones], dim=-1)
    Rx1 = x1 @ dR.T

    # rows (dR x1_i)ᵀ [x2_i]_x; the translation is the kernel of the 2x3 pair
    r0 = (Rx1[i1][:, None, :] @ quat.skew(x2[i1]))[:, 0]              # (I, 3)
    r1 = (Rx1[i2][:, None, :] @ quat.skew(x2[i2]))[:, 0]
    t = torch.linalg.cross(r0, r1)
    tn = torch.linalg.vector_norm(t, dim=-1)
    ok = tn > 1e-12
    t = torch.where(ok[:, None], t / torch.clamp(tn, min=1e-12)[:, None], torch.zeros_like(t))
    E = quat.skew(t) @ dR                                           # (I, 3, 3)
    Ex1 = x1 @ E.transpose(-1, -2)                                  # (I, F, 3)
    Ex2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Ex2[..., 0] ** 2 + Ex2[..., 1] ** 2
    err = num / torch.clamp(den, min=1e-30)
    inliers = (err < threshold) & valid & ok[:, None]
    best = torch.argmax(torch.sum(inliers, dim=-1))
    # index_select keeps the row choice on the device (a 0-d index reads it)
    return torch.where(torch.sum(valid) < 5, valid, inliers.index_select(0, best[None])[0])


def two_point_ransac(dR, old_pts, new_pts, valid, key, threshold: float = 2e-7,
                     num_iters: int = 300):
    """:func:`sample_pairs` then :func:`score_pairs`; returns the inlier mask (F,).

    The pairs are drawn with JAX's default int for ``dR``'s dtype: 64 bits
    in float64 (which JAX runs only under x64), 32 otherwise."""
    int_bits = 64 if dR.dtype == torch.float64 else 32
    i1, i2 = sample_pairs(valid, key, num_iters, int_bits)
    return score_pairs(dR, old_pts, new_pts, valid, i1, i2, threshold)
