"""The least time each hand-written kernel could take on one H100: its roofline.

A launch's bound is the larger of the bytes it must move over the card's
memory rate and the operations it must do over its f32 rate (NVIDIA's data
sheet for the H100 SXM, dense, at the 700 W limit). Each input byte is
counted once and each output byte once; data-dependent work is counted at
what these inputs need (FAST: the pre-test on every interior pixel and the
full test only where it passes; KLT: only the live Gauss-Newton iterations),
so a kernel's share of its bound cannot pass 100% unless the count is wrong.
``klt_samples``, ``klt_level_bytes``, the operation counts and γ's bytes and
flops are copies of ``chip_smoke.py``'s; the FAST pre-test and the plain LK
level come from the reference's frozen plain kernels.
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.ops import plain_kernels

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12      # H100 SXM f32 rate outside the tensor cores
# Operations of FAST-10+NMS, counted on what an image needs: the exact
# four-point pre-test on every interior pixel (4 differences; per polarity
# 3 mins or maxes and a comparison; their OR), then, on the pixels that pass
# it, the full segment test (16 differences; per polarity 48 + 16 mins or
# maxes of the arc extrema by doubling and 15 to take the best arc; the max
# of the two polarities; the threshold test) and the NMS (8 maxes, 2 tests).
FAST_PRETEST_OPS = 4 + 2 * (3 + 1) + 1
FAST_CANDIDATE_OPS = 16 + 2 * (48 + 16 + 15) + 1 + 1 + 8 + 2
# Flops of one bilinear sample of the LK kernel (clamps, four loads, three
# lerps) and of the per-cell product-sum it feeds.
KLT_FLOPS_PER_SAMPLE = 20


def bound_s(nbytes, flops):
    """The launch's least time in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def gamma_bound_s(Smat_shape):
    """γ = rᵀS⁻¹r over n systems of R rows: the lower triangle of S and r
    read once, γ written once; a Cholesky factor and one triangular solve."""
    R = Smat_shape[-1]
    n = 1
    for d in Smat_shape[:-2]:
        n *= d
    nbytes = n * (R * (R + 1) // 2 + R) * 4 + n * 4
    flops = n * (R ** 3 / 3.0 + R ** 2)
    return bound_s(nbytes, flops)


def fast_bound_s(imgs, threshold):
    """FAST on (Bi, H, W) f32 images: one read and one write of each image;
    the pre-test on every interior pixel and the full test and NMS on the
    pixels that pass it."""
    Bi, H, W = imgs.shape
    interior = Bi * max(H - 6, 0) * max(W - 6, 0)
    passing = int(plain_kernels.fast_pretest_plain(imgs, threshold).sum())
    nbytes = 2 * Bi * H * W * 4
    return bound_s(nbytes, FAST_PRETEST_OPS * interior + FAST_CANDIDATE_OPS * passing)


def klt_bound_s(args, kw):
    """One LK level (the wrapper's arguments ``args``, ``kw``): the pixels
    its samples read, the points and flags, each once; the samples of the
    live iterations, which the plain level counts on these inputs."""
    window = 2 * (kw["window_size"] // 2) + 1
    live = plain_kernels.track_level_plain(*args, **kw, count_iters=True)[2]
    nbytes, _ = klt_level_bytes(args, window, live)
    flops = KLT_FLOPS_PER_SAMPLE * klt_samples(window, int(args[4].sum()), int(live.sum()))
    return bound_s(nbytes, flops)


def klt_samples(window, n_valid, live):
    """Bilinear samples one LK level needs: the template and its central
    differences at x +- 1, y +- 1 lie on one integer grid around the point, so
    they take (w + 2)^2 - 4 distinct samples a valid feature; then w^2 a live
    Gauss-Newton iteration."""
    return ((window + 2) ** 2 - 4) * n_valid + window ** 2 * live


def klt_level_bytes(args, window, live):
    """Bytes one LK level must move, each once: the pixels its samples read,
    the points and flags in and the points and flags out. Of the previous
    level, the union over the valid features of the template's patch (the
    clamped x0 and y0 of the window +- 1, plus one); of the current level,
    the union over the features that iterate (``live`` > 0) of the first
    iteration's patch (the window, plus one). Returns (bytes, pixels read)."""
    img_prev, _, pts_prev, pts_cur, valid = args
    Bi, H, W = img_prev.shape
    B, F = valid.shape
    half = window // 2
    image = torch.arange(B, device=valid.device)[:, None].expand(B, F)   # (B, F): the image read
    if Bi == 1:
        image = torch.zeros_like(image)

    def union(pts, mask, reach):
        b, p = image[mask], pts[mask]

        def span(c, size):
            lo = torch.clamp(torch.floor(c - reach), 0, size - 2).long()
            return lo, torch.clamp(torch.floor(c + reach), 0, size - 2).long() + 1

        (x0, x1), (y0, y1) = span(p[:, 0], W), span(p[:, 1], H)
        # a 2-D difference array of the rectangles, summed up both axes
        d = torch.zeros(Bi * (H + 1) * (W + 1), dtype=torch.int32, device=valid.device)
        for ys, xs, v in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1), (y1 + 1, x1 + 1, 1)):
            d.index_add_(0, (b * (H + 1) + ys) * (W + 1) + xs,
                         torch.full(ys.shape, v, dtype=torch.int32, device=d.device))
        cover = d.view(Bi, H + 1, W + 1).cumsum(1).cumsum(2)[:, :H, :W]
        return int((cover > 0).sum())

    pixels = union(pts_prev, valid, half + 1.0) + union(pts_cur, live > 0, float(half))
    return 4 * pixels + B * F * (2 * 8 + 1 + 8 + 1), pixels
