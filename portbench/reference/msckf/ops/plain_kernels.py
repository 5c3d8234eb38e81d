"""The three hand-written kernels' plain PyTorch versions, frozen.

The reference runs these where the program launches ``csrc/psd_gamma.cu``,
``csrc/fast_nms.cu`` and ``csrc/klt_level.cu``: the γ gate, FAST-10 with
3 × 3 non-max suppression, and one pyramid level of Lucas-Kanade. They are
copies of the plain versions beside the kernels; the kernels stop KLT early
per feature, which these reach by carrying a ``done`` mask through every
iteration.
"""

from __future__ import annotations

import torch

def gamma_psd(Smat: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """γ = ‖L⁻¹r‖² for S = LLᵀ in plain PyTorch; +inf where S is not PD."""
    L, info = torch.linalg.cholesky_ex(Smat)
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    gamma = torch.sum(y * y, dim=-1)
    return torch.where(info > 0, torch.full_like(gamma, float("inf")), gamma)


# (dx, dy) offsets of the 16-pixel Bresenham circle, in circular order.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _interior(H, W, border, device):
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)


def fast_score_10(img, threshold: float = 20.0):
    """FAST-10 corner mask and score. img: (Bi, H, W). Returns (mask, score).

    The score is the max over the 16 circular length-10 arcs of the min
    circle-minus-centre difference (bright arcs) or of its negation (dark
    arcs). The 3 px border, where the circle leaves the image, scores 0.
    """
    H, W = img.shape[-2:]
    diff = [torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) - img for dx, dy in FAST_OFFSETS]

    def best_arc(d):
        best = None
        for k in range(16):
            m = d[k]
            for j in range(1, 10):
                m = torch.minimum(m, d[(k + j) % 16])
            best = m if best is None else torch.maximum(best, m)
        return best

    score = torch.maximum(best_arc(diff), best_arc([-d for d in diff]))
    interior = _interior(H, W, 3, img.device)
    mask = (score > threshold) & interior
    return mask, torch.where(interior, score, torch.zeros_like(score))


def nonmax_3x3(score, mask):
    """Keep corners that are >= every masked neighbour of their 3x3 patch."""
    s = torch.where(mask, score, torch.full_like(score, -torch.inf))
    neighborhood = torch.full_like(s, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neighborhood = torch.maximum(neighborhood, torch.roll(s, (dy, dx), (-2, -1)))
    return mask & (s >= neighborhood) & (s > -torch.inf)


def fast_pretest_plain(imgs: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(Bi, H, W) -> bool (Bi, H, W): the kernel's exact pre-test.

    A score above ``threshold`` needs an arc of 10 contiguous circle pixels
    whose differences all exceed it, or all lie below its negation; any 10
    contiguous positions of the 16 hold two neighbouring compass points of
    d_0, d_4, d_8, d_12. So a pixel passes where some neighbouring compass
    pair has both d > t or both d < -t, and is >= 3 px from every edge;
    ``fast_score_10``'s mask lies inside this map for any threshold.
    """
    H, W = imgs.shape[-2:]
    d = [torch.roll(imgs, shifts=(-dy, -dx), dims=(-2, -1)) - imgs for dx, dy in FAST_OFFSETS[::4]]

    def pair(m):
        return (m[0] & m[1]) | (m[1] & m[2]) | (m[2] & m[3]) | (m[3] & m[0])

    passes = pair([x > threshold for x in d]) | pair([x < -threshold for x in d])
    return passes & _interior(H, W, 3, imgs.device)


def fast_nms_score_plain(imgs: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(Bi, H, W) -> (Bi, H, W) NMS-suppressed FAST-10 score in plain PyTorch."""
    mask, score = fast_score_10(imgs, threshold)
    keep = nonmax_3x3(score, mask)
    return torch.where(keep, score, torch.zeros_like(score))


def fast_nms_score(imgs: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    return fast_nms_score_plain(imgs, threshold)


def _bilinear(img, y, x):
    """Bilinear sample of img (Bi, H, W) at y, x (B, ...), Bi in {1, B}; each
    sample is clamped to the border (x0 = clip(floor x, 0, W-2), fx in [0, 1])."""
    Bi, H, W = img.shape
    # a point that is not finite (a diverged run) samples the corner, not
    # memory outside the image
    x0 = torch.clamp(torch.nan_to_num(torch.floor(x), nan=0.0), 0, W - 2)
    y0 = torch.clamp(torch.nan_to_num(torch.floor(y), nan=0.0), 0, H - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(Bi, H * W)
    idx = (y0.long() * W + x0.long()).reshape(y.shape[0], -1)

    def at(offset):
        if Bi == 1:
            return flat[0][idx + offset].reshape(y.shape)
        return torch.gather(flat, 1, idx + offset).reshape(y.shape)

    return (
        at(0) * (1 - fy) * (1 - fx)
        + at(1) * (1 - fy) * fx
        + at(W) * fy * (1 - fx)
        + at(W + 1) * fy * fx
    )


def track_level_plain(img_prev, img_cur, pts_prev, pts_cur, valid, window_size: int = 31,
                      max_iters: int = 30, eps: float = 1.0, min_eigen_threshold: float = 1e-5,
                      count_iters: bool = False):
    """One pyramid level of LK for all (B, F) features, in plain PyTorch.

    A feature starts ``done = not good``; each of the ``max_iters``
    Gauss-Newton iterations applies its step unless already done, then sets
    ``done`` once the step is shorter than ``eps``. Returns (pts (B, F, 2),
    good (B, F)), and with ``count_iters`` also the (B, F) number of
    iterations in which the feature was still live (the samples a kernel that
    stops early takes).
    """
    half = window_size // 2
    d = torch.arange(-half, half + 1, dtype=pts_prev.dtype, device=pts_prev.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")                    # (w, w)
    win_n = (2 * half + 1) ** 2

    def window(pt):
        return pt[..., 1, None, None] + gy, pt[..., 0, None, None] + gx   # (B, F, w, w)

    def wsum(a):
        return a.sum(dim=(-2, -1))

    ys, xs = window(pts_prev)
    # template and its central-difference gradients from the previous image
    tpl = _bilinear(img_prev, ys, xs)
    ix = 0.5 * (_bilinear(img_prev, ys, xs + 1) - _bilinear(img_prev, ys, xs - 1))
    iy = 0.5 * (_bilinear(img_prev, ys + 1, xs) - _bilinear(img_prev, ys - 1, xs))
    gxx = wsum(ix * ix)
    gxy = wsum(ix * iy)
    gyy = wsum(iy * iy)
    # min eigenvalue of G / window-size (cv semantics)
    tr = (gxx + gyy) / win_n
    det = (gxx * gyy - gxy * gxy) / (win_n * win_n)
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0)))
    good = valid & (min_eig > min_eigen_threshold)

    det_g = gxx * gyy - gxy * gxy
    det_g = torch.where(torch.abs(det_g) > 1e-12, det_g, torch.full_like(det_g, 1e-12))

    pt, done = pts_cur, ~good
    live = torch.zeros(good.shape, dtype=torch.int32, device=good.device)
    for _ in range(max_iters):
        live += (~done).to(torch.int32)
        cys, cxs = window(pt)
        diff = _bilinear(img_cur, cys, cxs) - tpl
        bx = wsum(diff * ix)
        by = wsum(diff * iy)
        # solve G d = -b
        dx = -(gyy * bx - gxy * by) / det_g
        dy = -(-gxy * bx + gxx * by) / det_g
        step = torch.stack([dx, dy], dim=-1)
        pt = torch.where(done[..., None], pt, pt + step)
        done = done | (torch.linalg.vector_norm(step, dim=-1) < eps)
    out = torch.where(good[..., None], pt, pts_cur), good
    return out + (live,) if count_iters else out


def track_level(img_prev, img_cur, pts_prev, pts_cur, valid, window_size: int = 31,
                max_iters: int = 30, eps: float = 1.0, min_eigen_threshold: float = 1e-5):
    return track_level_plain(img_prev, img_cur, pts_prev, pts_cur, valid, window_size,
                             max_iters, eps, min_eigen_threshold)
