"""Corner detection (port of ``msckf_mono_tpu/frontend/detect.py``).

FAST-10 segment test with its score, 3x3 non-max suppression, the Shi-Tomasi
min-eigenvalue response over a 30x30 patch as banded matrix products, and
the per-grid-cell best corner above ``detection_threshold`` with an
occupancy mask (reference corner_detector.cpp:8-134).

Images are ``(Bi, H, W)``. ``Bi`` is 1 for a camera shared by every filter of
the batch, or B for independent streams; the image-only work (FAST, NMS,
Shi-Tomasi, the per-cell tile reduction) runs once per image, never B times,
and only the occupancy test is per filter. FAST + NMS goes through
``ops/fast_cuda.fast_nms_score``: the CUDA kernel for a CUDA tensor, its
plain version (:func:`fast_score_10` then :func:`nonmax_3x3`, which live
beside the kernel's wrapper) for a CPU one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.msckf.frontend.klt import image_precision
from portbench.reference.msckf.ops import plain_kernels as fast_cuda
from portbench.reference.msckf.ops.plain_kernels import FAST_OFFSETS, fast_score_10, nonmax_3x3

__all__ = ["FAST_OFFSETS", "detect_features", "fast_score_10", "nonmax_3x3", "shi_tomasi_score"]

@functools.lru_cache(maxsize=None)
def _grad_box_matrices(H: int, W: int, half: int):
    """Banded operators of the dense Shi-Tomasi response, as numpy arrays.

    Central difference along an axis (zero border rows: the interior mask
    never reads them) and the [v-half, v+half) box sum clipped to the image
    (the reference's patch convention, corner_detector.cpp:49-72).
    """

    def grad(n):
        G = np.zeros((n, n), np.float32)
        for i in range(1, n - 1):
            G[i, i + 1] = 1.0
            G[i, i - 1] = -1.0
        return G

    def box(n):
        B = np.zeros((n, n), np.float32)
        for i in range(n):
            B[i, max(i - half, 0) : max(min(i + half, n), 0)] = 1.0
        return B

    return grad(H), grad(W), box(H), box(W)


@functools.lru_cache(maxsize=None)
def _grad_box_operators(H: int, W: int, half: int, dtype, device):
    """:func:`_grad_box_matrices` as tensors, made once per device: a copy
    from host memory every frame would stall the host on the device."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _grad_box_matrices(H, W, half))


def shi_tomasi_score(img, halfbox: int = 15, precision: str = "highest"):
    """Min-eigenvalue response per pixel (reference corner_detector.cpp:38-79).

    img: (Bi, H, W). Gradients and box sums are banded matrix products in the
    image's dtype at ``precision`` (``klt.image_precision``: "default" is
    TF32 on the card, full f32 on the CPU).
    """
    H, W = img.shape[-2:]
    Gy, Gx, Bv, Bh = _grad_box_operators(H, W, halfbox, img.dtype, img.device)
    box_area = (2 * halfbox) ** 2
    with image_precision(precision, img):
        dx = img @ Gx.T                # I(x+1) - I(x-1)
        dy = Gy @ img
        Z = torch.stack([dx * dx, dy * dy, dx * dy], dim=-3)    # (Bi, 3, H, W)
        S = (Bv @ Z @ Bh.T) / (2.0 * box_area)
    dxx, dyy, dxy = S[..., 0, :, :], S[..., 1, :, :], S[..., 2, :, :]

    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0))
    score = 0.5 * (tr - disc)

    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    # the reference returns 0 where the patch touches the 1 px-padded border
    interior = (
        (yy - halfbox >= 1) & (yy + halfbox < H - 1)
        & (xx - halfbox >= 1) & (xx + halfbox < W - 1)
    )
    return torch.where(interior, score, torch.zeros_like(score))


def detect_features(
    img,
    occupied_cells,
    n_rows: int = 10,
    n_cols: int = 10,
    fast_threshold: float = 20.0,
    detection_threshold: float = 40.0,
    st_precision: str = "highest",
):
    """At most one new corner per unoccupied grid cell.

    img: (Bi, H, W); occupied_cells: (B, C) bool with C = n_rows * n_cols and
    Bi in {1, B}; ``st_precision``: the Shi-Tomasi products' tier. Returns
    (xy (B, C, 2), score (B, C), valid (B, C)).
    """
    H, W = img.shape[-2:]
    grid_h = H // n_rows + 1
    grid_w = W // n_cols + 1
    n_cells = n_rows * n_cols

    nms = fast_cuda.fast_nms_score(img, fast_threshold) > 0
    st = shi_tomasi_score(img, precision=st_precision)
    # Occupancy is per cell, so it is applied after the tile reduction and
    # the (Bi, H, W) score map stays image-only.
    scores = torch.where(nms, st, torch.full_like(st, -1.0))

    # Best per cell as a tile reduction: pad to whole cells, reshape to
    # (C, cell_px) and reduce. Tile-local row-major order is image row-major
    # order within a cell, so argmax's first-occurrence tie-break picks the
    # smallest flat index.
    Hp = n_rows * grid_h
    Wp = n_cols * grid_w
    sp = torch.nn.functional.pad(scores, (0, Wp - W, 0, Hp - H), value=-1.0)
    Bi = sp.shape[0]
    tiles = sp.reshape(Bi, n_rows, grid_h, n_cols, grid_w).permute(0, 1, 3, 2, 4)
    flat = tiles.reshape(Bi, n_cells, grid_h * grid_w)
    best, local = torch.max(flat, dim=-1)
    cells = torch.arange(n_cells, device=img.device)
    cy = cells // n_cols
    cx = cells % n_cols
    wy = (cy * grid_h + local // grid_w).to(img.dtype)
    wx = (cx * grid_w + local % grid_w).to(img.dtype)
    valid = (best > detection_threshold) & ~occupied_cells       # (B, C)
    xy = torch.stack([wx, wy], dim=-1).expand(valid.shape + (2,))
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return (torch.where(valid[..., None], xy, zero),
            torch.where(valid, best.expand(valid.shape), zero), valid)
