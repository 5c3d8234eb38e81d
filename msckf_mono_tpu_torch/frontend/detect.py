"""Corner detection (port of ``msckf_mono_tpu/frontend/detect.py``).

FAST-10 segment test with its score, 3x3 non-max suppression, the Shi-Tomasi
min-eigenvalue response over a 30x30 patch, and the per-grid-cell best corner
above ``detection_threshold`` with an occupancy mask (reference
corner_detector.cpp:8-134).

Images are ``(Bi, H, W)``. ``Bi`` is 1 for a camera shared by every filter of
the batch, or B for independent streams; the image-only work (FAST, NMS,
Shi-Tomasi, the per-cell reduction) runs once per image, never B times, and
only the occupancy test is per filter. FAST + NMS goes through
``ops/fast_cuda.fast_nms_score`` and, at the "highest" tier, Shi-Tomasi with
the per-cell reduction through ``ops/shi_tomasi_cuda.shi_tomasi_cells``: the
CUDA kernels for CUDA tensors, their plain versions (which live beside the
kernels' wrappers) for CPU ones. At the "default" (TF32) tier the score is
the plain version's banded matrix products under ``klt.image_precision``.
"""

from __future__ import annotations

import torch

from msckf_mono_tpu_torch.frontend.klt import image_precision
from msckf_mono_tpu_torch.ops import fast_cuda, shi_tomasi_cuda
from msckf_mono_tpu_torch.ops.fast_cuda import FAST_OFFSETS, fast_score_10, nonmax_3x3

__all__ = ["FAST_OFFSETS", "detect_features", "fast_score_10", "nonmax_3x3", "shi_tomasi_score"]


def shi_tomasi_score(img, halfbox: int = 15, precision: str = "highest"):
    """Min-eigenvalue response per pixel (reference corner_detector.cpp:38-79).

    img: (Bi, H, W). Gradients and box sums are banded matrix products in the
    image's dtype at ``precision`` (``klt.image_precision``: "default" is
    TF32 on the card, full f32 on the CPU); ``ops/shi_tomasi_cuda.
    shi_tomasi_score_plain``.
    """
    with image_precision(precision, img):
        return shi_tomasi_cuda.shi_tomasi_score_plain(img, halfbox)


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

    nms = fast_cuda.fast_nms_score(img, fast_threshold)
    # Occupancy is per cell, so it is applied after the per-cell reduction
    # and the image-only work runs once per image.
    if st_precision == "highest":
        best, local = shi_tomasi_cuda.shi_tomasi_cells(img, nms, n_rows=n_rows, n_cols=n_cols)
    else:
        best, local = shi_tomasi_cuda.cell_best_plain(
            shi_tomasi_score(img, precision=st_precision), nms, n_rows, n_cols)
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
