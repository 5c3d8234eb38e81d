"""Pyramidal Lucas-Kanade optical flow (port of ``msckf_mono_tpu/frontend/klt.py``).

The re-design of cv::calcOpticalFlowPyrLK with OPTFLOW_USE_INITIAL_FLOW
(reference corner_detector.cpp:136-194):

* Gaussian pyramid by the 5-tap [1,4,6,4,1]/16 pyrDown, as two banded matrix
  products per level;
* per level, forward-additive LK over a square window, up to ``max_iters``
  Gauss-Newton steps, stopping once a step is shorter than ``eps``;
* the min-eigenvalue gate on the normalized structure tensor and the
  in-image checks give the status mask.

Images and pyramid levels are ``(Bi, H, W)`` with ``Bi`` in {1, B}: a shared
camera's pyramid is built once and read by every filter. Points are
``(B, F, 2)`` xy. Each level runs ``ops/klt_cuda.track_level``: the CUDA
kernel for CUDA tensors, :func:`ops.klt_cuda.track_level_plain` for CPU ones.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from portbench.reference.msckf.ops import plain_kernels as klt_cuda


@functools.lru_cache(maxsize=None)
def _down_matrices(H: int, W: int):
    """Banded downsample operators of one pyrDown level, as numpy arrays.

    ``out = Av @ img @ Ah.T`` is exactly the 5-tap [1,4,6,4,1]/16
    edge-clamped blur + 2x subsample: ``Av[i, clip(2i + t - 2)] += k[t]``.
    """
    k = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0

    def band(n_out, n_in):
        A = np.zeros((n_out, n_in), np.float32)
        for i in range(n_out):
            for t in range(5):
                A[i, min(max(2 * i + t - 2, 0), n_in - 1)] += k[t]
        return A

    return band(-(-H // 2), H), band(-(-W // 2), W)


@functools.lru_cache(maxsize=None)
def _down_operators(H: int, W: int, dtype, device):
    """:func:`_down_matrices` as tensors, made once per device."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in _down_matrices(H, W))


@contextlib.contextmanager
def image_precision(precision: str, x: torch.Tensor):
    """The matrix-product tier of the image-domain products (the pyramid
    and Shi-Tomasi), ``FrontendConfig.image_precision``, as JAX gives
    ``Precision`` on a GPU and a CPU: ``"highest"`` is full f32;
    ``"default"`` is TF32 for the products inside this context on CUDA
    tensors, and full f32 on the CPU. The package keeps TF32 off everywhere
    else (``msckf_mono_tpu_torch/__init__.py``): the switch is in force only
    while these products are dispatched (in a graph's warm-up and capture
    too, which is when cuBLAS's math mode is fixed) and restored after."""
    if precision not in ("highest", "default"):
        raise ValueError(f"image_precision {precision!r}: expected 'highest' or 'default'")
    if precision == "highest" or not x.is_cuda:
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _pyr_down(imgs, precision: str = "highest"):
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)): blur and 2x subsample
    (cv2 pyrDown semantics), in the images' dtype, the two banded products
    at ``precision`` (:func:`image_precision`)."""
    H, W = imgs.shape[-2:]
    Av, Ah = _down_operators(H, W, imgs.dtype, imgs.device)
    with image_precision(precision, imgs):
        return Av @ (imgs @ Ah.T)


def build_pyramid(img, levels: int, precision: str = "highest"):
    pyr = [img]
    for _ in range(levels):
        pyr.append(_pyr_down(pyr[-1], precision))
    return tuple(pyr)


def track_features(img_prev, img_cur, pts_prev, pts_pred, valid, window_size: int = 31,
                   max_level: int = 4, max_iters: int = 30, eps: float = 1.0,
                   min_eigen_threshold: float = 1e-5):
    """Track (B, F, 2) points from img_prev to img_cur (each (Bi, H, W))
    starting at pts_pred. Returns (pts_out (B, F, 2), status (B, F))."""
    return track_features_pyr(
        build_pyramid(img_prev, max_level), build_pyramid(img_cur, max_level),
        pts_prev, pts_pred, valid, window_size=window_size, max_iters=max_iters,
        eps=eps, min_eigen_threshold=min_eigen_threshold,
    )


def track_features_pyr(pyr_prev, pyr_cur, pts_prev, pts_pred, valid, window_size: int = 31,
                       max_iters: int = 30, eps: float = 1.0,
                       min_eigen_threshold: float = 1e-5):
    """Pyramid-input variant: pyramids are tuples of (Bi, H/2^l, W/2^l) levels,
    so a caller can reuse the previous frame's pyramid."""
    max_level = len(pyr_prev) - 1
    # cv2 semantics: buildOpticalFlowPyramid stops before levels smaller
    # than the tracking window (decided from static shapes): a 51-px window
    # on a 30-px top level spans the whole image and seeds level 0 off.
    while max_level > 0 and min(pyr_prev[max_level].shape[-2:]) < window_size + 2:
        max_level -= 1

    scale_top = 2.0**max_level
    pts_p = pts_prev / scale_top
    pts_c = pts_pred / scale_top
    status = valid

    for lvl in range(max_level, -1, -1):
        if lvl != max_level:
            pts_p = pts_prev / (2.0**lvl)
            pts_c = pts_c * 2.0
        pts_c, good = klt_cuda.track_level(
            pyr_prev[lvl], pyr_cur[lvl], pts_p, pts_c, status,
            window_size=window_size, max_iters=max_iters, eps=eps,
            min_eigen_threshold=min_eigen_threshold,
        )
        # cv keeps tracking through levels; status is finalized at level 0
        if lvl == 0:
            status = status & good

    H, W = pyr_cur[0].shape[-2:]
    x, y = pts_c[..., 0], pts_c[..., 1]
    in_img = (x >= 0) & (x <= W) & (y >= 0) & (y <= H)
    return pts_c, status & in_img


def reject_outliers(pts_prev, pts_cur, status, img_shape, max_flow: float = 25.0):
    """The reference's post-track rejection (corner_detector.cpp:176-193)."""
    H, W = img_shape
    flow = torch.linalg.vector_norm(pts_cur - pts_prev, dim=-1)
    x, y = pts_cur[..., 0], pts_cur[..., 1]
    return status & (flow <= max_flow) & (x >= 0) & (x <= W) & (y >= 0) & (y <= H)
