"""FAST-10 score + 3x3 non-max suppression: the hand-written CUDA kernel and its plain version.

Port of ``msckf_mono_tpu/ops/fast_pallas.py``. Contract, as there:

    out[b, y, x] = FAST-10 score  if score > threshold and (y, x) is >= every
                                   masked score of its 3x3 neighbourhood
                   0              otherwise; 0 on the 3 px image border.

:func:`fast_nms_score` launches ``csrc/fast_nms.cu`` on a CUDA tensor and
takes :func:`fast_nms_score_plain` (:func:`fast_score_10` composed with
:func:`nonmax_3x3`) only for a tensor on the CPU. The kernel does the same
subtractions and min/max, so it equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msckf_mono_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("fast_nms")
    lib.fast_nms_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.fast_nms_launch.restype = ctypes.c_int
    return lib


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


def fast_nms_score_plain(imgs: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(Bi, H, W) -> (Bi, H, W) NMS-suppressed FAST-10 score in plain PyTorch."""
    mask, score = fast_score_10(imgs, threshold)
    keep = nonmax_3x3(score, mask)
    return torch.where(keep, score, torch.zeros_like(score))


def fast_nms_score(imgs: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(Bi, H, W) images -> (Bi, H, W) NMS-suppressed FAST-10 scores (0 = no corner).

    ``fast_nms_score.launches`` counts the kernel's launches.
    """
    if imgs.dim() != 3:
        raise ValueError(f"fast_nms_score: images {tuple(imgs.shape)} are not (Bi, H, W)")
    if imgs.device.type == "cpu":
        return fast_nms_score_plain(imgs, threshold)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_nms_score: images on {imgs.device}, not the CPU or CUDA")
    if imgs.dtype != torch.float32:
        raise TypeError(f"fast_nms_score: the kernel takes float32, got {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("fast_nms_score: the kernel takes a contiguous tensor")
    Bi, H, W = imgs.shape
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.fast_nms_launch(imgs.data_ptr(), out.data_ptr(), Bi, H, W, float(threshold), stream)
    if rc != 0:
        raise RuntimeError(f"fast_nms_score: kernel launch for {(Bi, H, W)} failed with CUDA "
                           f"error {rc} ({cuda_build.error_name('fast_nms', rc)})")
    _FAST_NMS_SCORE.launches += 1
    return out


# The count lives on the function object, as gamma_psd's does.
_FAST_NMS_SCORE = fast_nms_score
fast_nms_score.launches = 0
