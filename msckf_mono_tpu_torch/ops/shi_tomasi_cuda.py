"""Shi-Tomasi score, FAST/NMS gate and per-cell best: the hand-written CUDA kernel and its plain version.

Contract, for images (Bi, H, W) and their FAST/NMS map (``fast_cuda.fast_nms_score``,
0 = no corner) on a grid of n_rows x n_cols cells of (H // n_rows + 1) x
(W // n_cols + 1) pixels, row-major, the last row and column padded past the
image:

    v(y, x)     = Shi-Tomasi min-eigenvalue score where the map is > 0, else -1;
                  -1 on the padding;
    best[b, c]  = max of v over cell c of image b;
    local[b, c] = its row-major index in the cell, the smallest on ties.

:func:`shi_tomasi_cells` launches ``csrc/shi_tomasi.cu`` on CUDA tensors and
takes :func:`shi_tomasi_cells_plain` only for tensors on the CPU. The plain
version is the front-end's own: :func:`shi_tomasi_score_plain` (the central
differences and the box sums as banded matrix products, the form the JAX
package gives the TPU's matrix unit) and :func:`cell_best_plain` (the tile
reduction). The kernel does the sums with running float64 sums, so it
agrees with the plain version to rounding, not bit for bit: closer to the
plain version computed in float64 than the float32 plain version is.
The kernel replaces no TPU kernel: the JAX package computes the score in
plain JAX (``msckf_mono_tpu/frontend/detect.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from msckf_mono_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("shi_tomasi")
    lib.shi_tomasi_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.shi_tomasi_launch.restype = ctypes.c_int
    lib.shi_tomasi_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.shi_tomasi_plan.restype = ctypes.c_int
    return lib


def launch_plan(H: int, W: int, halfbox: int = 15, n_rows: int = 10, n_cols: int = 10):
    """The launcher's plan on the card (asks the built library): (th, tw,
    smem_bytes), the largest sub-tile of a cell a block stages and its
    shared memory; None where the launcher refuses the sizes."""
    th, tw, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _load().shi_tomasi_plan(H, W, halfbox, n_rows, n_cols, ctypes.byref(th),
                                 ctypes.byref(tw), ctypes.byref(smem))
    return None if rc else (th.value, tw.value, smem.value)


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


def shi_tomasi_score_plain(img, halfbox: int = 15):
    """Min-eigenvalue response per pixel (reference corner_detector.cpp:38-79).

    img: (Bi, H, W). Gradients and box sums are banded matrix products in the
    image's dtype, at the matrix-product precision in force (the front-end's
    ``detect.shi_tomasi_score`` sets its tier).
    """
    H, W = img.shape[-2:]
    Gy, Gx, Bv, Bh = _grad_box_operators(H, W, halfbox, img.dtype, img.device)
    box_area = (2 * halfbox) ** 2
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


def cell_tiles(scores, n_rows: int = 10, n_cols: int = 10):
    """(Bi, H, W) -> (Bi, C, cell pixels): each grid cell's pixels in the
    cell's row-major order, the image padded to whole cells with -1."""
    H, W = scores.shape[-2:]
    grid_h = H // n_rows + 1
    grid_w = W // n_cols + 1
    Hp = n_rows * grid_h
    Wp = n_cols * grid_w
    sp = torch.nn.functional.pad(scores, (0, Wp - W, 0, Hp - H), value=-1.0)
    Bi = sp.shape[0]
    tiles = sp.reshape(Bi, n_rows, grid_h, n_cols, grid_w).permute(0, 1, 3, 2, 4)
    return tiles.reshape(Bi, n_rows * n_cols, grid_h * grid_w)


def cell_best_plain(st, nms_score, n_rows: int = 10, n_cols: int = 10):
    """(Bi, H, W) score map and FAST/NMS map -> (best (Bi, C), local (Bi, C)).

    Best per cell as a tile reduction (:func:`cell_tiles`). Tile-local
    row-major order is image row-major order within a cell, so argmax's
    first-occurrence tie-break picks the smallest flat index.
    """
    scores = torch.where(nms_score > 0, st, torch.full_like(st, -1.0))
    return torch.max(cell_tiles(scores, n_rows, n_cols), dim=-1)


def shi_tomasi_cells_plain(imgs, nms_score, halfbox: int = 15, n_rows: int = 10, n_cols: int = 10):
    """The plain version of :func:`shi_tomasi_cells`."""
    return cell_best_plain(shi_tomasi_score_plain(imgs, halfbox), nms_score, n_rows, n_cols)


def shi_tomasi_cells(imgs, nms_score, halfbox: int = 15, n_rows: int = 10, n_cols: int = 10):
    """(Bi, H, W) images and their FAST/NMS map -> (best (Bi, C), local (Bi, C)
    int64): each grid cell's highest Shi-Tomasi score among the map's corners
    (-1 where it has none) and its index in the cell.

    ``shi_tomasi_cells.launches`` counts the kernel's launches.
    """
    if imgs.dim() != 3 or nms_score.shape != imgs.shape:
        raise ValueError(f"shi_tomasi_cells: images {tuple(imgs.shape)} and map "
                         f"{tuple(nms_score.shape)} are not both (Bi, H, W)")
    if halfbox < 1 or n_rows < 1 or n_cols < 1:
        raise ValueError(f"shi_tomasi_cells: halfbox {halfbox} and grid {n_rows} x {n_cols} "
                         "must be at least 1")
    if imgs.device.type == "cpu" and nms_score.device.type == "cpu":
        return shi_tomasi_cells_plain(imgs, nms_score, halfbox, n_rows, n_cols)
    dev = imgs.device
    if dev.type != "cuda" or nms_score.device != dev:
        raise ValueError(f"shi_tomasi_cells: images on {imgs.device}, map on "
                         f"{nms_score.device}; both must be on the CPU or on one CUDA device")
    if imgs.dtype != torch.float32 or nms_score.dtype != torch.float32:
        raise TypeError(f"shi_tomasi_cells: the kernel takes float32, got {imgs.dtype} and "
                        f"{nms_score.dtype}")
    if not (imgs.is_contiguous() and nms_score.is_contiguous()):
        raise ValueError("shi_tomasi_cells: the kernel takes contiguous tensors")
    Bi, H, W = imgs.shape
    best = torch.empty((Bi, n_rows * n_cols), dtype=torch.float32, device=dev)
    local = torch.empty((Bi, n_rows * n_cols), dtype=torch.int64, device=dev)
    if Bi == 0 or H == 0 or W == 0:
        return best.fill_(-1.0), local.zero_()
    with cuda_build.on_device(dev):
        rc = _load().shi_tomasi_launch(imgs.data_ptr(), nms_score.data_ptr(), best.data_ptr(),
                                       local.data_ptr(), Bi, H, W, halfbox, n_rows, n_cols,
                                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shi_tomasi_cells: kernel launch for {(Bi, H, W)}, halfbox {halfbox}, "
                           f"grid {n_rows} x {n_cols} failed with CUDA error {rc} "
                           f"({cuda_build.error_name('shi_tomasi', rc)})")
    _SHI_TOMASI_CELLS.launches += 1
    return best, local


# The count lives on the function object, as gamma_psd's does.
_SHI_TOMASI_CELLS = shi_tomasi_cells
shi_tomasi_cells.launches = 0
