"""One Lucas-Kanade pyramid level: the hand-written CUDA kernel and its plain version.

Port of ``msckf_mono_tpu/ops/klt_pallas.py``, whose contract is the JAX
package's ``frontend/klt._track_level``: for every (B, F) feature a bilinear window
template from the previous level with central-difference gradients, the 2x2
structure tensor and its min-eigenvalue gate, then up to ``max_iters``
Gauss-Newton steps on the current level, stopping once a step is shorter
than ``eps``. Images are (Bi, H, W) with Bi in {1, B}: a shared image is read
by every filter, never copied B-fold.

:func:`track_level` launches ``csrc/klt_level.cu`` on CUDA tensors and takes
:func:`track_level_plain` only for tensors on the CPU. The kernel clamps each
sample as the plain version does (the TPU kernel's edge-replicated padding is
not carried over), so the two agree on border features too; they sum the
window in different orders, so positions agree to float32 rounding, except
where the ``eps`` stop test fires one iteration apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msckf_mono_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("klt_level")
    lib.klt_level_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    lib.klt_level_launch.restype = ctypes.c_int
    return lib


def _bilinear(img, y, x):
    """Bilinear sample of img (Bi, H, W) at y, x (B, ...), Bi in {1, B}; each
    sample is clamped to the border (x0 = clip(floor x, 0, W-2), fx in [0, 1])."""
    Bi, H, W = img.shape
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
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


def _check(img_prev, img_cur, pts_prev, pts_cur, valid):
    if img_prev.dim() != 3 or img_prev.shape != img_cur.shape:
        raise ValueError(f"track_level: images {tuple(img_prev.shape)} / {tuple(img_cur.shape)} "
                         "are not both (Bi, H, W)")
    B, F = pts_prev.shape[:2]
    if (pts_prev.shape != (B, F, 2) or pts_cur.shape != (B, F, 2) or valid.shape != (B, F)
            or img_prev.shape[0] not in (1, B)):
        raise ValueError(f"track_level: points {tuple(pts_prev.shape)} / {tuple(pts_cur.shape)}, "
                         f"valid {tuple(valid.shape)} and images {tuple(img_prev.shape)} are not "
                         "(B, F, 2), (B, F, 2), (B, F) and (1 or B, H, W)")


def track_level(img_prev, img_cur, pts_prev, pts_cur, valid, window_size: int = 31,
                max_iters: int = 30, eps: float = 1.0, min_eigen_threshold: float = 1e-5):
    """One LK level. Images (Bi, H, W); points (B, F, 2); valid (B, F) bool.

    Returns (pts (B, F, 2), good (B, F) bool) in the level's pixel
    coordinates. ``track_level.launches`` counts the kernel's launches.
    """
    _check(img_prev, img_cur, pts_prev, pts_cur, valid)
    tensors = (img_prev, img_cur, pts_prev, pts_cur, valid)
    if all(t.device.type == "cpu" for t in tensors):
        return track_level_plain(img_prev, img_cur, pts_prev, pts_cur, valid, window_size,
                                 max_iters, eps, min_eigen_threshold)
    dev = img_prev.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"track_level: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on the CPU or on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors[:4]) or valid.dtype != torch.bool:
        raise TypeError(f"track_level: the kernel takes float32 images and points and a bool "
                        f"mask, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("track_level: the kernel takes contiguous tensors")
    Bi, H, W = img_prev.shape
    B, F = valid.shape
    out_pts = torch.empty_like(pts_cur)
    out_good = torch.empty_like(valid)
    if B * F == 0:
        return out_pts, out_good
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.klt_level_launch(
            img_prev.data_ptr(), img_cur.data_ptr(), Bi, H, W,
            pts_prev.data_ptr(), pts_cur.data_ptr(), valid.data_ptr(),
            out_pts.data_ptr(), out_good.data_ptr(),
            B, F, window_size // 2, max_iters, float(eps), float(min_eigen_threshold), stream,
        )
    if rc != 0:
        raise RuntimeError(f"track_level: kernel launch for B={B}, F={F}, window {window_size}, "
                           f"level {H}x{W} failed with CUDA error {rc} "
                           f"({cuda_build.error_name('klt_level', rc)})")
    _TRACK_LEVEL.launches += 1
    return out_pts, out_good


# The count lives on the function object, as gamma_psd's does.
_TRACK_LEVEL = track_level
track_level.launches = 0
