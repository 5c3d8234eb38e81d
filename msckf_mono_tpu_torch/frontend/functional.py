"""Functional front-end: one state + one step per frame (port of ``msckf_mono_tpu/frontend/functional.py``).

The per-frame front-end of the reference's TrackHandler
(corner_detector.cpp:196-439) as a function over a :class:`FrontendState`:
predict by the gyro homography -> pyramidal KLT -> reject -> undistort ->
detect new corners in unoccupied grid cells -> carry one feature per cell.
Feature ids follow the reference's monotone scheme (next id incremented once
per frame, then once per new feature, corner_detector.cpp:407-411). The
stages (:func:`pyramid`, :func:`track`, :func:`tracked_outputs`,
:func:`detect_new`, :func:`dedup`) are also the live driver's,
``frontend/track_handler.TrackHandler``: each piece of the front-end's math
is written once.

Every tensor carries a leading filter-batch axis B. Images and the pyramid
carried in the state are ``(Bi, H, W)`` with Bi = 1 for a camera shared by
the batch (its pyramid, FAST, Shi-Tomasi and per-cell reduction run once a
frame) or Bi = B for independent streams. The step has no host syncs;
:func:`make_jitted_step` replays it from a captured CUDA graph on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from msckf_mono_tpu_torch.core.types import _Replace
from msckf_mono_tpu_torch.eval.profile import stage
from msckf_mono_tpu_torch.frontend import detect, klt, undistort
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils.config import MsckfConfig


@dataclass(frozen=True)
class FrontendConfig:
    """Static front-end parameters."""

    n_grid_rows: int = 10
    n_grid_cols: int = 10
    max_features: int = 128
    window_size: int = 31
    max_level: int = 4
    max_iters: int = 30
    fast_threshold: float = 20.0
    detection_threshold: float = 40.0
    max_flow_px: float = 25.0
    # Precision tier of the image-domain products (pyramid, Shi-Tomasi):
    # "highest" is full f32 (the parity default); "default" is TF32 for those
    # products on the card, as JAX's default precision is on a GPU (full f32
    # on the CPU), the tier bench.py serves the image path with
    # (klt.image_precision). The rest of the step stays full f32.
    image_precision: str = "highest"


@dataclass
class FrontendState(_Replace):
    pyramid: tuple          # previous image pyramid: (Bi, H/2^l, W/2^l) per level
    pts: torch.Tensor       # (B, F, 2) pixel coords in the previous image
    ids: torch.Tensor       # (B, F) int32
    valid: torch.Tensor     # (B, F) bool
    next_id: torch.Tensor   # (B,) int32
    has_prev: torch.Tensor  # (B,) bool


@dataclass
class FrontendOutput(_Replace):
    """Per-frame feature lists, shaped like core.filter.FrameInput's vision
    fields (undistorted normalized coordinates)."""

    tracked_uv: torch.Tensor
    tracked_ids: torch.Tensor
    tracked_valid: torch.Tensor
    new_uv: torch.Tensor
    new_ids: torch.Tensor
    new_valid: torch.Tensor


def init_frontend_state(height: int, width: int, fcfg: FrontendConfig, B: int = 1, Bi: int = 1,
                        dtype=torch.float32, device="cuda") -> FrontendState:
    """Fresh state for B filters reading Bi in {1, B} image streams."""
    F = fcfg.max_features
    pyr = klt.build_pyramid(torch.zeros((Bi, height, width), dtype=dtype, device=device),
                            fcfg.max_level)
    return FrontendState(
        pyramid=pyr,
        pts=torch.zeros((B, F, 2), dtype=dtype, device=device),
        ids=torch.full((B, F), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((B, F), dtype=torch.bool, device=device),
        next_id=torch.zeros((B,), dtype=torch.int32, device=device),
        has_prev=torch.zeros((B,), dtype=torch.bool, device=device),
    )


@functools.lru_cache(maxsize=None)
def _camera_arrays(config: MsckfConfig, dtype, device):
    """(K, K_inv), made once per config and device."""
    cam = config.camera
    K = torch.tensor(
        [[cam.f_u, 0.0, cam.c_u], [0.0, cam.f_v, cam.c_v], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device,
    )
    K_inv = torch.tensor(
        [
            [1.0 / cam.f_u, 0.0, -cam.c_u / cam.f_u],
            [0.0, 1.0 / cam.f_v, -cam.c_v / cam.f_v],
            [0.0, 0.0, 1.0],
        ],
        dtype=dtype, device=device,
    )
    return K, K_inv


def _cells(pts, H, W, n_rows, n_cols):
    """Grid cell of each (..., 2) point, clipped to the grid."""
    gh, gw = H // n_rows + 1, W // n_cols + 1
    row = torch.div(pts[..., 1], gh, rounding_mode="floor").to(torch.int32)
    col = torch.div(pts[..., 0], gw, rounding_mode="floor").to(torch.int32)
    return torch.clamp(row * n_cols + col, 0, n_rows * n_cols - 1).long()


def _take(x, order):
    """x (B, N, ...) gathered along axis 1 at order (B, M)."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(order.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def frontend_step(
    state: FrontendState,
    img: torch.Tensor,
    dR: torch.Tensor,
    config: MsckfConfig,
    fcfg: FrontendConfig,
) -> tuple[FrontendState, FrontendOutput]:
    """One frame: predict -> KLT -> reject -> detect new -> dedup carry,
    under a profiler the stages ``frontend.pyramid``, ``frontend.track``,
    ``frontend.detect`` and ``frontend.dedup`` (``eval/profile.stage``).

    img: (Bi, H, W); dR: (B, 3, 3), the camera-frame rotation over the
    inter-frame interval (the gyro integral, corner_detector.cpp:220-276), or
    (3, 3) for one rotation of the whole batch.
    """
    cam = config.camera
    dtype = state.pts.dtype
    K, K_inv = _camera_arrays(config, dtype, state.pts.device)
    img = img.to(dtype)
    cur_pyr = pyramid(img, fcfg)

    with stage("frontend.track"):
        pts, status = track(state.pyramid, cur_pyr, state.pts, state.valid & state.has_prev[:, None],
                            dR, K, K_inv, fcfg)
        tracked_uv, tracked_ids = tracked_outputs(pts, status, state.ids, K, cam.distortion_coeffs,
                                                  cam.distortion_model)

    new_xy, new_uv, new_ids, new_valid, next_id = detect_new(
        img, pts, status, state.next_id, K, cam.distortion_coeffs, cam.distortion_model, fcfg)
    out = FrontendOutput(tracked_uv=tracked_uv, tracked_ids=tracked_ids, tracked_valid=status,
                         new_uv=new_uv, new_ids=new_ids, new_valid=new_valid)

    cpts, cids, cvalid = dedup((pts, tracked_ids, status), (new_xy, new_ids, new_valid),
                               *img.shape[-2:], fcfg)
    new_state = FrontendState(pyramid=cur_pyr, pts=cpts, ids=cids, valid=cvalid, next_id=next_id,
                              has_prev=torch.ones_like(state.has_prev))
    return new_state, out


# ---- the stages, shared by frontend_step and frontend/track_handler.TrackHandler ----
# Each takes (B, F, ...) lists and (Bi, H, W) images. All but track open their
# frontend.* range; track's is opened by its caller, around whatever the
# caller does with the tracks before tracked_outputs (the live driver's RANSAC).

def pyramid(img, fcfg: FrontendConfig):
    """The image pyramid of (Bi, H, W) ``img`` (``frontend.pyramid``)."""
    with stage("frontend.pyramid"):
        return klt.build_pyramid(img, fcfg.max_level, precision=fcfg.image_precision)


def predict(pts, dR, K, K_inv):
    """Rotation-only homography prediction H = K·dR·K⁻¹ (cd.cpp:246-276) of
    (B, F, 2) points; dR (B, 3, 3) or (3, 3)."""
    Hm = K @ dR.to(K.dtype) @ K_inv
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1) @ Hm.transpose(-1, -2)
    z = ph[..., 2:3]
    return ph[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def track(prev_pyr, cur_pyr, pts, valid, dR, K, K_inv, fcfg: FrontendConfig):
    """KLT of the ``valid`` (B, F) points ``pts`` from ``prev_pyr`` into
    ``cur_pyr``, started at their prediction by dR, then the reference's
    rejection (corner_detector.cpp:320-394). Returns (pts, status)."""
    new_pts, status = klt.track_features_pyr(
        prev_pyr, cur_pyr, pts, predict(pts, dR, K, K_inv), valid,
        window_size=fcfg.window_size, max_iters=fcfg.max_iters,
    )
    return new_pts, klt.reject_outliers(pts, new_pts, status, tuple(cur_pyr[0].shape[-2:]),
                                        max_flow=fcfg.max_flow_px)


def tracked_outputs(pts, status, ids, K, dist_coeffs, dist_model):
    """The tracked list: (undistorted normalized uv, ids), zero and -1 where
    ``status`` is off."""
    uv = undistort.undistort_points(pts, K, dist_coeffs, dist_model)
    return torch.where(status[..., None], uv, 0.0), torch.where(status, ids, -1)


def detect_new(img, pts, status, next_id, K, dist_coeffs, dist_model, fcfg: FrontendConfig):
    """New corners in the grid cells that no tracked point holds
    (cd.cpp:396-429; ``frontend.detect``), budgeted to ``max_features``, with
    monotone ids: +1 once per frame, then sequential (cd.cpp:407-411).
    Returns (pixel xy, undistorted uv, ids, valid, next next_id)."""
    with stage("frontend.detect"):
        H, W = img.shape[-2:]
        n_cells = fcfg.n_grid_rows * fcfg.n_grid_cols
        cell = _cells(pts, H, W, fcfg.n_grid_rows, fcfg.n_grid_cols)
        occupied = torch.zeros((pts.shape[0], n_cells + 1), dtype=torch.bool, device=pts.device)
        occupied.scatter_(1, torch.where(status, cell, n_cells), True)
        xy, _score, det_valid = detect.detect_features(
            img, occupied[:, :n_cells], fcfg.n_grid_rows, fcfg.n_grid_cols,
            fcfg.fast_threshold, fcfg.detection_threshold, st_precision=fcfg.image_precision,
        )
        valid, xy = first_valid(det_valid, fcfg.max_features, xy)
        xy = torch.where(valid[..., None], xy, 0.0).to(pts.dtype)
        n_valid = valid.to(torch.int32)
        seq = torch.cumsum(n_valid, dim=1, dtype=torch.int32) - 1
        ids = torch.where(valid, next_id[:, None] + 1 + seq, -1)
        next_id = next_id + 1 + torch.sum(n_valid, dim=1, dtype=torch.int32)
        uv = undistort.undistort_points(xy, K, dist_coeffs, dist_model)
        return xy, torch.where(valid[..., None], uv, 0.0), ids, valid, next_id


def dedup(tracked, new, H, W, fcfg: FrontendConfig):
    """The carry for the next frame (``frontend.dedup``): the tracked and the
    new (pts, ids, valid) lists, the first valid entry of each grid cell
    (cd.cpp:292-308), compacted to ``max_features``."""
    with stage("frontend.dedup"):
        return _grid_dedup(*(torch.cat(pair, dim=1) for pair in zip(tracked, new)), H, W,
                           fcfg.n_grid_rows, fcfg.n_grid_cols, fcfg.max_features)


def first_valid(valid, n, *lists):
    """The first ``n`` valid entries of each row of (B, N) lists, in order:
    (valid, *lists), each gathered to (B, n, ...)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :n]
    return (torch.gather(valid, 1, order),) + tuple(_take(x, order) for x in lists)


def _grid_dedup(pts, ids, valid, H, W, n_rows, n_cols, out_n):
    """Keep the first valid entry of each grid cell, compacted to out_n rows."""
    B, N = valid.shape
    n_cells = n_rows * n_cols
    cell = _cells(pts, H, W, n_rows, n_cols)
    order_idx = torch.arange(N, device=valid.device).expand(B, N)
    first = torch.full((B, n_cells), N, dtype=torch.long, device=valid.device).scatter_reduce(
        1, cell, torch.where(valid, order_idx, N), "amin", include_self=True)
    keep = valid & (torch.gather(first, 1, cell) == order_idx)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :out_n]
    kept = torch.gather(keep, 1, order)
    return (
        torch.where(kept[..., None], _take(pts, order), 0.0),
        torch.where(kept, torch.gather(ids, 1, order), torch.full((), -1, dtype=ids.dtype,
                                                                  device=ids.device)),
        kept,
    )


def make_jitted_step(config: MsckfConfig, fcfg: FrontendConfig):
    """``step(state, img, dR) -> (state, FrontendOutput)``: :func:`frontend_step`
    replayed from a captured CUDA graph on the card
    (``msckf_mono_tpu/frontend/functional.py:230``), with fresh outputs."""
    return cuda_graph.jit(frontend_step, (config, fcfg))


def frontend_state_to_numpy(state: FrontendState) -> dict:
    """The state as {field path: numpy array}, with the keys the JAX package's
    state flattens to ("pyramid[0]", ..., "pts", "ids", ...)."""
    out = {f"pyramid[{i}]": p.detach().cpu().numpy().copy() for i, p in enumerate(state.pyramid)}
    for f in dataclasses.fields(state):
        if f.name != "pyramid":
            out[f.name] = getattr(state, f.name).detach().cpu().numpy().copy()
    return out


def frontend_state_from_numpy(arrays: dict, device="cuda") -> FrontendState:
    """Inverse of :func:`frontend_state_to_numpy`. Arrays carry the leading
    batch axes: (Bi, H, W) levels, (B, ...) for the rest."""
    levels = sorted((k for k in arrays if k.startswith("pyramid[")),
                    key=lambda k: int(k[len("pyramid["):-1]))

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    return FrontendState(
        pyramid=tuple(t(arrays[k]) for k in levels),
        **{f.name: t(arrays[f.name]) for f in dataclasses.fields(FrontendState)
           if f.name != "pyramid"},
    )
