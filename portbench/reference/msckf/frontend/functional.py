"""Functional front-end: one state + one step per frame (port of ``msckf_mono_tpu/frontend/functional.py``).

The per-frame front-end of the reference's TrackHandler
(corner_detector.cpp:196-439) as a function over a :class:`FrontendState`:
predict by the gyro homography -> pyramidal KLT -> reject -> undistort ->
detect new corners in unoccupied grid cells -> carry one feature per cell.
Feature ids follow the reference's monotone scheme (next id incremented once
per frame, then once per new feature, corner_detector.cpp:407-411).

Every tensor carries a leading filter-batch axis B. Images and the pyramid
carried in the state are ``(Bi, H, W)`` with Bi = 1 for a camera shared by
the batch (its pyramid, FAST, Shi-Tomasi and per-cell reduction run once a
frame) or Bi = B for independent streams. The step has no host syncs.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.msckf.core.types import _Replace
from portbench.reference.msckf.frontend import detect, klt, undistort
from portbench.reference.msckf.utils.config import MsckfConfig


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
    """One frame: predict -> KLT -> reject -> detect new -> dedup carry.

    img: (Bi, H, W); dR: (B, 3, 3), the camera-frame rotation over the
    inter-frame interval (the gyro integral, corner_detector.cpp:220-276).
    """
    cam = config.camera
    dtype = state.pts.dtype
    dev = state.pts.device
    F = fcfg.max_features
    B = state.pts.shape[0]
    H, W = img.shape[-2:]
    K, K_inv = _camera_arrays(config, dtype, dev)

    img = img.to(dtype)
    cur_pyr = klt.build_pyramid(img, fcfg.max_level, precision=fcfg.image_precision)

    # ---- track (corner_detector.cpp:320-394) ----
    Hm = K @ dR.to(dtype) @ K_inv                                           # (B, 3, 3)
    ph = torch.cat([state.pts, torch.ones((B, F, 1), dtype=dtype, device=dev)], dim=-1)
    ph = ph @ Hm.transpose(-1, -2)
    denom = torch.where(torch.abs(ph[..., 2:3]) < 1e-12,
                        torch.full_like(ph[..., 2:3], 1e-12), ph[..., 2:3])
    pred = ph[..., :2] / denom

    track_valid = state.valid & state.has_prev[:, None]
    pts, status = klt.track_features_pyr(
        state.pyramid, cur_pyr, state.pts, pred, track_valid,
        window_size=fcfg.window_size, max_iters=fcfg.max_iters,
    )
    status = klt.reject_outliers(state.pts, pts, status, (H, W), max_flow=fcfg.max_flow_px)

    tracked_uv = undistort.undistort_points(pts, K, cam.distortion_coeffs, cam.distortion_model)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    tracked_ids = torch.where(status, state.ids, minus1)

    # ---- detect new corners in unoccupied cells (cd.cpp:396-429) ----
    n_cells = fcfg.n_grid_rows * fcfg.n_grid_cols
    cell = _cells(pts, H, W, fcfg.n_grid_rows, fcfg.n_grid_cols)
    occupied = torch.zeros((B, n_cells + 1), dtype=torch.bool, device=dev)
    occupied.scatter_(1, torch.where(status, cell, n_cells), True)
    occupied = occupied[:, :n_cells]

    xy, _score, det_valid = detect.detect_features(
        img, occupied, fcfg.n_grid_rows, fcfg.n_grid_cols,
        fcfg.fast_threshold, fcfg.detection_threshold,
        st_precision=fcfg.image_precision,
    )
    order = torch.argsort((~det_valid).to(torch.uint8), dim=1, stable=True)[:, :F]
    new_valid = torch.gather(det_valid, 1, order)
    new_xy = torch.where(new_valid[..., None], _take(xy, order), 0.0).to(dtype)
    # monotone ids: +1 once per frame, then sequential (cd.cpp:407-411)
    n_valid = new_valid.to(torch.int32)
    seq = torch.cumsum(n_valid, dim=1, dtype=torch.int32) - 1
    new_ids = torch.where(new_valid, state.next_id[:, None] + 1 + seq, minus1)
    next_id = state.next_id + 1 + torch.sum(n_valid, dim=1, dtype=torch.int32)
    new_uv = undistort.undistort_points(new_xy, K, cam.distortion_coeffs, cam.distortion_model)

    out = FrontendOutput(
        tracked_uv=torch.where(status[..., None], tracked_uv, 0.0).to(dtype),
        tracked_ids=tracked_ids,
        tracked_valid=status,
        new_uv=torch.where(new_valid[..., None], new_uv, 0.0).to(dtype),
        new_ids=new_ids,
        new_valid=new_valid,
    )

    # ---- carry for the next frame: tracked + new, one per cell (cd.cpp:292-308) ----
    cpts, cids, cvalid = _grid_dedup(
        torch.cat([pts, new_xy], dim=1), torch.cat([tracked_ids, new_ids], dim=1),
        torch.cat([status, new_valid], dim=1), H, W,
        fcfg.n_grid_rows, fcfg.n_grid_cols, F,
    )
    new_state = FrontendState(
        pyramid=cur_pyr, pts=cpts, ids=cids, valid=cvalid, next_id=next_id,
        has_prev=torch.ones_like(state.has_prev),
    )
    return new_state, out


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
