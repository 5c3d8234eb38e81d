"""Window slot compaction (port of ``msckf_mono_tpu/core/window.py``).

The reference erases camera states from ``std::vector`` and slices covariance
blocks (msckf.h:626-681, matrix_utils.h:57-87). The fixed-shape equivalent is
one permutation applied consistently to (a) the window arrays, (b) the track
observation columns and (c) the 6x6 covariance blocks, followed by masking
the now-invalid tail. Here the permutation is a gather; the JAX package's
one-hot matmul form is a TPU rewrite of the same exact selection.
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.core.types import FilterState


def stable_order(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of a bool/int key along the last axis (int64)."""
    return torch.sort(key.to(torch.int32), dim=-1, stable=True)[1]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i], ...]`` for x (B, N, ...) and idx (B, I) -> (B, I, ...)."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bidx, idx]


def slot_permutation(keep: torch.Tensor):
    """Stable front-compaction order for kept slots.

    keep: (B, N). Returns (order (B, N) int64, new_valid (B, N) bool): new slot
    i holds old slot ``order[:, i]``; slots >= sum(keep) become invalid.
    """
    N = keep.shape[-1]
    order = stable_order(~keep)
    n_keep = torch.sum(keep, dim=-1, keepdim=True)
    new_valid = torch.arange(N, device=keep.device) < n_keep
    return order, new_valid


def permute_window_tracks(state: FilterState, order, new_valid) -> FilterState:
    """Apply a slot permutation to the window arrays and track observation columns."""
    window = state.window
    tracks = state.tracks
    new_window = window.replace(
        q_CG=gather_rows(window.q_CG, order),
        p_C_G=gather_rows(window.p_C_G, order),
        time=gather_rows(window.time, order),
        state_id=torch.where(new_valid, gather_rows(window.state_id, order),
                             torch.full_like(window.state_id, -1)),
        valid=new_valid,
    )
    M = tracks.obs_mask.shape[1]
    col = order[:, None, :].expand(-1, M, -1)
    new_obs_mask = torch.gather(tracks.obs_mask, 2, col) & new_valid[:, None, :]
    new_obs = torch.gather(tracks.obs, 2, col[..., None].expand(-1, -1, -1, 2))
    new_tracks = tracks.replace(
        obs=new_obs * new_obs_mask[..., None],
        obs_mask=new_obs_mask,
    )
    return state.replace(window=new_window, tracks=new_tracks)


def permute_covariance(P: torch.Tensor, order, new_valid) -> torch.Tensor:
    """P' = E P Eᵀ for the slot permutation, then zero invalid rows/cols.

    E is the block permutation (identity on the 15 IMU dims, slot order[i]'s
    6 dims to slot i's), applied as a two-sided gather.
    """
    B, N = order.shape
    D = P.shape[-1]
    dev = P.device
    cam = 15 + (order[:, :, None] * 6 + torch.arange(6, device=dev)).reshape(B, 6 * N)
    dims = torch.cat([torch.arange(15, device=dev).expand(B, 15), cam], dim=1)   # (B, D)
    P = torch.gather(P, 1, dims[:, :, None].expand(B, D, D))
    P = torch.gather(P, 2, dims[:, None, :].expand(B, D, D))
    dim_valid = torch.cat(
        [torch.ones((B, 15), dtype=torch.bool, device=dev), new_valid.repeat_interleave(6, dim=1)],
        dim=1,
    )
    return P * (dim_valid[:, :, None] & dim_valid[:, None, :])


def compact_slots(state: FilterState, keep: torch.Tensor) -> FilterState:
    """Remove window slots where ``keep`` is False, compacting survivors to the
    front in original (chronological) order.

    ``keep`` must be False for all already-invalid slots.
    """
    order, new_valid = slot_permutation(keep)
    state = permute_window_tracks(state, order, new_valid)
    return state.replace(P=permute_covariance(state.P, order, new_valid))
