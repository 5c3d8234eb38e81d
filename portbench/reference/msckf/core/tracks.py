"""Track bookkeeping (port of ``msckf_mono_tpu/core/tracks.py``).

Fixed-shape form of ``MSCKF::update`` and ``MSCKF::addFeatures``
(msckf.h:215-332): "is this tracked feature still observed" is an (M x F) id
equality matrix, "remove track & stage for residualization" is a stable
compaction of the dead rows into a fixed ``max_staged`` buffer, and
"push_back new track" is a masked scatter into free rows.

Deviations from the reference, as in the JAX package: duplicate new ids are
skipped per feature (the reference aborts addFeatures, msckf.h:327-330), and
``camState::last_correlated_id`` is not maintained.
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.core.types import FilterState, StagedTracks
from portbench.reference.msckf.core.window import gather_rows, stable_order
from portbench.reference.msckf.utils.config import MsckfConfig


def update_tracks(state: FilterState, tracked_uv, tracked_ids, tracked_valid, config: MsckfConfig):
    """Append observations of continuing tracks; stage dead / too-long tracks.

    tracked_uv: (B, F, 2); tracked_ids, tracked_valid: (B, F). Must run after
    ``augment_state`` (observations land in the newest slot).

    Returns (new_state, staged: StagedTracks).
    """
    shp = config.shapes
    N, S = shp.num_slots, shp.max_staged
    tracks = state.tracks
    dev = tracks.obs.device
    newest = (state.window.count - 1).long()
    is_newest = torch.arange(N, device=dev) == newest[:, None]        # (B, N)

    # --- match active tracks against this frame's tracked features ---
    match = (
        tracks.active[:, :, None]
        & tracked_valid[:, None, :]
        & (tracks.feature_id[:, :, None] == tracked_ids[:, None, :])
    )  # (B, M, F)
    matched = torch.any(match, dim=2)
    feat_idx = torch.argmax(match.to(torch.int32), dim=2)
    new_obs = gather_rows(tracked_uv, feat_idx)                       # (B, M, 2)

    put = matched[:, :, None] & is_newest[:, None, :]                 # (B, M, N)
    obs = torch.where(put[..., None], new_obs[:, :, None, :], tracks.obs)
    obs_mask = tracks.obs_mask | put

    lengths = torch.sum(obs_mask, dim=2)
    # Death: lost by the front-end, or track too long (msckf.h:246-248 — the
    # length check runs after the append, so the fresh obs is included).
    dead = tracks.active & (~matched | (lengths >= config.filter.max_track_length))
    eligible = dead & (lengths >= config.filter.min_track_length)

    # --- compact eligible rows into the staged buffer ---
    order = stable_order(~eligible)[:, :S]
    staged_valid = torch.gather(eligible, 1, order)
    staged = StagedTracks(
        obs=gather_rows(obs, order),
        obs_mask=gather_rows(obs_mask, order) & staged_valid[:, :, None],
        feature_id=torch.gather(tracks.feature_id, 1, order),
        valid=staged_valid,
    )
    n_eligible = torch.sum(eligible, dim=1)
    overflow = torch.clamp(n_eligible - S, min=0).to(torch.int32)

    # --- clear all dead rows (staged or not), mirroring tracks_to_remove ---
    keep = ~dead
    new_tracks = tracks.replace(
        obs=obs * keep[:, :, None, None],
        obs_mask=obs_mask & keep[:, :, None],
        feature_id=torch.where(keep, tracks.feature_id, torch.full_like(tracks.feature_id, -1)),
        active=tracks.active & keep,
        initialized=tracks.initialized & keep,
        p_f_G=tracks.p_f_G * keep[:, :, None],
    )

    diag = state.diag.replace(staged_overflow=state.diag.staged_overflow + overflow)
    return state.replace(tracks=new_tracks, diag=diag), staged


def add_features(state: FilterState, new_uv, new_ids, new_valid, config: MsckfConfig):
    """Register brand-new tracks at the newest camera state (msckf.h:302-332).

    new_uv: (B, F, 2); new_ids, new_valid: (B, F).
    """
    M = config.shapes.max_tracks
    tracks = state.tracks
    dev = tracks.obs.device
    B = state.batch_size
    newest = (state.window.count - 1).long()

    dup = torch.any(
        tracks.active[:, :, None] & (tracks.feature_id[:, :, None] == new_ids[:, None, :]),
        dim=1,
    )
    valid = new_valid & ~dup & (new_ids >= 0)
    F = valid.shape[1]

    # Compact valid new features to the front.
    norder = stable_order(~valid)
    uv_c = gather_rows(new_uv, norder)
    ids_c = torch.gather(new_ids, 1, norder)
    valid_c = torch.gather(valid, 1, norder)

    # Free track rows, compacted to the front.
    free = ~tracks.active
    forder = stable_order(~free)
    n_free = torch.sum(free, dim=1, keepdim=True)

    f_idx = torch.arange(F, device=dev)
    assign = valid_c & (f_idx < n_free)
    rows = torch.where(assign, forder[:, f_idx % M], torch.full_like(forder[:, :1], M))  # M = dropped

    # Scatter into tables with one spare row M that takes the dropped writes.
    bidx = torch.arange(B, device=dev)[:, None]
    col = newest[:, None].expand(B, F)

    def pad(x, value):
        extra = torch.full((B, 1) + tuple(x.shape[2:]), value, dtype=x.dtype, device=dev)
        return torch.cat([x, extra], dim=1)

    obs = pad(tracks.obs, 0)
    obs[bidx, rows, col] = uv_c.to(obs.dtype)
    # device values: a Python scalar here is a host->device copy that syncs
    true = torch.ones(rows.shape, dtype=torch.bool, device=dev)
    obs_mask = pad(tracks.obs_mask, False)
    obs_mask[bidx, rows, col] = true
    feature_id = pad(tracks.feature_id, -1)
    feature_id[bidx, rows] = ids_c.to(feature_id.dtype)
    active = pad(tracks.active, False)
    active[bidx, rows] = true

    n_valid = torch.sum(valid, dim=1)
    overflow = torch.clamp(n_valid - n_free[:, 0], min=0).to(torch.int32)

    new_tracks = tracks.replace(
        obs=obs[:, :M], obs_mask=obs_mask[:, :M], feature_id=feature_id[:, :M], active=active[:, :M]
    )
    diag = state.diag.replace(track_overflow=state.diag.track_overflow + overflow)
    return state.replace(tracks=new_tracks, diag=diag)
