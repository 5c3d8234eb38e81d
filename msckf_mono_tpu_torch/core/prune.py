"""Window pruning (port of ``msckf_mono_tpu/core/prune.py``).

``pruneEmptyStates`` / ``pruneRedundantStates`` / ``findRedundantCamStates``
(msckf.h:453-761, 1049-1098). Slot removal is masked compaction
(core/window.py); the redundant path's "use the doomed observations in one
last update" is the same projected-row machinery as marginalization,
restricted to the involved observation columns.

Behavioral notes (all from the reference):
* empty pruning only ever removes a LEADING run of feature-less states, and
  only while the window exceeds ``max_cam_states`` (msckf.h:699-717);
* redundant pruning is gated on a hardcoded window size of 20 (msckf.h:455);
* keyframe selection walks the window marking states too close in both
  distance and angle to the last kept keyframe, never touching the last 3
  states, stopping once the window would fit, then tops up with the oldest
  unmarked states; fewer than 2 marks means no pruning (msckf.h:1049-1098);
* tracks keep a cached triangulation (``initialized``/``p_f_G``) that later
  prunes reuse (msckf.h:488-531).
"""

from __future__ import annotations

import torch

from msckf_mono_tpu_torch.core import triangulate
from msckf_mono_tpu_torch.core.types import FilterState
from msckf_mono_tpu_torch.core.update import gated_row_stack, measurement_update
from msckf_mono_tpu_torch.core.window import compact_slots, gather_rows, stable_order
from msckf_mono_tpu_torch.utils import quat
from msckf_mono_tpu_torch.utils.config import MsckfConfig


def slot_has_active_features(state: FilterState):
    """Per slot (B, N): does any live track observe it?"""
    return torch.any(state.tracks.active[:, :, None] & state.tracks.obs_mask, dim=1)


def _archive_removed(state: FilterState, rm) -> FilterState:
    """Append the rm-marked slots' poses (at removal) to the per-frame pruned
    archive (the feed for the reference's ``pruned_states_``, msckf.h:49).
    Both prune stages of one frame append into the same N-wide buffer; their
    slot sets are disjoint. Slot j lands at n_old + cumsum(rm)[j] - 1.
    """
    w = state.window
    B, N = rm.shape
    dev = rm.device
    n_old = torch.sum(state.pruned_mask, dim=1, keepdim=True, dtype=torch.int32)
    tgt = n_old + torch.cumsum(rm, dim=1, dtype=torch.int32) - 1
    tgt = torch.where(rm & (tgt < N), tgt, torch.full_like(tgt, N)).long()  # N: dropped
    bidx = torch.arange(B, device=dev)[:, None]

    def put(old, new):
        buf = torch.cat([old, torch.zeros_like(old[:, :1])], dim=1)
        buf[bidx, tgt] = new
        return buf[:, :N]

    newrow = put(torch.zeros_like(state.pruned_mask), torch.ones_like(rm))
    return state.replace(
        pruned_q=torch.where(newrow[..., None], put(state.pruned_q, w.q_CG), state.pruned_q),
        pruned_p=torch.where(newrow[..., None], put(state.pruned_p, w.p_C_G), state.pruned_p),
        pruned_time=torch.where(newrow, put(state.pruned_time, w.time), state.pruned_time),
        pruned_ids=torch.where(newrow, put(state.pruned_ids, w.state_id), state.pruned_ids),
        pruned_mask=state.pruned_mask | newrow,
    )


def clear_frame_archive(state: FilterState) -> FilterState:
    """Reset the per-frame pruned/tri-map buffers (called at frame start)."""
    return state.replace(
        pruned_q=torch.zeros_like(state.pruned_q),
        pruned_p=torch.zeros_like(state.pruned_p),
        pruned_time=torch.zeros_like(state.pruned_time),
        pruned_ids=torch.full_like(state.pruned_ids, -1),
        pruned_mask=torch.zeros_like(state.pruned_mask),
        tri_map_pts=torch.zeros_like(state.tri_map_pts),
        tri_map_mask=torch.zeros_like(state.tri_map_mask),
    )


def prune_empty_states(state: FilterState, config: MsckfConfig) -> FilterState:
    N = config.shapes.num_slots
    max_states = config.filter.max_cam_states
    count = state.window.count
    has = slot_has_active_features(state)

    over = count - max_states  # only slots 0..over-1 are candidates
    idx = torch.arange(N, device=has.device)
    nonempty_tail = has & (idx >= 1)
    first_nonempty = torch.where(
        torch.any(nonempty_tail, dim=1),
        torch.argmax(nonempty_tail.to(torch.int32), dim=1).to(torch.int32),
        over,
    )
    n_remove = torch.minimum(first_nonempty, over)
    n_remove = torch.where((count > max_states) & ~has[:, 0], n_remove, torch.zeros_like(n_remove))

    keep = state.window.valid & (idx >= n_remove[:, None])
    state = _archive_removed(state, state.window.valid & ~keep)
    return compact_slots(state, keep)


def find_redundant_slots(state: FilterState, config: MsckfConfig):
    """Keyframe-style selection of slots to remove (msckf.h:1049-1098); (B, N) bool.

    The reference's walk with early stop is a fixed loop over j = 1..N-1 with
    ``stopped`` and per-slot ``active`` masks.
    """
    N = config.shapes.num_slots
    window = state.window
    count = window.count
    max_states = config.filter.max_cam_states
    dist_thresh = config.redundancy_distance
    angle_thresh = config.redundancy_angle
    dev = count.device

    idx = torch.arange(N, device=dev)
    protected = idx >= (count - 3)[:, None]  # the last 3 states are never candidates

    marks = []
    marked = torch.zeros_like(count)
    kf = torch.zeros_like(count).long()
    stopped = torch.zeros_like(window.valid[:, 0])
    for j in range(1, N):
        active = window.valid[:, j] & ~protected[:, j] & ~stopped
        p_kf = gather_rows(window.p_C_G, kf[:, None])[:, 0]
        q_kf = gather_rows(window.q_CG, kf[:, None])[:, 0]
        dist = torch.linalg.norm(window.p_C_G[:, j] - p_kf, dim=-1)
        angle = quat.angular_distance(window.q_CG[:, j], q_kf)
        close = (dist < dist_thresh) & (angle < angle_thresh)
        mark = active & close
        marks.append(mark)
        marked = marked + mark.to(torch.int32)
        kf = torch.where(active & ~close, torch.full_like(kf, j), kf)
        stopped = stopped | (active & ((count - marked) <= max_states))
    rm = torch.stack([torch.zeros_like(stopped)] + marks, dim=1)

    # Top-up: mark the first num_over_max slots that are still unmarked.
    num_over_max = count - marked - max_states
    topup = (idx < num_over_max[:, None]) & ~rm & window.valid
    rm = rm | topup

    enough = (torch.sum(rm, dim=1) >= 2) & (count >= 5)
    return rm & enough[:, None]


def prune_prep(state: FilterState, config: MsckfConfig):
    """Redundant-slot selection + candidate compaction + triangulation (the
    front half of msckf.h:453-682). Returns a dict of staged prune inputs."""
    fcfg = config.filter
    shp = config.shapes
    window = state.window
    tracks = state.tracks
    B = state.batch_size
    dev = tracks.obs.device
    bidx = torch.arange(B, device=dev)[:, None]
    q_CG = window.q_CG[:, None]
    p_C_G = window.p_C_G[:, None]

    run = window.count >= 20  # hardcoded in the reference (msckf.h:455)
    rm = find_redundant_slots(state, config) & run[:, None]

    involved = tracks.obs_mask & rm[:, None, :]                       # (B, M, N)
    n_involved = torch.sum(involved, dim=2)

    # Tracks needing residualization of their involved obs (>=2 of them).
    cand = tracks.active & (n_involved >= 2)

    # LM-triangulate ONLY the candidates without a cached triangulation (the
    # reference caches too, msckf.h:488-531), at most max_tri_prune of them.
    T = min(shp.max_tri_prune, shp.max_tracks)
    tri_cand = cand & ~tracks.initialized
    torder = stable_order(~tri_cand)[:, :T]
    t_valid = torch.gather(tri_cand, 1, torder)
    t_obs = gather_rows(tracks.obs, torder)
    t_mask = gather_rows(tracks.obs_mask, torder) & t_valid[:, :, None]
    motion_ok_t, p_new_t, tri_ok_t = triangulate.triangulate_tracks(
        t_obs, t_mask, q_CG, p_C_G, fcfg.translation_threshold, config.max_gn_cost_norm,
        n_iters=fcfg.lm_iters, n_trials=fcfg.lm_trials,
    )
    ok_t = t_valid & motion_ok_t & tri_ok_t & torch.all(torch.isfinite(p_new_t), dim=-1)
    p_new_t = torch.nan_to_num(p_new_t, nan=0.0, posinf=0.0, neginf=0.0)

    def scatter_tab(like, values):
        out = torch.zeros_like(like)
        out[bidx, torder] = values
        return out

    newly_init_tab = scatter_tab(tracks.initialized, ok_t)
    p_new_tab = scatter_tab(tracks.p_f_G, torch.where(ok_t[..., None], p_new_t,
                                                      torch.zeros_like(p_new_t)))
    # Which tracks got an LM attempt (regardless of success): used below to
    # count tri-budget drops without double-counting candidates the S buffer
    # already dropped.
    tri_attempted_tab = scatter_tab(tracks.initialized, t_valid)

    # Compact candidate tracks into a fixed buffer of max_staged_prune rows.
    S = shp.max_staged_prune
    order = stable_order(~cand)[:, :S]
    c_valid = torch.gather(cand, 1, order)
    c_obs = gather_rows(tracks.obs, order)
    c_mask_inv = gather_rows(involved, order) & c_valid[:, :, None]
    c_init = torch.gather(tracks.initialized, 1, order) & c_valid
    c_new = torch.gather(newly_init_tab, 1, order) & c_valid
    n_dropped_tracks = torch.clamp(torch.sum(cand, dim=1) - S, min=0).to(torch.int32)
    # Tri-budget drops counted only among IN-BUFFER candidates.
    n_tri_dropped = torch.sum(c_valid & ~c_init & ~torch.gather(tri_attempted_tab, 1, order),
                              dim=1, dtype=torch.int32)

    use_track = c_valid & (c_init | c_new)
    p_use = torch.where(c_new[..., None], gather_rows(p_new_tab, order),
                        gather_rows(tracks.p_f_G, order))

    return dict(
        rm=rm, c_obs=c_obs, c_mask_inv=c_mask_inv, p_use=p_use,
        use_track=use_track, newly_init_tab=newly_init_tab,
        p_new_tab=p_new_tab,
        tri_pts=p_new_t, tri_ok=ok_t,
        n_dropped_tracks=n_dropped_tracks + n_tri_dropped,
    )


def prune_post(state: FilterState, prep, gate_ok, n_rows_dropped,
               config: MsckfConfig) -> FilterState:
    """Cache write-back, involved-obs erasure, slot removal, diagnostics
    (the back half of msckf.h:453-682)."""
    rm = prep["rm"]
    newly_init_tab, p_new_tab = prep["newly_init_tab"], prep["p_new_tab"]

    tracks = state.tracks
    tracks = tracks.replace(
        initialized=tracks.initialized | newly_init_tab,
        p_f_G=torch.where(newly_init_tab[..., None], p_new_tab, tracks.p_f_G),
    )
    # Erase involved observations from every track (msckf.h:482-485, 498-524,
    # 597-606 — all paths end with the involved obs removed).
    keep_col = ~rm[:, None, :]
    tracks = tracks.replace(
        obs_mask=tracks.obs_mask & keep_col,
        obs=tracks.obs * keep_col[..., None],
    )
    state = state.replace(
        tracks=tracks,
        tri_map_pts=prep["tri_pts"].to(state.P.dtype),
        tri_map_mask=prep["tri_ok"],
    )

    # Archive then remove the slots (poses are post-one-last-update here).
    state = _archive_removed(state, state.window.valid & rm)
    keep = state.window.valid & ~rm
    state = compact_slots(state, keep)

    d = state.diag
    diag = d.replace(
        row_overflow=d.row_overflow + n_rows_dropped,
        staged_overflow=d.staged_overflow + prep["n_dropped_tracks"],
        gating_rejects=d.gating_rejects
        + torch.sum(prep["use_track"] & ~gate_ok, dim=1, dtype=torch.int32),
    )
    return state.replace(diag=diag)


def prune_redundant_states(state: FilterState, config: MsckfConfig) -> FilterState:
    dtype = state.P.dtype
    sigma2 = state.meas_sigma2.to(dtype)
    prep = prune_prep(state, config)
    out = gated_row_stack(
        prep["c_obs"], prep["c_mask_inv"], prep["p_use"], prep["use_track"],
        state.window, state.imu.g, state.P, sigma2, config,
        m_cap=config.shapes.prune_obs_cap or None,
        chunk=config.shapes.prune_chunk or None,
    )
    H, r, gate_ok, _rows_present, n_rows_dropped = out[:5]
    # out[5:] is (V, v_track_ids) with use_anisotropic_r, else empty
    state = measurement_update(state, H, r, sigma2, config, *out[5:])
    return prune_post(state, prep, gate_ok, n_rows_dropped, config)
