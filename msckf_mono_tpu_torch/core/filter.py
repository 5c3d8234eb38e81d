"""Per-frame filter step and sequence runner (port of ``msckf_mono_tpu/core/filter.py``).

The reference's main loop (datasets/asl_msckf.cpp:206-478) drains IMU
readings then runs augment -> update -> addFeatures -> marginalize ->
pruneRedundantStates -> pruneEmptyStates per camera frame. Here that frame is
:func:`step`, a function of tensors with a leading filter-batch axis and no
host synchronization (no ``.item()``, no branch on data). :func:`run_sequence`
is ``lax.scan`` over the frames and :func:`finish` the end-of-sequence
force-residualization of every remaining track (msckf.h:765-807), a fixed
number of passes; on the card both replay a captured CUDA graph
(``ops/cuda_graph``), one replay a frame, and run eagerly under
``cuda_graph.disabled()``.

Under a profiler, :func:`step` marks its stages (``eval/profile.stage``):
``step.propagate``, ``step.augment``, ``step.tracks``, ``step.update`` (on
the fused path ``update.rows``, ``update.ekf`` and ``update.post``; else
``update.marginalize`` and ``update.prune``) and ``step.prune_empty``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from msckf_mono_tpu_torch.core import augment, prune, tracks, update
from msckf_mono_tpu_torch.core import propagate as propagate_mod
from msckf_mono_tpu_torch.core.types import FilterState, StagedTracks, _Replace, tree_map, tree_where
from msckf_mono_tpu_torch.core.window import gather_rows, stable_order
from msckf_mono_tpu_torch.eval.profile import stage
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils.config import MsckfConfig


@dataclass
class FrameInput(_Replace):
    """One camera frame plus the IMU samples since the previous frame.

    Leading axes: (B, ...) for one frame of a B-filter batch, (T, B, ...) for
    a sequence.
    """

    imu_omega: torch.Tensor   # (K, 3)
    imu_acc: torch.Tensor     # (K, 3)
    imu_dt: torch.Tensor      # (K,)   0 for padded samples
    tracked_uv: torch.Tensor  # (F, 2) undistorted normalized coords
    tracked_ids: torch.Tensor # (F,)   int32
    tracked_valid: torch.Tensor  # (F,)
    new_uv: torch.Tensor      # (F, 2)
    new_ids: torch.Tensor     # (F,)
    new_valid: torch.Tensor   # (F,)
    state_id: torch.Tensor    # () int32
    time: torch.Tensor        # ()
    frame_valid: torch.Tensor # () bool


@dataclass
class FrameOutput(_Replace):
    p_I_G: torch.Tensor
    q_IG: torch.Tensor
    v_I_G: torch.Tensor
    b_g: torch.Tensor
    b_a: torch.Tensor
    cam_count: torch.Tensor
    num_residualized: torch.Tensor


def propagate_block(state: FilterState, frame: FrameInput, config: MsckfConfig) -> FilterState:
    """The frame's IMU samples as ONE composed covariance update (padded
    samples carry dt=0 == identity); see core/propagate.propagate_block."""
    return propagate_mod.propagate_block(
        state, frame.imu_omega, frame.imu_acc, frame.imu_dt, config
    )


def step(state: FilterState, frame: FrameInput, config: MsckfConfig):
    """One full frame for a batch of filters: propagate block + vision update.

    ``config.filter.matmul_precision`` needs no context here: the package
    disables TF32 at import, so every f32 product is full f32.
    """
    # Capture the restore point AFTER clearing the per-frame archive buffers:
    # a padded frame must expose EMPTY map/pruned buffers.
    state = prune.clear_frame_archive(state)
    state0 = state

    with stage("step.propagate"):
        state = propagate_block(state, frame, config)
    with stage("step.augment"):
        state = augment.augment_state(state, frame.state_id, frame.time, config)
    with stage("step.tracks"):
        state, staged = tracks.update_tracks(
            state, frame.tracked_uv, frame.tracked_ids, frame.tracked_valid, config
        )
        state = tracks.add_features(state, frame.new_uv, frame.new_ids, frame.new_valid, config)
    with stage("step.update"):
        if config.filter.fused_updates and config.filter.use_prune_redundant:
            state = _fused_vision_update(state, staged, config)
        else:
            with stage("update.marginalize"):
                state = update.marginalize(state, staged, config)
            if config.filter.use_prune_redundant:
                with stage("update.prune"):
                    state = prune.prune_redundant_states(state, config)
    with stage("step.prune_empty"):
        state = prune.prune_empty_states(state, config)

        # Padded frames leave the state untouched.
        state = tree_where(frame.frame_valid, state, state0)

        out = FrameOutput(
            p_I_G=state.imu.p_I_G,
            q_IG=state.imu.q_IG,
            v_I_G=state.imu.v_I_G,
            b_g=state.imu.b_g,
            b_a=state.imu.b_a,
            cam_count=state.window.count,
            num_residualized=state.num_residualized,
        )
    return state, out


def _fused_vision_update(state: FilterState, staged, config: MsckfConfig) -> FilterState:
    """Marginalize + redundant-prune as ONE stacked EKF update.

    The staged dead tracks (msckf.h:336-449) and the prune candidates'
    one-last-updates (msckf.h:453-682) chain through one shared row buffer
    (``carry``): one gate batch per set, one measurement update per frame.
    See FilterConfig.fused_updates for the (second-order) deviation from the
    reference's sequential order.
    """
    dtype = state.P.dtype
    sigma2 = state.meas_sigma2.to(dtype)
    window = state.window
    g = state.imu.g
    shp = config.shapes

    with stage("update.rows"):
        p_f, track_ok, motion_ok, tri_ok = update.marginalize_prep(state, staged, config)
        prep = prune.prune_prep(state, config)

        gate_m, present_m, carry = update.gated_row_stack(
            staged.obs, staged.obs_mask, p_f, track_ok, window, g, state.P,
            sigma2, config, m_cap=shp.marg_obs_cap or None, return_carry=True,
        )
        out = update.gated_row_stack(
            prep["c_obs"], prep["c_mask_inv"], prep["p_use"], prep["use_track"],
            window, g, state.P, sigma2, config,
            m_cap=shp.prune_obs_cap or None, carry=carry,
            chunk=shp.prune_chunk or None,
        )
        H, r, gate_p, present_p, n_dropped = out[:5]
    with stage("update.ekf"):
        state = update.measurement_update(state, H, r, sigma2, config, *out[5:])

    with stage("update.post"):
        state = update.marginalize_post(
            state, staged, p_f, track_ok, motion_ok, tri_ok,
            gate_m, present_m, n_dropped, config,
        )
        # row_overflow already counted once in marginalize_post.
        return prune.prune_post(state, prep, gate_p, torch.zeros_like(n_dropped), config)


def frame_at(frames: FrameInput, t: int) -> FrameInput:
    """Frame t of a (T, B, ...) sequence."""
    return tree_map(lambda x: x[t], frames)


def run_sequence(state: FilterState, frames: FrameInput, config: MsckfConfig):
    """Run :func:`step` over a (T, B, ...) stack of FrameInputs
    (``lax.scan``, ``msckf_mono_tpu/core/filter.py:170``).

    The device is the state's. One captured step is replayed a frame: the
    graph writes the new state into its own input buffers, each frame is
    copied into the frame buffers before its replay, and each FrameOutput
    into a (T, B, ...) stack after it. Returns (final_state, FrameOutput with
    (T, B, ...) fields).
    """
    frames = tree_map(lambda x: x.to(state.P.device), frames)
    return cuda_graph.scan(step, state, frames, (config,))


def _stage_pass(state: FilterState, config: MsckfConfig):
    """Stage up to ``max_staged`` eligible tracks of each filter and clear
    them from the table. Returns (state, staged, remaining (B,))."""
    shp = config.shapes
    t = state.tracks
    eligible = t.active & (t.lengths >= config.filter.min_track_length)      # (B, M)

    order = stable_order(~eligible)[:, : shp.max_staged]
    staged_valid = torch.gather(eligible, 1, order)
    staged = StagedTracks(
        obs=gather_rows(t.obs, order),
        obs_mask=gather_rows(t.obs_mask, order) & staged_valid[..., None],
        feature_id=torch.gather(t.feature_id, 1, order),
        valid=staged_valid,
    )
    taken = torch.zeros_like(eligible).scatter_(1, order, staged_valid)
    cleared = t.replace(
        active=t.active & ~taken,
        feature_id=torch.where(taken, torch.full_like(t.feature_id, -1), t.feature_id),
        obs_mask=t.obs_mask & ~taken[..., None],
    )
    remaining = torch.sum(eligible, dim=1) - torch.sum(staged_valid, dim=1)
    return state.replace(tracks=cleared), staged, remaining


def finish(state: FilterState, config: MsckfConfig, collect_map: bool = False):
    """:func:`_finish` from a captured graph on the card (the jitted
    finish of ``msckf_mono_tpu/interface.py:315``)."""
    return cuda_graph.jit(_finish, (config, collect_map))(state)


def _finish(state: FilterState, config: MsckfConfig, collect_map: bool = False):
    """End-of-sequence: residualize EVERY remaining eligible track
    (msckf.h:765-807 force-residualizes all of them).

    The staging buffer holds ``max_staged`` tracks, so this runs
    ⌈max_tracks/max_staged⌉ passes whatever the state holds (no host sync);
    a pass with nothing staged is an identity update (all rows masked). The
    steady-state row budget is sized for ~1 track a frame, so the passes run
    with ``max_update_rows`` raised to the worst case,
    ``max_staged·(2·num_slots−3)``.

    With ``collect_map`` returns (state, pts (B, n_passes·S, 3), mask
    (B, n_passes·S)): every point the passes triangulated, for the
    cumulative map (the reference's finish pushes them to ``map_`` too,
    msckf.h:372).
    """
    shp = config.shapes
    n_passes = -(-shp.max_tracks // shp.max_staged)
    worst_rows = shp.max_staged * (2 * shp.num_slots - 3)
    config = dataclasses.replace(config, shapes=dataclasses.replace(shp, max_update_rows=worst_rows))

    pts, masks = [], []
    for _ in range(n_passes):
        state, staged, _ = _stage_pass(state, config)
        state = update.marginalize(state, staged, config)
        if collect_map:
            pts.append(state.map_pts)
            masks.append(state.map_mask)
    if collect_map:
        return state, torch.cat(pts, dim=1), torch.cat(masks, dim=1)
    return state
