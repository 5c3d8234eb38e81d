"""Filter state dataclasses (port of ``msckf_mono_tpu/core/types.py``).

Design, as in the JAX package:

* The camera-state window is ``num_slots`` fixed slots with a validity mask,
  kept chronologically compacted (slot 0 is the oldest valid state). Pruning
  is a permutation + mask update, never a resize.
* The covariance is ONE dense ``(15+6N, 15+6N)`` tensor; invalid slots carry
  zero rows/cols.
* Feature tracks are ``max_tracks`` rows whose observations are indexed BY
  WINDOW SLOT: ``obs[m, j]`` is track m's measurement at camera-state slot j.

Every tensor carries an explicit leading filter-batch dimension B (B = 1 for
one filter); the shapes below omit it. Counters and ids are int32 as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.msckf.utils import quat
from portbench.reference.msckf.utils.config import MsckfConfig


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class ImuState(_Replace):
    """15-DoF IMU state + OC-EKF null-state copies (reference types.h:69-76)."""

    q_IG: torch.Tensor  # (4,) wxyz, rotates global -> IMU
    b_g: torch.Tensor   # (3,)
    v_I_G: torch.Tensor # (3,)
    b_a: torch.Tensor   # (3,)
    p_I_G: torch.Tensor # (3,)
    g: torch.Tensor     # (3,) gravity in global frame (0,0,-9.81)
    q_IG_null: torch.Tensor
    v_I_G_null: torch.Tensor
    p_I_G_null: torch.Tensor


@dataclass
class CamWindow(_Replace):
    """Sliding window of camera poses (reference types.h:57-67), slot-masked."""

    q_CG: torch.Tensor      # (N, 4) rotates global -> camera
    p_C_G: torch.Tensor     # (N, 3) camera position in global
    time: torch.Tensor      # (N,)
    state_id: torch.Tensor  # (N,) int32, monotone per augmentation
    valid: torch.Tensor     # (N,) bool

    @property
    def count(self):
        return torch.sum(self.valid, dim=-1, dtype=torch.int32)


@dataclass
class TrackTable(_Replace):
    """Live feature tracks, observations indexed by window slot."""

    obs: torch.Tensor         # (M, N, 2) undistorted normalized image coords
    obs_mask: torch.Tensor    # (M, N) bool
    feature_id: torch.Tensor  # (M,) int32, -1 for empty rows
    active: torch.Tensor      # (M,) bool
    initialized: torch.Tensor # (M,) bool (triangulation cached)
    p_f_G: torch.Tensor       # (M, 3) cached triangulated point

    @property
    def lengths(self):
        return torch.sum(self.obs_mask, dim=-1, dtype=torch.int32)


@dataclass
class StagedTracks(_Replace):
    """Dead tracks staged for residualization this frame (compacted rows)."""

    obs: torch.Tensor         # (S, N, 2)
    obs_mask: torch.Tensor    # (S, N)
    feature_id: torch.Tensor  # (S,) int32
    valid: torch.Tensor       # (S,) bool


@dataclass
class Diagnostics(_Replace):
    """Monotone counters for silent-cap detection and telemetry, each (B,) int32."""

    staged_overflow: torch.Tensor
    row_overflow: torch.Tensor
    track_overflow: torch.Tensor
    window_overflow: torch.Tensor
    gating_rejects: torch.Tensor
    triangulation_rejects: torch.Tensor
    motion_rejects: torch.Tensor
    updates_applied: torch.Tensor


@dataclass
class FilterState(_Replace):
    imu: ImuState
    window: CamWindow
    tracks: TrackTable
    P: torch.Tensor             # (15+6N, 15+6N) error-state covariance
    q_imu_diag: torch.Tensor    # (12,) continuous-time IMU noise diag (Q_imu)
    meas_sigma2: torch.Tensor   # () isotropic measurement noise u_var'
    num_residualized: torch.Tensor  # () int32; guards checkMotion (msckf.h:354)
    map_pts: torch.Tensor       # (S, 3) last frame's triangulated points
    map_mask: torch.Tensor      # (S,) bool
    tri_map_pts: torch.Tensor   # (T_tri, 3) prune-stage points of this frame
    tri_map_mask: torch.Tensor  # (T_tri,)
    pruned_q: torch.Tensor      # (N, 4) camera states removed this frame
    pruned_p: torch.Tensor      # (N, 3)
    pruned_time: torch.Tensor   # (N,)
    pruned_ids: torch.Tensor    # (N,) int32
    pruned_mask: torch.Tensor   # (N,) bool
    diag: Diagnostics

    @property
    def batch_size(self) -> int:
        return self.P.shape[0]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over same-structured dataclasses of tensors."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(t, f.name) for t in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def tree_where(cond: torch.Tensor, a, b):
    """Per filter: ``a`` where ``cond`` (B,) else ``b``, over every leaf."""
    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)
    return tree_map(sel, a, b)


def _leaves(tree, prefix=""):
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, key + ".")
        else:
            yield key, v


def filter_state_to_numpy(state: FilterState) -> dict:
    """The state as a dict of numpy arrays keyed by field path ("imu.q_IG", "P", ...).

    Arrays keep the leading batch axis and are copies (a graphed run
    updates its state tensors in place). The JAX package's state flattens to
    the same keys, so both sides can start from one state.
    """
    return {k: v.detach().cpu().numpy().copy() for k, v in _leaves(state)}


def filter_state_from_numpy(arrays: dict, device="cuda") -> FilterState:
    """Inverse of :func:`filter_state_to_numpy`; every array needs a leading batch axis."""
    def build(cls, prefix):
        kw = {}
        for f in dataclasses.fields(cls):
            sub = _NESTED.get((cls, f.name))
            if sub is not None:
                kw[f.name] = build(sub, prefix + f.name + ".")
            else:
                kw[f.name] = torch.as_tensor(np.asarray(arrays[prefix + f.name]), device=device)
        return cls(**kw)
    return build(FilterState, "")


_NESTED = {
    (FilterState, "imu"): ImuState,
    (FilterState, "window"): CamWindow,
    (FilterState, "tracks"): TrackTable,
    (FilterState, "diag"): Diagnostics,
}


def _batched(x, dtype, device):
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    t = t.to(device=device, dtype=dtype)
    return t[None] if t.dim() == 1 else t


def init_imu_state(
    q_IG=None, b_g=None, v_I_G=None, b_a=None, p_I_G=None, g=None,
    dtype=torch.float32, device="cuda",
) -> ImuState:
    """IMU state with a leading batch axis: (B, ·) inputs keep B, (·,) inputs give B = 1."""
    q_IG = quat.identity(dtype, device)[None] if q_IG is None else _batched(q_IG, dtype, device)
    z3 = torch.zeros((1, 3), dtype=dtype, device=device)
    b_g = z3 if b_g is None else _batched(b_g, dtype, device)
    v_I_G = z3 if v_I_G is None else _batched(v_I_G, dtype, device)
    b_a = z3 if b_a is None else _batched(b_a, dtype, device)
    p_I_G = z3 if p_I_G is None else _batched(p_I_G, dtype, device)
    g = _batched([0.0, 0.0, -9.81] if g is None else g, dtype, device)
    q_IG, b_g, v_I_G, b_a, p_I_G, g = _broadcast_batch(q_IG, b_g, v_I_G, b_a, p_I_G, g)
    return ImuState(
        q_IG=q_IG, b_g=b_g, v_I_G=v_I_G, b_a=b_a, p_I_G=p_I_G, g=g,
        q_IG_null=q_IG, v_I_G_null=v_I_G, p_I_G_null=p_I_G,
    )


def _broadcast_batch(*xs):
    B = max(x.shape[0] for x in xs)
    return tuple(x.expand((B,) + tuple(x.shape[1:])).contiguous() for x in xs)


def init_filter_state(config: MsckfConfig, imu: ImuState | None = None,
                      dtype=torch.float32, device="cuda") -> FilterState:
    """Fresh filter state; covariance seeded like ``MSCKF::initialize``
    (reference msckf.h:72-97). B is the batch size of ``imu`` (1 by default)."""
    N = config.shapes.num_slots
    M = config.shapes.max_tracks
    S = config.shapes.max_staged
    D = config.shapes.state_dim
    T_tri = config.shapes.max_tri_prune

    if imu is None:
        imu = init_imu_state(dtype=dtype, device=device)
    imu = tree_map(lambda x: x.to(device=device, dtype=dtype), imu)
    B = imu.q_IG.shape[0]
    kw = dict(device=device)

    def zeros(*shape, dt=dtype):
        return torch.zeros((B,) + shape, dtype=dt, **kw)

    def full(value, *shape, dt=torch.int32):
        return torch.full((B,) + shape, value, dtype=dt, **kw)

    window = CamWindow(
        q_CG=quat.identity(dtype, device).repeat(B, N, 1),
        p_C_G=zeros(N, 3),
        time=zeros(N),
        state_id=full(-1, N),
        valid=zeros(N, dt=torch.bool),
    )
    tracks = TrackTable(
        obs=zeros(M, N, 2),
        obs_mask=zeros(M, N, dt=torch.bool),
        feature_id=full(-1, M),
        active=zeros(M, dt=torch.bool),
        initialized=zeros(M, dt=torch.bool),
        p_f_G=zeros(M, 3),
    )
    P = zeros(D, D)
    idx = torch.arange(15, **kw)
    P[:, idx, idx] = torch.as_tensor(config.initial_imu_covar_diag(), dtype=dtype, **kw)
    diag = Diagnostics(**{f.name: full(0) for f in dataclasses.fields(Diagnostics)})
    return FilterState(
        imu=imu, window=window, tracks=tracks, P=P,
        q_imu_diag=torch.as_tensor(config.q_imu_diag(), dtype=dtype, **kw).repeat(B, 1),
        meas_sigma2=torch.full((B,), config.u_var_prime, dtype=dtype, **kw),
        num_residualized=full(0),
        map_pts=zeros(S, 3), map_mask=zeros(S, dt=torch.bool),
        tri_map_pts=zeros(T_tri, 3), tri_map_mask=zeros(T_tri, dt=torch.bool),
        pruned_q=zeros(N, 4), pruned_p=zeros(N, 3), pruned_time=zeros(N),
        pruned_ids=full(-1, N), pruned_mask=zeros(N, dt=torch.bool),
        diag=diag,
    )
