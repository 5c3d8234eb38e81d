"""Camera-state augmentation (port of ``msckf_mono_tpu/core/augment.py``).

``MSCKF::augmentState`` (msckf.h:148-212): compute the camera pose from the
IMU pose + extrinsics, append it to the window at slot ``count``, and augment
the covariance with the 6-row Jacobian J (msckf.h:180-184) by writing
[J·P ; (J·P)ᵀ ; J·P₁₅Jᵀ] at block index ``count`` — no resize.

If the window is physically full (all ``num_slots`` used), the oldest slot is
dropped without an update (a roll left by one slot) and
``diag.window_overflow`` counts it.
"""

from __future__ import annotations

import functools

import torch

from portbench.reference.msckf.core.types import FilterState, tree_where
from portbench.reference.msckf.utils import quat
from portbench.reference.msckf.utils.config import MsckfConfig


@functools.lru_cache(maxsize=None)
def _extrinsics(camera, dtype, device):
    """(q_CI, p_C_I) on the device, copied there once per (camera, dtype, device)."""
    return (torch.as_tensor(camera.q_CI, dtype=dtype, device=device),
            torch.as_tensor(camera.p_C_I, dtype=dtype, device=device))


def _rolled_state(state: FilterState, N: int) -> FilterState:
    """The state with the oldest slot dropped (only selected when the window is full)."""
    dev = state.P.device
    keep_slot = torch.arange(N, device=dev) < N - 1
    w = state.window
    window_r = w.replace(
        q_CG=torch.roll(w.q_CG, -1, dims=1),
        p_C_G=torch.roll(w.p_C_G, -1, dims=1),
        time=torch.roll(w.time, -1, dims=1),
        state_id=torch.where(keep_slot, torch.roll(w.state_id, -1, dims=1),
                             torch.full_like(w.state_id, -1)),
        valid=w.valid & keep_slot,
    )
    t = state.tracks
    mask_r = torch.roll(t.obs_mask, -1, dims=2) & keep_slot
    tracks_r = t.replace(obs=torch.roll(t.obs, -1, dims=2) * mask_r[..., None], obs_mask=mask_r)
    P = state.P
    c = 15 + 6 * (N - 1)
    P_r = torch.zeros_like(P)
    P_r[:, :15, :15] = P[:, :15, :15]
    P_r[:, :15, 15:c] = P[:, :15, 21:]
    P_r[:, 15:c, :15] = P[:, 21:, :15]
    P_r[:, 15:c, 15:c] = P[:, 21:, 21:]
    return state.replace(
        window=window_r, tracks=tracks_r, P=P_r,
        diag=state.diag.replace(window_overflow=state.diag.window_overflow + 1),
    )


def augment_state(state: FilterState, state_id, time, config: MsckfConfig) -> FilterState:
    """state_id: (B,) int32, time: (B,)."""
    dtype = state.P.dtype
    dev = state.P.device
    N = config.shapes.num_slots
    B = state.batch_size
    bidx = torch.arange(B, device=dev)

    full = state.window.count >= N
    state = tree_where(full, _rolled_state(state, N), state)

    imu = state.imu
    q_CI, p_C_I = _extrinsics(config.camera, dtype, dev)

    q_CG = quat.normalize(quat.mul(q_CI, imu.q_IG))
    p_CI_G = quat.rotate(quat.inverse(imu.q_IG), p_C_I)
    p_C_G = imu.p_I_G + p_CI_G

    k = state.window.count.long()  # slot for the new state
    window = state.window
    q_new, p_new = window.q_CG.clone(), window.p_C_G.clone()
    t_new, id_new, v_new = window.time.clone(), window.state_id.clone(), window.valid.clone()
    q_new[bidx, k] = q_CG
    p_new[bidx, k] = p_C_G
    t_new[bidx, k] = torch.as_tensor(time, dtype=dtype, device=dev).expand(B)
    id_new[bidx, k] = torch.as_tensor(state_id, dtype=torch.int32, device=dev).expand(B)
    # a device value: a Python scalar here is a host->device copy that syncs
    v_new[bidx, k] = torch.ones_like(v_new[:, 0])
    window = window.replace(q_CG=q_new, p_C_G=p_new, time=t_new, state_id=id_new, valid=v_new)

    # J: 6 rows, nonzero only in the 15 IMU columns (msckf.h:180-184).
    J15 = torch.zeros((B, 6, 15), dtype=dtype, device=dev)
    J15[:, 0:3, 0:3] = quat.to_rotmat(q_CI)
    J15[:, 3:6, 0:3] = quat.skew(p_CI_G)
    J15[:, 3:6, 12:15] = torch.eye(3, dtype=dtype, device=dev)

    P = state.P.clone()
    Bm = J15 @ P[:, 0:15, :]                          # (B, 6, D) = J · P
    corner = Bm[:, :, 0:15] @ J15.transpose(-1, -2)   # (B, 6, 6)

    rows = 15 + 6 * k[:, None] + torch.arange(6, device=dev)   # (B, 6)
    b1 = bidx[:, None]
    P[b1, rows] = Bm
    P.transpose(1, 2)[b1, rows] = Bm
    P[b1[:, :, None], rows[:, :, None], rows[:, None, :]] = corner
    P = 0.5 * (P + P.transpose(1, 2))  # msckf.h:197

    return state.replace(window=window, P=P)
