"""Image-in-the-loop pipeline: pixels -> features -> filter (port of ``msckf_mono_tpu/core/pipeline.py``).

The reference's per-frame host loop (ros_interface.cpp:48-120: drain IMU ->
propagate -> KLT -> detect -> augment -> update -> marginalize -> prune) as
one function :func:`step` over a (FilterState, FrontendState) carry, and
:func:`run_images`, ``lax.scan`` over the frames as
``core/filter.run_sequence`` is (eagerly, in this frozen copy). The gyro-warp prediction uses each filter's
current gyro-bias estimate (ros_interface.cpp:95-99).

Every tensor carries the filter-batch axis B; images are (Bi, H, W) a frame
with Bi = 1 for B filters sharing one camera (the image-only work runs once a
frame) or Bi = B for independent streams.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from portbench.reference.msckf.core import filter as msckf_filter
from portbench.reference.msckf.core.filter import FrameInput
from portbench.reference.msckf.core.types import _Replace, tree_map
from portbench.reference.msckf.frontend import functional
from portbench.reference.msckf.frontend.functional import FrontendConfig, FrontendState
from portbench.reference.msckf.utils import quat
from portbench.reference.msckf.utils.config import MsckfConfig


@dataclass
class ImageFrameInput(_Replace):
    """One camera image + the IMU block since the previous frame.

    Leading axes: image (Bi, H, W) and the rest (B, ...) for one frame;
    (T, Bi, H, W) and (T, B, ...) for a sequence.
    """

    image: torch.Tensor      # (H, W) per image stream
    imu_omega: torch.Tensor  # (K, 3)
    imu_acc: torch.Tensor    # (K, 3)
    imu_dt: torch.Tensor     # (K,)
    state_id: torch.Tensor   # () int32
    time: torch.Tensor       # ()
    frame_valid: torch.Tensor  # () bool


def _gyro_dR(frame: ImageFrameInput, b_g, q_CI, dtype):
    """(B, 3, 3) camera-frame rotation over the frame interval from each
    filter's gyro mean less its own bias estimate b_g (B, 3)."""
    w = (frame.imu_dt > 0).to(dtype)                                     # (B, K)
    n = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
    omega_imu = torch.sum((frame.imu_omega - b_g[:, None, :]) * w[..., None], dim=-2) / n[:, None]
    omega_cam = quat.rotate(q_CI, omega_imu)
    dt_total = torch.sum(frame.imu_dt, dim=-1)
    rvec = -omega_cam * dt_total[:, None]
    angle = torch.linalg.vector_norm(rvec, dim=-1)
    small = angle < 1e-12
    axis = rvec / torch.where(small, torch.ones_like(angle), angle)[:, None]
    q = torch.cat([torch.cos(angle / 2)[:, None], torch.sin(angle / 2)[:, None] * axis], dim=-1)
    identity = torch.cat([torch.ones_like(angle)[:, None], torch.zeros_like(axis)], dim=-1)
    q = torch.where(small[:, None], identity, q)
    return quat.to_rotmat(q.to(dtype))


@functools.lru_cache(maxsize=None)
def _q_CI(config: MsckfConfig, dtype, device):
    """The IMU-to-camera rotation as a tensor, made once per config and device."""
    return torch.as_tensor(config.camera.q_CI, dtype=dtype, device=device)


def _budget(uv, ids, valid, F):
    """The first F valid entries of each filter's (B, N) lists, in order."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :F]
    return functional._take(uv, order), torch.gather(ids, 1, order), torch.gather(valid, 1, order)


def step(carry: tuple, frame: ImageFrameInput, config: MsckfConfig, fcfg: FrontendConfig):
    """(filter_state, frontend_state) x image-frame -> new carry + FrameOutput."""
    state, fstate = carry
    dtype = state.P.dtype
    q_CI = _q_CI(config, dtype, state.P.device)

    dR = _gyro_dR(frame, state.imu.b_g, q_CI, dtype)
    fstate, feats = functional.frontend_step(fstate, frame.image.to(dtype), dR, config, fcfg)

    F = config.shapes.max_features_per_frame
    t_uv, t_ids, t_valid = _budget(feats.tracked_uv, feats.tracked_ids, feats.tracked_valid, F)
    n_uv, n_ids, n_valid = _budget(feats.new_uv, feats.new_ids, feats.new_valid, F)

    fin = FrameInput(
        imu_omega=frame.imu_omega.to(dtype),
        imu_acc=frame.imu_acc.to(dtype),
        imu_dt=frame.imu_dt.to(dtype),
        tracked_uv=t_uv.to(dtype),
        tracked_ids=t_ids,
        tracked_valid=t_valid,
        new_uv=n_uv.to(dtype),
        new_ids=n_ids,
        new_valid=n_valid,
        state_id=frame.state_id,
        time=frame.time.to(dtype),
        frame_valid=frame.frame_valid,
    )
    state, out = msckf_filter.step(state, fin, config)
    return (state, fstate), out


def run_images(state, fstate: FrontendState, frames: ImageFrameInput, config: MsckfConfig,
               fcfg: FrontendConfig):
    """Run :func:`step` over a (T, ...) stack of image frames, on the state's
    device (``msckf_mono_tpu/core/pipeline.py:113``). Each frame's (Bi, H, W)
    image is used as it is, never broadcast.
    Returns (state, fstate, FrameOutput with (T, B, ...) fields)."""
    frames = tree_map(lambda x: x.to(state.P.device), frames)
    outs = []
    for t in range(frames.time.shape[0]):
        (state, fstate), out = step((state, fstate), tree_map(lambda x: x[t], frames), config, fcfg)
        outs.append(out)
    return state, fstate, tree_map(lambda *xs: torch.stack(xs), *outs)


def batched_run_images(config: MsckfConfig, fcfg: FrontendConfig):
    """B independent image streams: states (B, ...), fstates with Bi = B,
    frames.image (T, B, H, W), the other frame fields (T, B, ...)."""

    def run(states, fstates, frames):
        return run_images(states, fstates, frames, config, fcfg)

    return run


def batched_run_images_shared(config: MsckfConfig, fcfg: FrontendConfig):
    """B filters sharing ONE camera stream: frames.image is (T, H, W) and is
    fed as (T, 1, H, W), so the pyramid, FAST and Shi-Tomasi run once a frame
    (fstates with Bi = 1); the other frame fields are (T, B, ...). The
    filters' front-end states still diverge: each filter's gyro-bias estimate
    warps its predictions differently."""

    def run(states, fstates, frames):
        return run_images(states, fstates, frames.replace(image=frames.image[:, None]),
                          config, fcfg)

    return run
