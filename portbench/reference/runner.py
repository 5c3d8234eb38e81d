"""The plain reference, run on the same inputs as the program.

It runs the frozen plain copy in ``portbench/reference/msckf`` (the filter
step, the image front-end, the live tracker; the three kernels as plain
PyTorch; no CUDA graphs) frame by frame, eagerly. It imports nothing of the
program: the harness hands it the configuration file, the world's arrays and
images, and the fleet's keys, and it works out every state itself, from the
initial draw on. ``dtype`` and ``tf32`` set its precision: float64 as the
reference; float32 with TF32 on is the control, the step below the program's
stated float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.msckf.core import filter as ref_filter
from portbench.reference.msckf.core import pipeline as ref_pipeline
from portbench.reference.msckf.core.init import ground_truth_init
from portbench.reference.msckf.core.types import init_filter_state
from portbench.reference.msckf.frontend import klt as ref_klt
from portbench.reference.msckf.frontend.functional import FrontendConfig, init_frontend_state
from portbench.reference.msckf.parallel import montecarlo
from portbench.reference.msckf.utils import config as ref_config


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for the body's products on the card, then restored."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def fleet_rows(cfg, imu0, keys, rows, batch, draw_dtype, dtype, device):
    """The filters ``rows`` ((job, filter) pairs) of the fleets that
    ``montecarlo.make_fleet`` draws at ``batch`` filters from ``keys[job]``.
    The draw is made in ``draw_dtype``, the configuration's (threefry's
    normals differ by dtype), then held in ``dtype``."""
    imu = ground_truth_init(**imu0, dtype=draw_dtype, device=device)
    parts = {}
    for job in sorted({j for j, _ in rows}):
        parts[job] = montecarlo.perturb_imu_state(imu, torch.as_tensor(keys[job]), batch)
    picked = [type(imu)(**{k: getattr(parts[j], k)[f:f + 1] for k in vars(imu)}) for j, f in rows]
    stacked = type(imu)(**{k: torch.cat([getattr(p, k) for p in picked]).to(dtype)
                           for k in vars(imu)})
    return init_filter_state(cfg, stacked, dtype=dtype, device=device)


DECISIONS = ("num_residualized", "gating_rejects", "motion_rejects", "triangulation_rejects")


def decisions(state):
    """(S, 4) int64: :data:`DECISIONS` of a filter state."""
    d = state.diag
    return torch.stack([state.num_residualized, d.gating_rejects, d.motion_rejects,
                        d.triangulation_rejects], dim=-1).long().cpu()


def _trail(pos, dec):
    return {"p": torch.stack(pos).double().numpy(), "decisions": torch.stack(dec).numpy()}


def _frame_inputs(seq, S, dtype, device, image=False):
    """The sequence's IMU (and, without images, track) fields as (T, S, ...)."""
    T = seq["time"].shape[0]

    def b(x, dt=dtype):
        x = torch.as_tensor(np.asarray(x)[:T], device=device).to(dt)
        return x[:, None].expand((T, S) + tuple(x.shape[1:]))

    common = dict(imu_omega=b(seq["imu_omega"]), imu_acc=b(seq["imu_acc"]),
                  imu_dt=b(seq["imu_dt"]), state_id=b(np.arange(1, T + 1), torch.int32),
                  time=b(seq["time"]), frame_valid=b(np.ones(T, bool), torch.bool))
    if image:
        return common
    return ref_filter.FrameInput(
        tracked_uv=b(seq["tracked_uv"]), tracked_ids=b(seq["tracked_ids"], torch.int32),
        tracked_valid=b(seq["tracked_valid"], torch.bool), new_uv=b(seq["new_uv"]),
        new_ids=b(seq["new_ids"], torch.int32), new_valid=b(seq["new_valid"], torch.bool),
        **common)


def fleet_tracks(config, cfg_batch, seq, imu0, keys, rows, batch, n_frames, dtype, device,
                 tf32=False):
    """The sampled filters ``rows`` over ``n_frames`` of the precomputed tracks."""
    from portbench.harness.cell import build_config, dtype_of

    cfg = build_config(config, cfg_batch, ref_config)
    with precision(tf32), torch.no_grad():
        state = fleet_rows(cfg, imu0, keys, rows, batch, dtype_of(config), dtype, device)
        frames = _frame_inputs({k: v[:n_frames] for k, v in seq.items()}, len(rows), dtype, device)
        pos, dec = [], []
        for t in range(n_frames):
            state, o = ref_filter.step(state, ref_filter.frame_at(frames, t), cfg)
            pos.append(o.p_I_G.double().cpu())
            dec.append(decisions(state))
        return _trail(pos, dec)


def fleet_images(config, cfg_batch, seq, imu0, keys, rows, batch, images, dtype, device,
                 tf32=False):
    """The sampled filters ``rows`` sharing the camera ``images`` (T, H, W)."""
    from portbench.harness.cell import build_config, dtype_of

    cfg = build_config(config, cfg_batch, ref_config)
    fcfg = FrontendConfig(**config["frontend"])
    T, H, W = images.shape
    S = len(rows)
    with precision(tf32), torch.no_grad():
        state = fleet_rows(cfg, imu0, keys, rows, batch, dtype_of(config), dtype, device)
        fstate = init_frontend_state(H, W, fcfg, S, 1, dtype, device=device)
        common = _frame_inputs({k: v[:T] for k, v in seq.items()}, S, dtype, device, image=True)
        pos, dec = [], []
        for t in range(T):
            frame = ref_pipeline.ImageFrameInput(
                image=images[t:t + 1].to(device=device, dtype=dtype),
                **{k: v[t] for k, v in common.items()})
            (state, fstate), o = ref_pipeline.step((state, fstate), frame, cfg, fcfg)
            pos.append(o.p_I_G.double().cpu())
            dec.append(decisions(state))
        return _trail(pos, dec)


def pyramids(config, images, frames, dtype, device, tf32=False):
    """The pyramid levels 1 and up that the front-end builds from each frame
    ``frames`` of the camera ``images`` (T, H, W): per frame, a list of
    (h, w) float64 arrays."""
    fcfg = FrontendConfig(**config["frontend"])
    out = []
    with precision(tf32), torch.no_grad():
        for t in frames:
            pyr = ref_klt.build_pyramid(images[t:t + 1].to(device=device, dtype=dtype),
                                        fcfg.max_level, precision=fcfg.image_precision)
            out.append([lv[0].double().cpu().numpy() for lv in pyr[1:]])
    return out


def live(config, seq, imu0, images, dtype, device, tf32=False):
    """One filter behind the live interface's frame logic over the N frames
    ``images`` (N, H, W host array): S = 1."""
    from portbench.harness.cell import build_config, dtype_of
    from portbench.reference.live import LiveReference

    cfg = build_config(config, 1, ref_config)
    pos, dec = [], []
    with precision(tf32), torch.no_grad():
        ref = LiveReference(cfg, config["track_handler"], imu0, dtype, device)
        for i in range(images.shape[0]):
            ref.frame(images[i], seq["imu_omega"][i], seq["imu_acc"][i], seq["imu_dt"][i],
                      float(seq["time"][i]))
            pos.append(ref.state.imu.p_I_G.double().cpu())
            dec.append(decisions(ref.state))
    return _trail(pos, dec)
