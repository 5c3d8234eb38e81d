"""The plain reference of the multi-robot traffic: each sampled robot on its own frames.

Row (job, b) is robot b of job j: the reference's own draw of filter b under
the job's key at ``batch`` filters (``runner.fleet_rows``), centred on robot
b's true start, which the harness hands over with the world (``starts``:
(B, ...) lists); then robot b's loop frames ``phases[b] + t`` with their IMU
blocks, times and state ids, all rows at once through the frozen
reference's ``core/pipeline.batched_run_images`` (images with Bi = the
rows), a frame a call so that each frame's decisions are read. It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.msckf.core import pipeline as ref_pipeline
from portbench.reference.msckf.frontend import klt as ref_klt
from portbench.reference.msckf.frontend.functional import FrontendConfig, init_frontend_state
from portbench.reference.msckf.utils import config as ref_config
from portbench.reference.runner import _trail, decisions, fleet_rows, precision


def _rows_index(phases, robots, n):
    """(n, S) int64: the loop frame of each row's robot at frames 0..n-1."""
    return np.arange(n)[:, None] + np.asarray(phases)[np.asarray(robots)][None, :]


def fleet_images_indep(config, cfg_batch, seq, loop, phases, starts, keys, rows, n_frames,
                       dtype, device, tf32=False):
    """The sampled rows ``rows`` ((job, robot) pairs) over ``n_frames``, each
    robot on the frames of the rendered ``loop`` (n_loop, H, W) from its
    phase on."""
    from portbench.harness.cell import build_config, dtype_of

    cfg = build_config(config, cfg_batch, ref_config)
    fcfg = FrontendConfig(**config["frontend"])
    run = ref_pipeline.batched_run_images(cfg, fcfg)
    H, W = loop.shape[1:]
    S = len(rows)
    index = _rows_index(phases, [b for _, b in rows], n_frames)
    with precision(tf32), torch.no_grad():
        state = fleet_rows(cfg, starts, keys, rows, cfg_batch, dtype_of(config), dtype, device)
        fstate = init_frontend_state(H, W, fcfg, S, S, dtype, device=device)

        def f(x, dt=dtype):
            return torch.as_tensor(np.asarray(x)[index], device=device).to(dt)

        common = dict(imu_omega=f(seq["imu_omega"]), imu_acc=f(seq["imu_acc"]),
                      imu_dt=f(seq["imu_dt"]),
                      state_id=f(np.arange(1, loop.shape[0] + 1), torch.int32),
                      time=f(seq["time"]), frame_valid=f(np.ones(loop.shape[0], bool), torch.bool))
        pos, dec = [], []
        for t in range(n_frames):
            frame = ref_pipeline.ImageFrameInput(
                image=loop[torch.as_tensor(index[t])][None].to(device=device, dtype=dtype),
                **{k: v[t:t + 1] for k, v in common.items()})
            state, fstate, o = run(state, fstate, frame)
            pos.append(o.p_I_G[0].double().cpu())
            dec.append(decisions(state))
        return _trail(pos, dec)


def pyramids_indep(config, cfg_batch, seq, loop, phases, robots, frames, dtype, device,
                   tf32=False):
    """The pyramid levels 1 and up that the front-end builds from robot b's
    frame t, for the robots ``robots`` at each frame t of ``frames``: per
    frame, a list of (len(robots), h, w) float64 arrays."""
    fcfg = FrontendConfig(**config["frontend"])
    out = []
    with precision(tf32), torch.no_grad():
        for t in frames:
            index = torch.as_tensor(_rows_index(phases, robots, t + 1)[t])
            pyr = ref_klt.build_pyramid(loop[index].to(device=device, dtype=dtype),
                                        fcfg.max_level, precision=fcfg.image_precision)
            out.append([lv.double().cpu().numpy() for lv in pyr[1:]])
    return out
