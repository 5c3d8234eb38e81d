"""One filter behind the live interface, plain: the frame logic of the
program's ``interface.VioInterface.image_callback`` and ``LiveFrame.frame``
(frozen), for a frame that brings exactly one IMU block of K readings, with
ground-truth initialisation. Eager, no staging buffers, no graphs."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.msckf.core import filter as msckf_filter
from portbench.reference.msckf.core.filter import FrameInput
from portbench.reference.msckf.core.init import ground_truth_init
from portbench.reference.msckf.core.types import init_filter_state
from portbench.reference.msckf.core.window import stable_order
from portbench.reference.msckf.frontend.functional import _take
from portbench.reference.msckf.frontend.track_handler import TrackHandler
from portbench.reference.msckf.utils import quat


def _budget(uv, ids, valid, F, dtype):
    """The first F valid entries of (1, N) lists, in order."""
    order = stable_order(~valid)[:, :F]
    return (_take(uv, order).to(dtype), torch.gather(ids, 1, order).to(torch.int32),
            torch.gather(valid, 1, order))


class LiveReference:
    def __init__(self, config, th_kwargs, imu0, dtype, device):
        cam = config.camera
        K = np.array([[cam.f_u, 0, cam.c_u], [0, cam.f_v, cam.c_v], [0, 0, 1.0]])
        self.config, self.dtype, self.device = config, dtype, torch.device(device)
        self.th = TrackHandler(K, cam.distortion_coeffs, cam.distortion_model, dtype=dtype,
                               device=self.device, **th_kwargs)
        imu = ground_truth_init(**imu0, dtype=dtype, device=self.device)
        self.state = init_filter_state(config, imu, dtype=dtype, device=self.device)
        self.q_CI = torch.as_tensor(cam.q_CI, dtype=dtype, device=self.device)
        self.frame_count = 0
        self.time_origin = None

    def frame(self, image, omega, acc, dt, time: float):
        """One frame: its K readings (omega, acc (K, 3), dt (K,)), then the
        image (H, W). Returns the IMU position after it."""
        if self.time_origin is None:
            self.time_origin = time
        self.frame_count += 1
        cfg, dtype, th = self.config, self.dtype, self.th
        K, F = cfg.shapes.imu_per_frame, cfg.shapes.max_features_per_frame
        frame_dt = float(time) - th.cur_time
        th.prev_time, th.cur_time = th.cur_time, float(time)
        vec = np.zeros((8 * K + 3,))
        blk_np = vec[: 7 * K].reshape(K, 7)
        n = len(dt)
        blk_np[:n, 0:3], blk_np[:n, 3:6], blk_np[:n, 6] = omega, acc, dt
        vec[7 * K: 7 * K + n] = 1.0
        vec[8 * K:] = self.frame_count, time - self.time_origin, frame_dt
        vec = torch.as_tensor(vec, device=self.device)
        img = torch.as_tensor(np.asarray(image), device=self.device)

        state = self.state
        blk = vec[: 7 * K].reshape(K, 7)
        th.add_gyro_reading(quat.rotate(self.q_CI, (blk[:, 0:3] - state.imu.b_g).to(dtype)),
                            vec[7 * K: 8 * K] > 0)
        th._ingest(img)
        tb = _budget(*th.tracked_features(vec[8 * K + 2]), F, dtype)
        nb = _budget(*th.new_features(), F, dtype)
        b = blk.to(dtype)[None]
        frame = FrameInput(
            imu_omega=b[..., 0:3], imu_acc=b[..., 3:6], imu_dt=b[..., 6],
            tracked_uv=tb[0], tracked_ids=tb[1], tracked_valid=tb[2],
            new_uv=nb[0], new_ids=nb[1], new_valid=nb[2],
            state_id=vec[8 * K: 8 * K + 1].to(torch.int32),
            time=vec[8 * K + 1: 8 * K + 2].to(dtype),
            frame_valid=torch.ones((1,), dtype=torch.bool, device=self.device),
        )
        self.state, _ = msckf_filter.step(state, frame, cfg)
        return self.state.imu.p_I_G[0].double().cpu().numpy()
