"""One filter behind the live interface with two-point RANSAC on, plain:
``reference/live.py``'s frame with RANSAC's hypothesis pairs drawn at the
program's integer width.

The frozen tracker (``reference/msckf/frontend/track_handler.py``) calls
``two_point_ransac``, which draws the pairs with JAX's default int for the
rotation's dtype (``reference/msckf/frontend/ransac.py:78``): 64 bits in a
float64 reference, 32 in the float32 program. The two would then score
different hypotheses from the same carried key, and the check would compare
two random experiments, not two precisions of one. Here the tracker draws
at the width of the program's configured dtype, from the same carried key,
and scores the pairs in the reference's own dtype. It also counts what
RANSAC decided, as the program's tracker does. Everything else is the
frozen copy's, which this file imports and does not change; each departure
is marked where it is made.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import runner
from portbench.reference.live import LiveReference
from portbench.reference.msckf.frontend import klt, ransac
from portbench.reference.msckf.frontend.track_handler import TrackHandler, _predict_homography
from portbench.reference.msckf.utils import config as ref_config
from portbench.reference.msckf.utils import prng

# two_point_ransac's default, which the tracker does not set
NUM_ITERS = 300


class RansacTrackHandler(TrackHandler):
    """The frozen tracker with RANSAC's pairs drawn at ``int_bits``, and
    two counters: frames the hypotheses decided (5 valid tracks or more)
    and tracks KLT kept that RANSAC dropped (0-d int64, on the device)."""

    def __init__(self, *args, int_bits: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.int_bits = int_bits
        self.ransac_frames = torch.zeros((), dtype=torch.int64, device=self.device)
        self.ransac_rejected = torch.zeros((), dtype=torch.int64, device=self.device)

    def tracked_features(self, dt=None):
        """The frozen ``TrackHandler.tracked_features``, line for line, but
        for the RANSAC block."""
        self._integrate_gyro(dt)
        if self.prev_img is None:
            self._cur_pyr = self._pyramid(self.cur_img, self._cur_pyr)
            return self._empty()

        pred = _predict_homography(self.prev_pts, self.dR, self.K, self.K_inv)
        self._prev_pyr = self._pyramid(self.prev_img, self._prev_pyr)
        self._cur_pyr = self._pyramid(self.cur_img, self._cur_pyr)
        pts, status = klt.track_features_pyr(
            self._prev_pyr, self._cur_pyr, self.prev_pts, pred, self.prev_valid,
            window_size=self.window_size,
        )
        status = klt.reject_outliers(self.prev_pts, pts, status, tuple(self.cur_img.shape[-2:]))

        if self.use_ransac:
            prev_n = self._undistort(self.prev_pts)
            cur_n = self._undistort(pts)
            key, sub = prng.split(self._key)
            self._key = torch.where(torch.any(self.prev_valid), key, self._key)
            # departure: the pairs at the program's width, not at dR's dtype's
            # (two_point_ransac is sample_pairs then score_pairs)
            i1, i2 = ransac.sample_pairs(status[0], sub, NUM_ITERS, self.int_bits)
            kept = status & ransac.score_pairs(self.dR, prev_n[0], cur_n[0], status[0], i1, i2,
                                               self.ransac_threshold)[None]
            # departure: the counters
            self.ransac_frames = self.ransac_frames + (torch.sum(status) >= 5)
            self.ransac_rejected = self.ransac_rejected + torch.sum(status & ~kept)
            status = kept

        self.cur_pts = pts
        self.cur_ids = torch.where(status, self.prev_ids, torch.full_like(self.prev_ids, -1))
        self.cur_valid = status

        uv_norm = self._undistort(pts)
        return (torch.where(status[..., None], uv_norm, 0.0).to(self.dtype), self.cur_ids, status)


class RansacLiveReference(LiveReference):
    """``LiveReference`` on a :class:`RansacTrackHandler`."""

    def __init__(self, config, th_kwargs, imu0, dtype, device, int_bits: int):
        super().__init__(config, th_kwargs, imu0, dtype, device)
        cam = config.camera
        K = np.array([[cam.f_u, 0, cam.c_u], [0, cam.f_v, cam.c_v], [0, 0, 1.0]])
        self.th = RansacTrackHandler(K, cam.distortion_coeffs, cam.distortion_model, dtype=dtype,
                                     device=self.device, int_bits=int_bits, **th_kwargs)


def live(config, seq, imu0, images, dtype, device, tf32=False):
    """``runner.live`` on :class:`RansacLiveReference`, drawing at the width
    of ``config``'s dtype; the trail adds ``ransac``: {"ransac_frames",
    "ransac_rejected"}, the tracker's counters after the last frame."""
    from portbench.harness.cell import build_config

    cfg = build_config(config, 1, ref_config)
    # the program's width: JAX's default int for its dtype (64 bits only in float64)
    int_bits = 64 if config["dtype"] == "float64" else 32
    pos, dec = [], []
    with runner.precision(tf32), torch.no_grad():
        ref = RansacLiveReference(cfg, config["track_handler"], imu0, dtype, device, int_bits)
        for i in range(images.shape[0]):
            ref.frame(images[i], seq["imu_omega"][i], seq["imu_acc"][i], seq["imu_dt"][i],
                      float(seq["time"][i]))
            pos.append(ref.state.imu.p_I_G.double().cpu())
            dec.append(runner.decisions(ref.state))
    trail = runner._trail(pos, dec)
    trail["ransac"] = {k: int(getattr(ref.th, k)) for k in ("ransac_frames", "ransac_rejected")}
    return trail
