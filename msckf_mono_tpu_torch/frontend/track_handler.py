"""Per-frame front-end object of the live path (port of ``msckf_mono_tpu/frontend/track_handler.py``).

``TrackHandler`` (reference corner_detector.cpp:196-439) with fixed-size
feature slots. The per-frame contract is the reference's: after
:meth:`TrackHandler.set_current_image`, :meth:`TrackHandler.tracked_features`
returns the KLT-surviving features (undistorted, normalized) with their ids
and :meth:`TrackHandler.new_features` freshly detected corners with fresh
monotone ids.

Per frame (corner_detector.cpp:320-429): gyro accumulation -> mean rotation
over the inter-frame interval (Rodrigues, :220-244) -> the front-end stages
of ``frontend/functional`` that the image fleets run too: per-cell dedup
(:292-308) of the previous frame's lists, at ingest -> pyramid ->
homography prediction, pyramidal KLT and rejection -> optional two-point
RANSAC (shipped disabled, :366) -> the tracked outputs -> detection in
unoccupied grid cells. The handler owns the gyro, the lazy pyramids, RANSAC
and the carry; its parameters are one :class:`FrontendConfig`.

Arrays are one filter's, batch-first (B = Bi = 1): points (1, F, 2), ids and
flags (1, F), images (1, H, W). The handler keeps everything on its device
and synchronizes with the host nowhere: the gyro sum and count, the
feature-id counter and the "anything to track" test are device tensors (KLT
runs on an all-invalid set rather than branch on it, which gives the same
outputs). Only the time stamps are host scalars; the frame interval can come
in as a device tensor instead.

The tensors one frame hands to the next are :meth:`TrackHandler.carry`
(:data:`CARRY`); :meth:`TrackHandler.load` rebinds them. The live interface
captures a frame's device work (``_ingest`` -> :meth:`tracked_features` ->
:meth:`new_features`) in a CUDA graph over that carry once the handler
holds an image and its pyramid (:meth:`TrackHandler.graphable`): from the
second image on, RANSAC on or off. RANSAC's hypothesis pairs come from a
device key in the carry, split each frame that has features to track, as the
JAX package splits its ``jax.random`` key (track_handler.py:174).

RANSAC's work (the two undistorts, the key split, the draw and the scoring)
is the stage ``frontend.ransac``, nested in ``frontend.track``. Two 0-d int64
counters, added to on the device and carried with RANSAC on, count what it
did: ``ransac_frames``, the frames its hypotheses decided (5 valid tracks or
more), and ``ransac_rejected``, the tracks KLT kept and RANSAC dropped. Read
them after a run; reading one synchronizes.
"""

from __future__ import annotations

import numpy as np
import torch

from msckf_mono_tpu_torch.eval.profile import stage
from msckf_mono_tpu_torch.frontend import functional, ransac, undistort
from msckf_mono_tpu_torch.frontend.functional import FrontendConfig
from msckf_mono_tpu_torch.utils import prng, quat


class TrackHandler:
    def __init__(
        self,
        K: np.ndarray,
        dist_coeffs,
        dist_model: str = "radtan",
        n_grid_rows: int = 10,
        n_grid_cols: int = 10,
        max_features: int = 200,
        window_size: int = 31,
        max_level: int = 4,
        ransac_threshold: float = 2e-7,
        use_ransac: bool = False,   # the reference ships it disabled (&& false)
        fast_threshold: float = 20.0,
        detection_threshold: float = 40.0,
        dtype=torch.float32,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.K = torch.as_tensor(np.asarray(K, np.float64), dtype=dtype, device=self.device)
        self.K_inv = torch.as_tensor(np.linalg.inv(np.asarray(K, np.float64)), dtype=dtype,
                                     device=self.device)
        self.dist_coeffs = tuple(float(c) for c in np.asarray(dist_coeffs).ravel())
        self.dist_model = dist_model
        self.fcfg = FrontendConfig(
            n_grid_rows=n_grid_rows, n_grid_cols=n_grid_cols, max_features=max_features,
            window_size=window_size, max_level=max_level, max_iters=30,
            fast_threshold=fast_threshold, detection_threshold=detection_threshold,
            max_flow_px=25.0, image_precision="highest",
        )
        self.ransac_threshold = ransac_threshold
        self.use_ransac = use_ransac
        self.dtype = dtype

        self.prev_img = None
        self.cur_img = None
        self.prev_time = 0.0
        self.cur_time = 0.0
        self._prev_pyr = None
        self._cur_pyr = None
        self._next_id = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._key = prng.PRNGKey(0, device=self.device)
        # RANSAC's counters (0-d int64, added to on the device, carried with
        # RANSAC on): frames its hypotheses decided, tracks it dropped
        self.ransac_frames = torch.zeros((), dtype=torch.int64, device=self.device)
        self.ransac_rejected = torch.zeros((), dtype=torch.int64, device=self.device)

        self.prev_pts, self.prev_ids, self.prev_valid = self._empty()
        self.cur_pts, self.cur_ids, self.cur_valid = self._empty()
        self.new_pts, self.new_ids, self.new_valid = self._empty()

        self._gyro_sum = torch.zeros((3,), dtype=torch.float64, device=self.device)
        self._gyro_n = torch.zeros((), dtype=torch.float64, device=self.device)
        # (3, 3), not (1, 3, 3): the stages broadcast one rotation with the
        # plain products; a batched one takes other GEMMs, rounded otherwise
        self.dR = torch.eye(3, dtype=dtype, device=self.device)

    def _empty(self):
        F, dev = self.fcfg.max_features, self.device
        return (torch.zeros((1, F, 2), dtype=self.dtype, device=dev),
                torch.full((1, F), -1, dtype=torch.int32, device=dev),
                torch.zeros((1, F), dtype=torch.bool, device=dev))

    @property
    def next_feature_id(self) -> int:
        """The id counter (reads the device)."""
        return int(self._next_id[0])

    @next_feature_id.setter
    def next_feature_id(self, value: int):
        self._next_id = torch.full((1,), int(value), dtype=torch.int32, device=self.device)

    @property
    def n_gyro(self) -> int:
        """Gyro readings since the last frame (reads the device)."""
        return int(self._gyro_n)

    # ---- the frame-to-frame carry ----

    def carry(self) -> dict:
        """The tensors one frame hands to the next, by name (:data:`CARRY`,
        and RANSAC's counters with it on).
        ``prev_img`` is only an output (each frame sets it from ``cur_img``),
        so before the second image it enters as ``cur_img``."""
        out = {k: getattr(self, k) for k in self._carried()}
        if out["prev_img"] is None:
            out["prev_img"] = out["cur_img"]
        return out

    def load(self, carry: dict):
        """Rebind the handler's tensors to ``carry`` (a :meth:`carry` dict;
        a ``prev_img`` that is ``cur_img`` itself stands for none)."""
        for k in self._carried():
            setattr(self, k, carry[k])
        if carry["prev_img"] is carry["cur_img"]:
            self.prev_img = None
        self._prev_pyr = None

    def _carried(self):
        """:data:`CARRY`, and with RANSAC on its counters
        (:data:`RANSAC_COUNTERS`); with it off the counters stay out of the
        frame's graph."""
        return CARRY + RANSAC_COUNTERS if self.use_ransac else CARRY

    def graphable(self) -> bool:
        """Whether the next frame's device work can be one captured graph:
        the handler holds an image and its pyramid."""
        return self.cur_img is not None and self._cur_pyr is not None

    # ---- gyro warp (corner_detector.cpp:215-276) ----

    def add_gyro_reading(self, gyro, mask=None):
        """One camera-frame gyro reading (3,), or n of them (n, 3), from the
        host or from the handler's device; ``mask`` (n,) on the device keeps
        the readings where it is set (a padded block)."""
        g = torch.as_tensor(gyro, device=self.device).to(torch.float64).reshape(-1, 3)
        if mask is None:
            self._gyro_sum = self._gyro_sum + torch.sum(g, dim=0)
            self._gyro_n = self._gyro_n + g.shape[0]
        else:
            m = mask.to(torch.float64)
            self._gyro_sum = self._gyro_sum + torch.sum(g * m[:, None], dim=0)
            self._gyro_n = self._gyro_n + torch.sum(m)

    def _integrate_gyro(self, dt=None):
        """The mean rotation over the frame interval ``dt`` (default: the
        host's stamps; a device tensor in a captured frame). With no readings
        the sum is zero and the rotation the identity."""
        dt = self.cur_time - self.prev_time if dt is None else dt
        # For camera angular velocity ω in the camera frame, points move by
        # R_c2<-c1 = exp(-[ω·dt]x). (The reference feeds the gyro through
        # q_CI.inverse() and uses +ω — asl_msckf.cpp:235,
        # corner_detector.cpp:220-244 — which mis-frames the prediction; KLT's
        # large window hides it there. This is the correct sign and frame.)
        rvec = -self._gyro_sum / torch.clamp_min(self._gyro_n, 1.0) * dt
        angle = torch.linalg.vector_norm(rvec)
        small = angle < 1e-12
        axis = rvec / torch.where(small, torch.ones_like(angle), angle)
        q = torch.cat([torch.cos(angle / 2)[None], torch.sin(angle / 2) * axis])
        # the identity built on the device (a Python scalar stored into a
        # CUDA tensor is a host->device copy that syncs)
        identity = torch.cat([torch.ones_like(angle)[None], torch.zeros_like(axis)])
        q = torch.where(small, identity, q)
        self.dR = quat.to_rotmat(q.to(self.dtype))
        self._gyro_sum = torch.zeros_like(self._gyro_sum)
        self._gyro_n = torch.zeros_like(self._gyro_n)

    # ---- frame ingestion (corner_detector.cpp:278-318) ----

    def set_current_image(self, img, time: float):
        """img: (H, W) or (1, H, W), a host array or a tensor."""
        self.prev_time = self.cur_time
        self.cur_time = float(time)
        self._ingest(img)

    def _ingest(self, img):
        """The device part of :meth:`set_current_image`."""
        self.prev_img = self.cur_img
        self._prev_pyr, self._cur_pyr = self._cur_pyr, None

        img = torch.as_tensor(img, device=self.device).to(self.dtype)
        img = img.reshape((1,) + tuple(img.shape[-2:]))
        H, W = (img if self.cur_img is None else self.cur_img).shape[-2:]
        self.prev_pts, self.prev_ids, self.prev_valid = functional.dedup(
            (self.cur_pts, self.cur_ids, self.cur_valid),
            (self.new_pts, self.new_ids, self.new_valid), H, W, self.fcfg)

        self.cur_img = img
        self.cur_pts, self.cur_ids, self.cur_valid = self._empty()
        self.new_pts, self.new_ids, self.new_valid = self._empty()

    def _pyramid(self, img, cached):
        return cached if cached is not None else functional.pyramid(img, self.fcfg)

    # ---- tracking (corner_detector.cpp:320-394) ----

    def tracked_features(self, dt=None):
        """Returns (uv_normalized (1, F, 2), ids (1, F), valid (1, F)).
        ``dt``: the frame interval, if not the host stamps' difference."""
        self._integrate_gyro(dt)
        if self.prev_img is None:
            # the first image: nothing to track; its pyramid serves the next frame
            self._cur_pyr = self._pyramid(self.cur_img, self._cur_pyr)
            return self._empty()

        self._prev_pyr = self._pyramid(self.prev_img, self._prev_pyr)
        self._cur_pyr = self._pyramid(self.cur_img, self._cur_pyr)
        with stage("frontend.track"):
            pts, status = functional.track(self._prev_pyr, self._cur_pyr, self.prev_pts,
                                           self.prev_valid, self.dR, self.K, self.K_inv, self.fcfg)
            if self.use_ransac:
                status = self._ransac(pts, status)

            self.cur_pts, self.cur_valid = pts, status
            uv, self.cur_ids = functional.tracked_outputs(pts, status, self.prev_ids, self.K,
                                                          self.dist_coeffs, self.dist_model)
            return uv, self.cur_ids, status

    def _ransac(self, pts, status):
        """Two-point RANSAC over KLT's survivors ``status`` (1, F), in its own
        range inside ``frontend.track``; the counters add this frame's
        decision and rejects on the device."""
        with stage("frontend.ransac"):
            prev_n = self._undistort(self.prev_pts)
            cur_n = self._undistort(pts)
            # the JAX package splits its key only on a frame with features to
            # track (it returns early on the others)
            key, sub = prng.split(self._key)
            self._key = torch.where(torch.any(self.prev_valid), key, self._key)
            kept = status & ransac.two_point_ransac(
                self.dR, prev_n[0], cur_n[0], status[0], sub, self.ransac_threshold,
            )[None]
            # the hypotheses decide with 5 valid tracks or more; with fewer every
            # track is kept (corner_detector.cpp:480-483)
            self.ransac_frames = self.ransac_frames + (torch.sum(status) >= 5)
            self.ransac_rejected = self.ransac_rejected + torch.sum(status & ~kept)
            return kept

    # ---- detection (corner_detector.cpp:396-429) ----

    def new_features(self):
        """Detect new corners avoiding occupied cells; fresh monotone ids."""
        self.new_pts, uv, self.new_ids, self.new_valid, self._next_id = functional.detect_new(
            self.cur_img, self.cur_pts, self.cur_valid, self._next_id, self.K, self.dist_coeffs,
            self.dist_model, self.fcfg)
        return uv, self.new_ids, self.new_valid

    def _undistort(self, pts):
        return undistort.undistort_points(pts, self.K, self.dist_coeffs, self.dist_model)

    def clear_tracks(self):
        self.prev_img = None
        self._cur_pyr = None
        self.prev_valid = torch.zeros_like(self.prev_valid)
        self.cur_valid = torch.zeros_like(self.cur_valid)

    # ---- numpy carry (tests start the port from the JAX package's state) ----

    _ARRAYS = ("prev_pts", "prev_ids", "prev_valid", "cur_pts", "cur_ids", "cur_valid",
               "new_pts", "new_ids", "new_valid")

    def state_to_numpy(self) -> dict:
        """Arrays (batch axis kept), images and host scalars as a dict."""
        out = {k: getattr(self, k).detach().cpu().numpy().copy() for k in self._ARRAYS}
        for k in ("prev_img", "cur_img"):
            img = getattr(self, k)
            out[k] = None if img is None else img.detach().cpu().numpy().copy()
        out.update(prev_time=self.prev_time, cur_time=self.cur_time,
                   next_feature_id=self.next_feature_id, n_gyro=self.n_gyro,
                   gyro_accum=self._gyro_sum.cpu().numpy().copy(),
                   key=self._key.cpu().numpy().copy())
        return out

    def state_from_numpy(self, arrays: dict):
        """Inverse of :meth:`state_to_numpy`; (F, ...) arrays get the batch axis."""
        for k in self._ARRAYS:
            x = torch.as_tensor(np.asarray(arrays[k]), device=self.device)
            x = x.to(self.dtype) if x.is_floating_point() else x
            setattr(self, k, x.reshape((1,) + tuple(x.shape[-2:] if k.endswith("pts")
                                                   else x.shape[-1:])))
        for k in ("prev_img", "cur_img"):
            img = arrays[k]
            setattr(self, k, None if img is None else torch.as_tensor(
                np.asarray(img), dtype=self.dtype, device=self.device).reshape(
                (1,) + tuple(np.shape(img)[-2:])))
        self._prev_pyr = self._cur_pyr = None
        self.prev_time = float(arrays["prev_time"])
        self.cur_time = float(arrays["cur_time"])
        self.next_feature_id = int(arrays["next_feature_id"])
        self._gyro_n = torch.tensor(float(arrays["n_gyro"]), dtype=torch.float64,
                                    device=self.device)
        self._gyro_sum = torch.as_tensor(np.asarray(arrays["gyro_accum"], np.float64),
                                         device=self.device)
        self._key = torch.as_tensor(np.asarray(arrays["key"], np.int64), device=self.device)


CARRY = ("prev_img", "cur_img", "_cur_pyr", "prev_pts", "prev_ids", "prev_valid", "cur_pts",
         "cur_ids", "cur_valid", "new_pts", "new_ids", "new_valid", "_next_id", "_gyro_sum",
         "_gyro_n", "dR", "_key")
RANSAC_COUNTERS = ("ransac_frames", "ransac_rejected")
