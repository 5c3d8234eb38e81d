"""Live streaming VIO interface (port of ``msckf_mono_tpu/interface.py``).

The middleware-free ``RosInterface`` (reference ros_interface.h:23-86,
src/ros_interface.cpp): ``imu_callback`` queues readings
(ros_interface.cpp:22-46); ``image_callback`` drains the queue up to the
image stamp, propagates, feeds the gyro to the tracker and runs augment ->
update -> addFeatures -> marginalize -> prune (ros_interface.cpp:48-120).
Publishers become getters (:meth:`VioInterface.odometry`,
:meth:`VioInterface.cam_states`, :meth:`VioInterface.map_points`,
:meth:`VioInterface.map`, :meth:`VioInterface.pruned_states`,
:meth:`VioInterface.track_overlay`).

Standstill self-calibration follows ros_interface.cpp:157-206: readings are
buffered until the stand-still window elapses, then b_g = mean gyro, q_IG
aligns -g with the mean accel, b_a = q·g + mean accel. The live node skips
redundant-state pruning (ros_interface.cpp:111-116); pass a config with
``filter.use_prune_redundant=False`` for that.

One frame is one filter (B = 1) on ``device``. A frame's host inputs (the
image and one float64 vector with the IMU block, its gyro mask, the state
id, the time and the frame interval) are written into pinned staging
buffers and copied to the device without blocking. From the second image on,
the frame's device work (the gyro readings into the tracker, the tracker,
the filter step, and its outputs packed for the copy back) replays one
captured CUDA graph (``ops/cuda_graph.StepGraph``; JAX jits the step at
``msckf_mono_tpu/interface.py:101``), two-point RANSAC on or off (its
hypothesis pairs are drawn on the device from a key in the tracker's carry);
the first frame, frames after :meth:`TrackHandler.clear_tracks` or a state
restore, and every frame under ``cuda_graph.disabled()`` run the same
function eagerly. The rare frame with more readings than one IMU block
propagates the earlier blocks eagerly first. :meth:`VioInterface.finish`
replays the graphed ``core/filter.finish``.

The filter state (``state``) and the tracker's tensors then live in the
graph's buffers, which the next frame updates in place: copy what must
outlive a frame (``.cpu()`` on the card, ``.clone()`` or ``.numpy().copy()``
on the CPU).

The frame synchronizes with the host at most once, after its work: one
device→host copy brings back the odometry, the archive buffers and the
tracker's features for the visualizer together, only when the archives or
the visualizer are kept. ``host_copies`` counts every device→host copy the
interface makes.

Host spans (``eval/profile.span``; request id: the frame's ``frame_count``):
``live.imu`` for each reading (the next frame's id), and ``live.frame`` for
each image, around ``live.drain`` (the queue drained, and the rare earlier
blocks propagated), ``live.stage`` (the host inputs into the staging
buffers, after the previous frame that read them), the graph's
``graph.load`` and ``graph.replay``, ``live.copy_back`` (the host's wait on
the device and the copy) and ``live.unpack``. ``LiveFrame.frame`` marks
its front-end as the stage ``step.frontend``; the tracker's stages inside it
are the image step's ``frontend.dedup`` (at ingest), ``frontend.pyramid``,
``frontend.track`` and ``frontend.detect``, and with RANSAC on
``frontend.ransac`` inside ``frontend.track``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from msckf_mono_tpu_torch.core import filter as msckf_filter
from msckf_mono_tpu_torch.core import pipeline
from msckf_mono_tpu_torch.core.filter import FrameInput
from msckf_mono_tpu_torch.core.init import ground_truth_init, standstill_init
from msckf_mono_tpu_torch.core.types import filter_state_from_numpy, filter_state_to_numpy, init_filter_state
from msckf_mono_tpu_torch.eval.profile import span, stage
from msckf_mono_tpu_torch.frontend.functional import FrontendOutput
from msckf_mono_tpu_torch.frontend.track_handler import TrackHandler
from msckf_mono_tpu_torch.frontend.visualize import TrackVisualizer
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils import quat as quat_ops
from msckf_mono_tpu_torch.utils.config import MsckfConfig


@dataclass
class ImuReading:
    """Mirrors ``imuReading<_S>`` (reference types.h:78-84)."""

    omega: np.ndarray  # (3,)
    acc: np.ndarray    # (3,)
    time: float
    dt: float


def to_host(tensors):
    """Bring tensors of one device back in ONE device→host copy.

    Each is flattened into one float64 buffer on its device (exact for the
    float32/float64 values, int32 ids and bool masks the filter holds), the
    buffer is copied, and the host arrays are cut from it with their own
    dtypes and shapes.
    """
    return _unpack(_pack(tensors).cpu().numpy(), tensors)


def _pack(tensors):
    """The tensors as one float64 vector on their device."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])


def _unpack(flat, like):
    """Host arrays cut from ``flat`` with the dtypes and shapes of ``like``."""
    out, at = [], 0
    for t in like:
        n = t.numel()
        dt = np.bool_ if t.dtype == torch.bool else torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[at:at + n].astype(dt).reshape(tuple(t.shape)))
        at += n
    return out


_ODOMETRY = ("p_I_G", "q_IG", "v_I_G", "b_g", "b_a")
_ARCHIVE = ("map_mask", "map_pts", "tri_map_mask", "tri_map_pts", "pruned_mask", "pruned_ids",
            "pruned_time", "pruned_q", "pruned_p")
_FEATURES = ("cur_pts", "cur_ids", "cur_valid", "new_pts", "new_ids", "new_valid")
FRAME_OUTPUTS = _ODOMETRY + _ARCHIVE + _FEATURES


class VioInterface:
    """Push-based live pipeline: feed IMU + images, read the state back.

    Parameters mirror the ROS-parameter surface the reference loads
    (ros_interface.cpp:221-346) as one typed :class:`MsckfConfig`.
    """

    def __init__(
        self,
        config: MsckfConfig | None = None,
        stand_still_time: float = 8.0,
        dtype=torch.float32,
        track_handler_kwargs: dict | None = None,
        keep_visualizer: bool = False,
        collect_archives: bool = True,
        device="cuda",
    ):
        self.config = config or MsckfConfig()
        self.dtype = dtype
        self.device = torch.device(device)
        self.stand_still_time = float(stand_still_time)

        cam = self.config.camera
        K = np.array([[cam.f_u, 0, cam.c_u], [0, cam.f_v, cam.c_v], [0, 0, 1.0]])
        th_kwargs = dict(n_grid_rows=10, n_grid_cols=10,
                         max_features=self.config.shapes.max_features_per_frame * 2)
        th_kwargs.update(track_handler_kwargs or {})
        self.track_handler = TrackHandler(K, cam.distortion_coeffs, cam.distortion_model,
                                          dtype=dtype, device=self.device, **th_kwargs)
        self.visualizer = TrackVisualizer() if keep_visualizer else None

        self.imu_queue: deque[ImuReading] = deque()
        self.imu_calibrated = False
        self._calib_buffer: list[ImuReading] = []
        self.state = None
        self.frame_count = 0
        self._q_CI = torch.as_tensor(cam.q_CI, dtype=dtype, device=self.device)
        self._map_accum: list[np.ndarray] = []
        self._pruned_accum: list[dict] = []
        # The cumulative map_/pruned_states_ archives cost one device→host
        # copy a frame; users who never call map()/pruned_states() can turn
        # the accumulation off.
        self.collect_archives = bool(collect_archives)
        self.host_copies = 0
        self._host = None          # this frame's host copy of odometry, archives, features
        self._live_frame = LiveFrame(self.config, self.track_handler, dtype, self.device)
        self._last_image = None
        self._last_image_time = None
        # Device-side times are SECONDS SINCE THE FIRST IMAGE: float32 ULP at
        # an absolute epoch stamp (~1.4e9 s) is ~128 s, which would quantize
        # window/pruned pose timestamps. Getters add the origin back in f64.
        self._time_origin: float | None = None

    # ---- callbacks (ros_interface.h:25-26) ----

    def imu_callback(self, omega, acc, time: float, dt: float | None = None):
        """Queue one IMU reading (ros_interface.cpp:22-46).

        ``dt`` defaults to the gap since the previous reading, like the
        reference's prev_imu_time bookkeeping (ros_interface.cpp:31-43).
        """
        with span("live.imu", request=self.frame_count + 1):
            omega = np.asarray(omega, float)
            acc = np.asarray(acc, float)
            if dt is None:
                prev = (self.imu_queue[-1].time if self.imu_queue
                        else (self._calib_buffer[-1].time if self._calib_buffer else None))
                dt = 0.0 if prev is None else time - prev
            reading = ImuReading(omega=omega, acc=acc, time=float(time), dt=float(dt))
            if self.imu_calibrated:
                self.imu_queue.append(reading)
            else:
                self._calib_buffer.append(reading)
                if self._can_initialize_imu():
                    self._initialize_imu()

    def image_callback(self, image, time: float):
        """Process one grayscale (H, W) frame (ros_interface.cpp:48-120).

        Returns True if the filter ran (i.e. the IMU is calibrated).
        """
        if not self.imu_calibrated:
            return False
        with span("live.frame", request=self.frame_count + 1):
            return self._image_frame(image, time)

    def _image_frame(self, image, time: float):
        if self._time_origin is None:
            self._time_origin = float(time)

        cfg = self.config
        K = cfg.shapes.imu_per_frame
        th = self.track_handler
        with span("live.drain"):
            drained = self._drain_imu(time)
            self.frame_count += 1

            # all-but-last block (the rare > K readings case): their gyro
            # readings into the tracker and pure propagation, eagerly
            split = max(0, -(-len(drained) // K) - 1) * K
            if split:
                blocks, gyro, _, _ = _pack_frame(drained[:split], K, 0, 0.0, self.dtype,
                                                 self.device)
                th.add_gyro_reading(quat_ops.rotate(self._q_CI,
                                                    (gyro - self.state.imu.b_g).to(self.dtype)))
                for omega, acc, dts in blocks:
                    frame = _imu_only_frame(omega, acc, dts, cfg, self.dtype)
                    self.state = msckf_filter.propagate_block(self.state, frame, cfg)

        image = np.asarray(image)
        readings = drained[split:]
        self.state, packed = self._live_frame(
            self.state, image, [r.omega for r in readings], [r.acc for r in readings],
            [r.dt for r in readings], self.frame_count, time - self._time_origin, time)
        self._last_image_time = time
        self._host = None
        if self.collect_archives or self.visualizer is not None:
            self.host_copies += 1
            with span("live.copy_back"):
                flat = packed.cpu().numpy()
            with span("live.unpack"):
                self._pull_frame(flat)
        if self.visualizer is not None:
            self._last_image = image
        return True

    def _pull_frame(self, flat):
        """The frame's host copy (``flat``, the packed outputs of
        :meth:`LiveFrame.frame`), then the host-side bookkeeping."""
        h = self._host = dict(zip(FRAME_OUTPUTS,
                                  _unpack(flat, frame_outputs(self.state, self.track_handler))))
        if self.collect_archives:
            self._accumulate_map_and_pruned(h)
        if self.visualizer is not None:
            self.visualizer.add_current_features(h["cur_pts"], h["cur_ids"], h["cur_valid"])
            self.visualizer.add_new_features(h["new_pts"], h["new_ids"], h["new_valid"])

    def _copy(self, tensors):
        self.host_copies += 1
        return to_host(tensors)

    # ---- standstill init (ros_interface.cpp:157-206) ----

    def _can_initialize_imu(self) -> bool:
        if len(self._calib_buffer) < 2:
            return False
        span = self._calib_buffer[-1].time - self._calib_buffer[0].time
        return span >= self.stand_still_time

    def _initialize_imu(self):
        omega = np.stack([r.omega for r in self._calib_buffer])
        acc = np.stack([r.acc for r in self._calib_buffer])
        imu0 = standstill_init(omega, acc, dtype=self.dtype, device=self.device)
        self.state = init_filter_state(self.config, imu0, dtype=self.dtype, device=self.device)
        self.imu_calibrated = True
        self._calib_buffer.clear()

    def initialize_from_ground_truth(self, p_I_G, q_IG, v_I_G, b_g, b_a):
        """GT-seeded init (asl_msckf.cpp:151-159); skips the standstill calibration."""
        imu0 = ground_truth_init(p_I_G=p_I_G, q_IG=q_IG, v_I_G=v_I_G, b_g=b_g, b_a=b_a,
                                 dtype=self.dtype, device=self.device)
        self.state = init_filter_state(self.config, imu0, dtype=self.dtype, device=self.device)
        self.imu_calibrated = True
        self._calib_buffer.clear()

    def _drain_imu(self, stamp: float) -> list[ImuReading]:
        out = []
        while self.imu_queue and self.imu_queue[0].time <= stamp:
            out.append(self.imu_queue.popleft())
        return out

    # ---- getters (publish_core/publish_extra, ros_interface.cpp:122-155) ----

    def odometry(self) -> dict:
        """Pose + twist of the IMU state (publish_core, ros_interface.cpp:122-143)."""
        h = self._host
        if h is None:
            imu = self.state.imu
            h = dict(zip(_ODOMETRY, self._copy([getattr(imu, k)[0] for k in _ODOMETRY])))
        return {"time": self._last_image_time, **{k: h[k] for k in _ODOMETRY}}

    def cam_states(self) -> dict:
        """Valid window poses + per-state tracked-feature counts (the CamStates
        message, asl_msckf.cpp:377-403)."""
        w, t = self.state.window, self.state.tracks
        tracked = torch.sum(t.obs_mask & t.active[..., None], dim=1)
        valid, q, p, time, sid, n = self._copy(
            [w.valid[0], w.q_CG[0], w.p_C_G[0], w.time[0], w.state_id[0], tracked[0]])
        return {
            "q_CG": q[valid],
            "p_C_G": p[valid],
            "time": time[valid].astype(np.float64) + (self._time_origin or 0.0),
            "state_id": sid[valid],
            "n_tracked": n[valid],
        }

    def map_points(self) -> np.ndarray:
        """Last frame's triangulated features (the map point cloud,
        asl_msckf.cpp:337-352)."""
        mask, pts = self._copy([self.state.map_mask[0], self.state.map_pts[0]])
        return pts[mask]

    def _accumulate_map_and_pruned(self, h):
        """The reference's unbounded ``map_`` and ``pruned_states_`` archives
        (msckf.h:49-50), from the frame's host copy of the device buffers."""
        if h["map_mask"].any():
            self._map_accum.append(h["map_pts"][h["map_mask"]])
        if h["tri_map_mask"].any():
            self._map_accum.append(h["tri_map_pts"][h["tri_map_mask"]])
        pm = h["pruned_mask"]
        if pm.any():
            self._pruned_accum.append(dict(
                state_id=h["pruned_ids"][pm],
                time=h["pruned_time"][pm].astype(np.float64) + (self._time_origin or 0.0),
                q_CG=h["pruned_q"][pm],
                p_C_G=h["pruned_p"][pm],
            ))

    def map(self) -> np.ndarray:
        """CUMULATIVE map: every feature triangulated over the run — the
        reference's ``map_`` / ``getMap()`` (msckf.h:50, :820-823)."""
        if not self._map_accum:
            return np.zeros((0, 3))
        return np.concatenate(self._map_accum, axis=0)

    def pruned_states(self) -> dict:
        """Archived camera poses at their removal, sorted by state_id — the
        reference's ``pruned_states_`` / ``getPrunedStates()`` (msckf.h:49,
        :840-848)."""
        if not self._pruned_accum:
            return {"state_id": np.zeros((0,), np.int32), "time": np.zeros((0,)),
                    "q_CG": np.zeros((0, 4)), "p_C_G": np.zeros((0, 3))}
        cat = {k: np.concatenate([d[k] for d in self._pruned_accum]) for k in self._pruned_accum[0]}
        order = np.argsort(cat["state_id"], kind="stable")
        return {k: v[order] for k, v in cat.items()}

    def finish(self):
        """End-of-sequence: residualize every remaining track (MSCKF::finish,
        msckf.h:765-807). Points the final passes triangulate join the
        cumulative map."""
        self.state, pts, mask = msckf_filter.finish(self.state, self.config, collect_map=True)
        self._host = None
        m, p = self._copy([mask[0], pts[0]])
        if m.any():
            self._map_accum.append(p[m])

    def track_overlay(self) -> np.ndarray:
        """RGB debug image with tracks drawn (ros_interface.cpp:145-155)."""
        if self.visualizer is None or self._last_image is None:
            raise RuntimeError("construct with keep_visualizer=True")
        return self.visualizer.draw(self._last_image)

    # ---- numpy carry (tests start the port from the JAX package's state) ----

    def state_to_numpy(self) -> dict:
        """The filter state ("filter." + field path), the tracker's state
        ("th." + name) and the host scalars, as numpy arrays and numbers."""
        out = {"filter." + k: v for k, v in filter_state_to_numpy(self.state).items()}
        out.update({"th." + k: v for k, v in self.track_handler.state_to_numpy().items()})
        out.update(frame_count=self.frame_count, time_origin=self._time_origin,
                   imu_calibrated=self.imu_calibrated)
        return out

    def state_from_numpy(self, arrays: dict):
        """Inverse of :meth:`state_to_numpy`; filter arrays keep their batch axis."""
        self.state = filter_state_from_numpy(
            {k[len("filter."):]: v for k, v in arrays.items() if k.startswith("filter.")},
            device=self.device)
        self.track_handler.state_from_numpy(
            {k[len("th."):]: v for k, v in arrays.items() if k.startswith("th.")})
        self.frame_count = int(arrays["frame_count"])
        self._time_origin = arrays["time_origin"]
        self.imu_calibrated = bool(arrays["imu_calibrated"])
        self._host = None


class LiveFrame:
    """One filter's frame on (filter state, tracker) from host inputs: the
    frame's work of :class:`VioInterface` and ``cli/run_euroc``.

    A call stages the host inputs (pinned on the card) and runs
    :meth:`frame` on the device: from a captured CUDA graph, one for each
    image shape and dtype, when the tracker is :meth:`TrackHandler.graphable`
    (RANSAC on or off) and ``cuda_graph`` is enabled, else eagerly. It
    returns the new state (the graph's buffers, updated in place by the next
    call) and the frame's outputs packed for one copy back
    (:func:`frame_outputs` order).
    """

    def __init__(self, config: MsckfConfig, track_handler: TrackHandler, dtype=torch.float32,
                 device="cuda"):
        self.config, self.track_handler, self.dtype = config, track_handler, dtype
        self.device = torch.device(device)
        self._q_CI = torch.as_tensor(config.camera.q_CI, dtype=dtype, device=self.device)
        self.graphs = {}        # by image shape and dtype
        self._staging = None    # (key, image, vector) host buffers
        self._staged = None     # event after the last frame that read them

    def __call__(self, state, image, omega, acc, dt, state_id: int, t_rel: float, time: float):
        """``image`` (H, W) host array; ``omega``, ``acc`` (n, 3) and ``dt``
        (n,) the n <= K readings of the frame's IMU block; ``t_rel`` the time
        since the first image (the device's clock), ``time`` the image stamp."""
        th = self.track_handler
        frame_dt = float(time) - th.cur_time
        th.prev_time, th.cur_time = th.cur_time, float(time)
        with span("live.stage"):
            inputs = self._stage(image, omega, acc, dt, state_id, t_rel, frame_dt)
        carry = (state, th.carry())
        if cuda_graph.enabled() and th.graphable():
            key = (tuple(image.shape), image.dtype)
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = cuda_graph.StepGraph(self.frame, carry, inputs)
            (state, th_carry), packed = graph(carry, *inputs)
        else:
            inputs = tuple(x.to(self.device, non_blocking=True, copy=True) for x in inputs)
            (state, th_carry), packed = self.frame(carry, *inputs)
        th.load(th_carry)
        if self._staged is not None:
            self._staged.record()
        return state, packed

    def _stage(self, image, omega, acc, dt, state_id, t_rel, frame_dt):
        """The host inputs in the staging buffers: the image, and one float64
        vector of the IMU block (K rows of omega, acc, dt), its reading mask
        (K), the state id, the time since the first image and the frame
        interval. A buffer is refilled only after the frame that read it."""
        K = self.config.shapes.imu_per_frame
        key = (tuple(image.shape), image.dtype)
        if self._staging is None or self._staging[0] != key:
            pin = self.device.type == "cuda"
            self._staging = (key, torch.empty(image.shape, dtype=torch.from_numpy(image[:0]).dtype,
                                              pin_memory=pin),
                             torch.empty((8 * K + 3,), dtype=torch.float64, pin_memory=pin))
            self._staged = torch.cuda.Event() if pin else None
        elif self._staged is not None and not self._staged.query():
            self._staged.synchronize()
        _, img, vec = self._staging
        img.numpy()[...] = image
        v = vec.numpy()
        v[:] = 0.0
        n = len(dt)
        blk = v[: 7 * K].reshape(K, 7)
        if n:
            blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = omega, acc, dt
        v[7 * K: 7 * K + n] = 1.0
        v[8 * K:] = state_id, t_rel, frame_dt
        return img, vec

    def frame(self, carry, image, vec):
        """The frame's device work on (filter state, tracker carry) and the
        staged inputs: the block's gyro readings (less the bias estimate, in
        the camera frame) into the tracker, the tracker, the filter step.
        Returns the new carry and the packed :func:`frame_outputs`."""
        cfg, dtype, th = self.config, self.dtype, self.track_handler
        K = cfg.shapes.imu_per_frame
        state, th_carry = carry
        th.load(th_carry)
        blk = vec[: 7 * K].reshape(K, 7)
        with stage("step.frontend"):
            th.add_gyro_reading(quat_ops.rotate(self._q_CI,
                                                (blk[:, 0:3] - state.imu.b_g).to(dtype)),
                                vec[7 * K: 8 * K] > 0)
            th._ingest(image)
            feats = FrontendOutput(*th.tracked_features(vec[8 * K + 2]), *th.new_features())
            b = blk.to(dtype)[None]
            frame = pipeline.frame_input(feats, pipeline.ImageFrameInput(
                image=image, imu_omega=b[..., 0:3], imu_acc=b[..., 3:6], imu_dt=b[..., 6],
                state_id=vec[8 * K: 8 * K + 1].to(torch.int32), time=vec[8 * K + 1: 8 * K + 2],
                frame_valid=torch.ones((1,), dtype=torch.bool, device=vec.device),
            ), cfg)
        state, _ = msckf_filter.step(state, frame, cfg)
        return (state, th.carry()), _pack(frame_outputs(state, th))


def frame_outputs(state, th):
    """What a frame brings back, in ``_ODOMETRY``, ``_ARCHIVE``, ``_FEATURES``
    order (:data:`FRAME_OUTPUTS`): one filter's tensors without the batch axis."""
    return ([getattr(state.imu, k)[0] for k in _ODOMETRY] + [getattr(state, k)[0] for k in _ARCHIVE]
            + [getattr(th, k)[0] for k in _FEATURES])


def _pack_imu_blocks(readings, K, dtype, device="cuda"):
    """Split drained readings into ceil(n/K) blocks of K (dt = 0 padding):
    a list of (omega (1, K, 3), acc (1, K, 3), dt (1, K)), one device copy."""
    blocks, _, _, _ = _pack_frame(readings, K, 0, 0.0, dtype, device)
    return blocks


def _pack_frame(readings, K, state_id, t_rel, dtype, device):
    """One frame's host inputs in one host→device copy: the IMU blocks, the
    drained gyro readings (n, 3) as float64 (None without readings), the
    frame's state id (1,) int32 and its time (1,) in ``dtype``."""
    n = len(readings)
    n_blocks = max(1, -(-n // K))
    buf = np.zeros((n_blocks * K * 7 + 3 * n + 2,))
    blk = buf[: n_blocks * K * 7].reshape(n_blocks * K, 7)
    for i, r in enumerate(readings):
        blk[i, 0:3], blk[i, 3:6], blk[i, 6] = r.omega, r.acc, r.dt
    at = n_blocks * K * 7
    if n:
        buf[at:at + 3 * n] = np.stack([r.omega for r in readings]).reshape(-1)
    buf[-2:] = state_id, t_rel
    dev = torch.as_tensor(buf, device=device)
    blocks_t = dev[: n_blocks * K * 7].reshape(n_blocks, 1, K, 7).to(dtype)
    blocks = [(b[..., 0:3], b[..., 3:6], b[..., 6]) for b in blocks_t]
    gyro = dev[at:at + 3 * n].reshape(n, 3) if n else None
    return blocks, gyro, dev[-2:-1].to(torch.int32), dev[-1:].to(dtype)


def _imu_only_frame(omega, acc, dts, config, dtype):
    F = config.shapes.max_features_per_frame
    dev = omega.device
    z = torch.zeros((1, F, 2), dtype=dtype, device=dev)
    minus1 = torch.full((1, F), -1, dtype=torch.int32, device=dev)
    false = torch.zeros((1, F), dtype=torch.bool, device=dev)
    return FrameInput(
        imu_omega=omega, imu_acc=acc, imu_dt=dts,
        tracked_uv=z, tracked_ids=minus1, tracked_valid=false,
        new_uv=z, new_ids=minus1, new_valid=false,
        state_id=torch.full((1,), -1, dtype=torch.int32, device=dev),
        time=torch.zeros((1,), dtype=dtype, device=dev),
        frame_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
    )
