"""Typed configuration for the PyTorch MSCKF port.

The port's own copy of ``msckf_mono_tpu/utils/config.py``: the same fields and
defaults, so ``dataclasses.asdict`` of the two configs compares equal. It
replaces the reference's three-tier ROS parameter plumbing
(reference src/ros_interface.cpp:221-346, datasets/asl_msckf.cpp:59-134) with a
single explicit dataclass hierarchy plus a derived-parameter stage. Defaults
reproduce the EuRoC configuration in reference launch/euroc.launch:13-45
combined with the in-code defaults the launch file's misnamed keys silently
fall back to (see SURVEY.md §5 "config").

Everything here is static (hashable); per-filter tensor-valued parameters live
in the state dataclasses instead.

Deviation on the GPU: ``FilterConfig.gating_precision`` is kept for parity
with the JAX config, but every setting computes the gate in full f32 (the
port disables TF32 at import, see ``msckf_mono_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + IMU-camera extrinsics.

    Mirrors ``Camera<_S>`` (reference types.h:49-55). The stereo baseline ``b``
    of the reference is unused there and omitted here. Extrinsics: ``q_CI``
    rotates IMU-frame vectors into the camera frame; ``p_C_I`` is the camera
    position in the IMU frame (ros_interface.cpp:250-274).
    """

    f_u: float = 458.654
    f_v: float = 457.296
    c_u: float = 367.215
    c_v: float = 248.375
    # wxyz
    q_CI: tuple = (0.002571, -0.0153, -0.712468, 0.701527)
    p_C_I: tuple = (-0.0216401454975, -0.064676986768, 0.00981073058949)
    width: int = 752
    height: int = 480
    distortion_model: str = "radtan"
    distortion_coeffs: tuple = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


@dataclass(frozen=True)
class NoiseConfig:
    """Continuous-time IMU noise + initial covariance + pixel noise.

    Mirrors ``noiseParams`` (reference types.h:86-92) with the derivation of
    ``u_var_prime = (feature_cov / f_u)^2`` done in :func:`derived_pixel_sigma`
    (ros_interface.cpp:313-314).
    """

    w_var: float = 1e-4          # gyro noise density^2        (euroc.launch:17)
    dbg_var: float = 3.6733e-5   # gyro bias random walk^2     (euroc.launch:18)
    a_var: float = 1e-2          # accel noise density^2       (euroc.launch:19)
    dba_var: float = 7e-2        # accel bias random walk^2    (euroc.launch:20)

    q_var_init: float = 1e-5
    bg_var_init: float = 1e-2
    v_var_init: float = 1e-2
    ba_var_init: float = 1e-2
    p_var_init: float = 1e-12

    feature_cov_px: float = 2.0  # pixel sigma  (euroc.launch:15)


@dataclass(frozen=True)
class FilterConfig:
    """Filter thresholds, mirroring ``MSCKFParams`` (reference types.h:94-99).

    ``max_gn_cost_norm_px`` is in pixels and converted by ``(px / f_u)^2``
    (ros_interface.cpp:317). ``min_rcond`` is carried for parity but unused by
    the reference core as well (SURVEY.md §2.1).
    """

    max_gn_cost_norm_px: float = 7.0       # euroc.launch:28
    translation_threshold: float = 0.1     # euroc.launch:29
    min_rcond: float = 3e-12
    redundancy_angle_thresh: float = 0.005   # see note below
    redundancy_distance_thresh: float = 0.05
    min_track_length: int = 5              # euroc.launch:34
    max_track_length: int = 50             # euroc.launch:35
    max_cam_states: int = 20               # in-code default (asl_msckf.cpp:118)
    # offline runner runs redundant pruning (asl_msckf.cpp:289); the live node
    # has it commented out (ros_interface.cpp:111-116)
    use_prune_redundant: bool = True
    # matmul precision for the filter math. On TPU the "default" f32 dot uses
    # bf16 MXU passes whose mantissa destroys covariance algebra; "float32"
    # (a.k.a. highest) keeps true f32.
    matmul_precision: str = "highest"
    # Precision of the GATING einsums only (S = HPH^T + sigma^2 I for the
    # chi^2 test). "high" (3-pass bf16, ~1e-6 relative on S) is safe for a
    # threshold test and measurably cheaper; default follows the strict
    # configuration, the bench/serving config sets "high". MEASURED at the
    # deployed 1024x200 shape (AB_SWEEP.json, round 4): fleet-mean ATE
    # identical to "highest" to 4 decimals, +0.6% throughput.
    gating_precision: str = "highest"

    # Fuse the marginalize and prune-redundant EKF updates into ONE stacked
    # update per frame (one gate batch, one (R,R) solve, one Joseph pass
    # instead of two of each — the two updates were the entire hot path of
    # the round-3 TPU trace). Documented deviation when on: the reference
    # runs them sequentially (asl_msckf.cpp:268-296), so redundant-slot
    # selection and the prune gate see the pre-marginalize window/P; both
    # are EKF linearizations at the same state, differing at second order.
    # Off = strict reference ordering (the default for parity/golden tests;
    # bench/serving flips it on).
    fused_updates: bool = False

    # LM triangulation schedule (reference msckf.h:1179-1248 runs 11 outer
    # iterations x 11 lambda trials). Serving configs shrink both: measured
    # convergence on the bench world is 2-4 outer iterations with trial 0-1
    # accepted, and a truncated failed sweep escalates lambda exactly like
    # the reference's full failed sweep (see triangulate.initialize_position).
    lm_iters: int = 11
    lm_trials: int = 11

    # QR "T_H" row compression before the update (msckf.h:1343-1366). With
    # isotropic R the compressed and direct updates are algebraically
    # identical; the direct path is ~4x cheaper on TPU (batched QR is slow),
    # so this is off by default and kept for the reference-shaped pipeline.
    use_qr_compression: bool = False

    # Reference quirks, individually toggleable:
    chi2_offbyone: bool = True             # msckf.h:1117 table[dof+1]
    # Exact anisotropic measurement noise R_o = A_jᵀ diag(u_var', v_var') A_j
    # (msckf.h:411-431). Off by default: u_var' and v_var' differ by <1% on
    # EuRoC and the isotropic path saves carrying the projected v-row
    # coefficients through the row stack. The GATE stays isotropic u_var'
    # either way (msckf.h:1114 uses u_var_prime only).
    use_anisotropic_r: bool = False
    # NOTE: the reference loader stores the "keyframe_transl_dist" launch key
    # into redundancy_angle_thresh and "keyframe_rot_dist" into
    # redundancy_distance_thresh (asl_msckf.cpp:112-113) — the fields above
    # hold the post-load values, so the in-filter use needs no swap. Config
    # loaders reading launch-style keys must reproduce that crossed mapping.


@dataclass(frozen=True)
class ShapeConfig:
    """Static shape caps (the TPU-native replacement for dynamic std::vectors).

    The window may transiently exceed ``max_cam_states`` in the reference (long
    live tracks pin their states), so ``num_slots`` adds headroom. Track
    observations are indexed *by window slot*: the reference maintains the
    invariant that live track observations always refer to live camera states
    (obs are erased whenever their state is pruned, msckf.h:482-534, 685-761),
    which bounds per-track observations by the window size.
    """

    num_slots: int = 28            # camera-state window slots (max_cam_states + headroom)
    max_tracks: int = 128          # live feature-track rows
    max_staged: int = 16           # tracks residualized per frame step
    #   (was 32; measured per-frame track deaths on the EuRoC-scale world:
    #   mean 0.9, max 4 — 16 keeps 4x burst headroom for real data (texture
    #   boundaries can kill many tracks at once) and diag.staged_overflow
    #   counts anything beyond it. finish() force-residualizes in
    #   ⌈max_tracks/max_staged⌉ passes either way.)
    max_staged_prune: int = 48     # candidate buffer of the redundant-prune update
    #   (was 64; the round-3 TPU trace showed the prune path's 64-candidate
    #   triangulation + row sweep dominating the frame step. Overflowing
    #   candidates are dropped and counted in diag.staged_overflow — 48 drops
    #   ~0 on the EuRoC-scale synthetic world where 32 dropped ~5/frame.)
    max_update_rows: int = 192     # row budget of the stacked EKF update
    #   (was 384; ~0.9 tracks residualize per frame => typical stacked rows
    #   ~10-20, and the (R_MAX x R_MAX) cholesky was 16% of device time on
    #   the round-3 trace. 192 keeps diag.row_overflow at exactly 0 on the
    #   synthetic e2e (128 dropped 85 rows); core/filter.finish raises the
    #   budget to the worst case for its force-residualize loop.)
    max_tri_prune: int = 16        # prune candidates LM-triangulated per frame
    #   (candidates with a cached triangulation skip LM entirely — the
    #   reference caches too, msckf.h:488-531; measured un-initialized
    #   candidates: mean 1.4, p90 4. The once-per-sequence first-prune burst
    #   beyond 16 drops those candidates' one-last-updates, counted in
    #   diag.staged_overflow.)
    marg_obs_cap: int = 0          # obs-width cap of the marginalize row math
    prune_obs_cap: int = 0         # obs-width cap of the prune-path row math
    #   (0 = exact/uncapped. The row machinery pays (2M-3) rows per staged
    #   track with M = min(cap, num_slots); tracks with more observations
    #   than the cap lose the excess rows, counted in diag.row_overflow.
    #   MEASURED distributions on the bench world (tools/measure_row_stats.py,
    #   256x200): prune candidates carry exactly 2 involved obs at p99.9
    #   (redundant-slot selections are <=2/frame) while paying the full
    #   53-row buffer — the largest block of the round-4 step; marginalized
    #   tracks carry ~20 obs (p99.9 = 21 of num_slots=28). The serving
    #   config (bench.py) sets prune 6 / marg 22; parity configs keep 0.)
    staged_chunk: int = 8          # staged tracks per gated_row_stack scan step
    #   (bounds peak HBM of the dense per-track Jacobians: ~C·(2N-3)·D floats
    #   per filter instead of S·(2N-3)·D; 8 keeps batch-1024 under ~2 GB)
    prune_chunk: int = 0           # prune-side gated_row_stack chunk override
    #   (0 = use staged_chunk. With prune_obs_cap active each prune candidate
    #   pays only 2·cap-3 buffer rows instead of 2N-3, so the prune call can
    #   run ~R-ratio larger chunks at the SAME peak HBM — at cap 6 that is
    #   53/9 ≈ 6x, letting the 48-candidate prune sweep run in ONE scan step
    #   instead of six. The frame step is latency-bound (PROF_STAGES.txt:
    #   0.6% MFU, 11% HBM BW), so sequential chunk steps are what cost.)
    max_features_per_frame: int = 64   # front-end features ingested per frame
    imu_per_frame: int = 10        # IMU samples between camera frames (200/20 Hz)

    @property
    def state_dim(self) -> int:
        return 15 + 6 * self.num_slots


@dataclass(frozen=True)
class MsckfConfig:
    camera: CameraConfig = CameraConfig()
    noise: NoiseConfig = NoiseConfig()
    filter: FilterConfig = FilterConfig()
    shapes: ShapeConfig = ShapeConfig()

    # ---- derived parameters (explicit derivation stage) ----

    @property
    def u_var_prime(self) -> float:
        return (self.noise.feature_cov_px / self.camera.f_u) ** 2

    @property
    def v_var_prime(self) -> float:
        return (self.noise.feature_cov_px / self.camera.f_v) ** 2

    @property
    def max_gn_cost_norm(self) -> float:
        return (self.filter.max_gn_cost_norm_px / self.camera.f_u) ** 2

    @property
    def redundancy_angle(self) -> float:
        return self.filter.redundancy_angle_thresh

    @property
    def redundancy_distance(self) -> float:
        return self.filter.redundancy_distance_thresh

    def q_imu_diag(self):
        n = self.noise
        return [n.w_var] * 3 + [n.dbg_var] * 3 + [n.a_var] * 3 + [n.dba_var] * 3

    def initial_imu_covar_diag(self):
        n = self.noise
        return (
            [n.q_var_init] * 3
            + [n.bg_var_init] * 3
            + [n.v_var_init] * 3
            + [n.ba_var_init] * 3
            + [n.p_var_init] * 3
        )

    def replace(self, **kw) -> "MsckfConfig":
        return dataclasses.replace(self, **kw)


EUROC_CONFIG = MsckfConfig(
    filter=FilterConfig(max_cam_states=20),
    shapes=ShapeConfig(num_slots=28),
)


def serving_config(batch: int) -> MsckfConfig:
    """``bench.py:117-164``'s serving configuration for a fleet of ``batch``
    filters: one fused marginalize + prune update a frame, the gate's "high"
    tier, ``max_staged`` 8, observation caps 2 / 22, and the row-pipeline
    chunks sized to the batch."""
    cfg = MsckfConfig()
    pchunk = 48 if batch <= 1024 else {2048: 24, 4096: 12}.get(batch, 6)
    return dataclasses.replace(
        cfg,
        filter=dataclasses.replace(cfg.filter, fused_updates=True, gating_precision="high"),
        shapes=dataclasses.replace(cfg.shapes, staged_chunk=max(2, 8192 // batch),
                                   max_staged=8, prune_obs_cap=2, marg_obs_cap=22,
                                   prune_chunk=pchunk),
    )
