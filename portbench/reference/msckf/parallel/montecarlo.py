"""Monte-Carlo fleet construction (port of ``msckf_mono_tpu/parallel/montecarlo.py``).

The batched-filter axis is fed by perturbing the initial IMU state and
biases; each perturbation is an independent filter sharing the same sensor
stream. The perturbations are the JAX package's own draws: ``jax.random``'s
threefry2x32 normals from a key (``utils/prng``), drawn on the CPU in the
fleet's dtype and then moved to the fleet's device, so a key gives the same
fleet on every device and filter i's start does not depend on the fleet
size. :func:`make_grid_fleet` adds a per-filter noise-parameter grid on top.
"""

from __future__ import annotations

import torch

from portbench.reference.msckf.core.types import FilterState, ImuState, init_filter_state
from portbench.reference.msckf.utils import prng, quat
from portbench.reference.msckf.utils.config import MsckfConfig


def perturb_imu_state(
    imu: ImuState,
    key,
    n: int,
    sigma_p: float = 0.0,
    sigma_v: float = 0.05,
    sigma_theta: float = 0.005,
    sigma_bg: float = 1e-3,
    sigma_ba: float = 1e-2,
) -> ImuState:
    """n perturbed copies of a one-filter ``imu`` (batch 1) -> batch n;
    ``key`` is a ``prng`` key."""
    dtype = imu.p_I_G.dtype
    dev = imu.p_I_G.device
    keys = prng.split(torch.as_tensor(key, device="cpu"), 5)

    def noise(k, sigma):
        return (prng.normal(k, (n, 3), dtype) * sigma).to(dev)

    def b(x):
        return x.expand((n,) + tuple(x.shape[1:]))

    dp, dv, dth, dbg, dba = (noise(k, s) for k, s in
                             zip(keys, (sigma_p, sigma_v, sigma_theta, sigma_bg, sigma_ba)))
    dq = quat.build_update_quat(dth)
    q = quat.mul(dq, b(imu.q_IG))
    v = b(imu.v_I_G) + dv
    p = b(imu.p_I_G) + dp
    return ImuState(
        q_IG=q, b_g=b(imu.b_g) + dbg, v_I_G=v, b_a=b(imu.b_a) + dba, p_I_G=p,
        g=b(imu.g).clone(), q_IG_null=q, v_I_G_null=v, p_I_G_null=p,
    )


def make_fleet(config: MsckfConfig, imu: ImuState, n: int, key=None,
               dtype=torch.float32, device="cuda", **sigmas) -> FilterState:
    """n independent filter instances with perturbed inits, on ``device``;
    ``key=None`` is ``prng.PRNGKey(0)``, the JAX package's default."""
    if key is None:
        key = prng.PRNGKey(0)
    imu = type(imu)(**{k: v.to(device=device, dtype=dtype) for k, v in vars(imu).items()})
    return init_filter_state(config, perturb_imu_state(imu, key, n, **sigmas),
                             dtype=dtype, device=device)


def make_grid_fleet(config: MsckfConfig, imu: ImuState, n: int, key=None,
                    dtype=torch.float32, device="cuda", q_imu_scale=None,
                    meas_sigma_px=None, **sigmas) -> FilterState:
    """A fleet spanning a noise-parameter grid on top of the Monte-Carlo
    init perturbations.

    The noise parameters live in the state (``q_imu_diag``, ``meas_sigma2``),
    so each filter of the batch integrates and updates with its own.
    q_imu_scale: (n,) multiplies the config's Q_imu diagonal per filter.
    meas_sigma_px: (n,) per-filter feature-noise sigma in pixels, converted
    by (px / f_u)² (ros_interface.cpp:313-314).
    """
    fleet = make_fleet(config, imu, n, key, dtype=dtype, device=device, **sigmas)
    if q_imu_scale is not None:
        scale = torch.as_tensor(q_imu_scale, dtype=dtype, device=device)[:, None]
        fleet = fleet.replace(q_imu_diag=fleet.q_imu_diag * scale)
    if meas_sigma_px is not None:
        px = torch.as_tensor(meas_sigma_px, dtype=dtype, device=device)
        fleet = fleet.replace(meas_sigma2=(px / config.camera.f_u) ** 2)
    return fleet


def broadcast_frames(frames, n: int):
    """Share one (T, ...) frame stack across n filters -> (T, n, ...) views (no copy)."""
    from portbench.reference.msckf.core.types import tree_map

    return tree_map(lambda x: x[:, None].expand((x.shape[0], n) + tuple(x.shape[1:])), frames)
