"""Port IMU propagation (core/propagate.py) against the JAX package (f64, 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import propagate as jprop
from msckf_mono_tpu.core.types import ImuState as JImu
from msckf_mono_tpu_torch.core import propagate as tprop
from msckf_mono_tpu_torch.core.types import ImuState as TImu
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy

from tests import _torch_port as tp

TOL = 1e-10
JC, TC = tp.small_configs()


@pytest.fixture(scope="module")
def snaps():
    _, frames, snaps = tp.port_snapshots(TC, 30, at={0, 12, 27})
    return frames, snaps


def _imu_pair(rng, B):
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f = {"q_IG": q, "q_IG_null": q}
    for k in ("b_g", "v_I_G", "b_a", "p_I_G", "v_I_G_null", "p_I_G_null"):
        f[k] = rng.normal(size=(B, 3)) * 0.1
    f["g"] = np.tile([0.0, 0.0, -9.81], (B, 1))
    return JImu(**{k: jnp.asarray(v) for k, v in f.items()}), TImu(**{k: torch.as_tensor(v) for k, v in f.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _imu_close(t, j, tol=TOL):
    for k in vars(t):
        _close(getattr(t, k), getattr(j, k), tol)


def test_calc_F_G_and_state_integration_match_jax():
    rng = np.random.default_rng(0)
    jimu, timu = _imu_pair(rng, 3)
    omega, acc = rng.normal(size=(3, 3)), rng.normal(size=(3, 3)) + [0, 0, 9.81]
    dt = np.full((3,), 0.005)
    _close(tprop.calc_F(timu, torch.as_tensor(omega), torch.as_tensor(acc)),
           jax.vmap(jprop.calc_F)(jimu, jnp.asarray(omega), jnp.asarray(acc)))
    _close(tprop.calc_G(timu, torch.float64),
           jax.vmap(lambda i: jprop.calc_G(i, jnp.float64))(jimu))
    t_prop = tprop.propagate_imu_state(timu, torch.as_tensor(omega), torch.as_tensor(acc),
                                       torch.as_tensor(dt))
    j_prop = jax.vmap(jprop.propagate_imu_state)(jimu, jnp.asarray(omega), jnp.asarray(acc),
                                                 jnp.asarray(dt))
    _imu_close(t_prop, j_prop)
    F = tprop.calc_F(timu, torch.as_tensor(omega), torch.as_tensor(acc))
    _close(tprop.compute_phi(timu, t_prop, F, torch.as_tensor(dt)),
           jax.vmap(jprop.compute_phi)(jimu, j_prop, jnp.asarray(F.numpy()), jnp.asarray(dt)))


def _inputs(frames, t, K_pad=0):
    f = tp.frame_arrays(frames, t)
    om, ac, dt = f["imu_omega"], f["imu_acc"], f["imu_dt"]
    if K_pad:
        om = np.concatenate([om, np.zeros(om.shape[:1] + (K_pad, 3))], axis=1)
        ac = np.concatenate([ac, np.zeros(ac.shape[:1] + (K_pad, 3))], axis=1)
        dt = np.concatenate([dt, np.zeros(dt.shape[:1] + (K_pad,))], axis=1)
    return om, ac, dt


def _run_both(arrays, om, ac, dt):
    B = arrays["P"].shape[0]
    om, ac, dt = (np.broadcast_to(x, (B,) + x.shape[1:]) for x in (om, ac, dt))
    got = tprop.propagate_block(tp.port_state(arrays), torch.as_tensor(om), torch.as_tensor(ac),
                                torch.as_tensor(dt), TC)
    want = jax.vmap(lambda s, o, a, d: jprop.propagate_block(s, o, a, d, JC))(
        tp.jax_state(arrays, JC, jnp.float64), jnp.asarray(om), jnp.asarray(ac), jnp.asarray(dt))
    return filter_state_to_numpy(got), tp.jax_to_dict(want)


@pytest.mark.parametrize("K_pad", [0, 3])
def test_propagate_block_matches_jax(snaps, K_pad):
    frames, s = snaps
    arrays = tp.stack_dicts([s[12], s[27]])
    got, want = _run_both(arrays, *_inputs(frames, 12, K_pad))
    for k in want:
        _close(got[k], want[k])


def test_propagate_block_zero_dt_padding_is_identity(snaps):
    frames, s = snaps
    arrays = s[27]
    plain, _ = _run_both(arrays, *_inputs(frames, 27))
    padded, _ = _run_both(arrays, *_inputs(frames, 27, K_pad=3))
    for k in plain:  # the padded samples only renormalize q (dt = 0)
        _close(padded[k], plain[k], 1e-12)
    # All-padding frame on a state whose null copies equal the state: unchanged.
    om, ac, dt = _inputs(frames, 27)
    got, _ = _run_both(s[0], om * 0, ac * 0, dt * 0)
    for k in ("P", "imu.q_IG", "imu.v_I_G", "imu.p_I_G"):
        np.testing.assert_array_equal(got[k], s[0][k], err_msg=k)


def test_propagate_block_equals_per_sample_propagate(snaps):
    """The composed update equals K single-sample propagate calls."""
    frames, s = snaps
    om, ac, dt = _inputs(frames, 12)
    state = tp.port_state(s[12])
    block = tprop.propagate_block(state, torch.as_tensor(om), torch.as_tensor(ac), torch.as_tensor(dt), TC)
    seq = state
    for k in range(dt.shape[1]):
        seq = tprop.propagate(seq, torch.as_tensor(om[:, k]), torch.as_tensor(ac[:, k]),
                              torch.as_tensor(dt[:, k]), TC)
    _close(block.P, seq.P, 1e-9)
    _imu_close(block.imu, seq.imu, 1e-12)


def test_single_propagate_matches_jax(snaps):
    frames, s = snaps
    om, ac, dt = (x[:, 0] for x in _inputs(frames, 12))
    got = tprop.propagate(tp.port_state(s[12]), torch.as_tensor(om), torch.as_tensor(ac),
                          torch.as_tensor(dt), TC)
    want = jax.vmap(lambda st, o, a, d: jprop.propagate(st, o, a, d, JC))(
        tp.jax_state(s[12], JC, jnp.float64), jnp.asarray(om), jnp.asarray(ac), jnp.asarray(dt))
    _close(got.P, want.P)
    _imu_close(got.imu, want.imu)
