"""Port state types, init, augmentation, window compaction and track bookkeeping
against the JAX package (f64; exact where no arithmetic is involved, else 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import augment as jaug
from msckf_mono_tpu.core import init as jinit
from msckf_mono_tpu.core import tracks as jtracks
from msckf_mono_tpu.core import window as jwin
from msckf_mono_tpu.core.types import init_filter_state as j_init_state
from msckf_mono_tpu_torch.core import augment as taug
from msckf_mono_tpu_torch.core import init as tinit
from msckf_mono_tpu_torch.core import tracks as ttracks
from msckf_mono_tpu_torch.core import window as twin
from msckf_mono_tpu_torch.core.types import (filter_state_from_numpy, filter_state_to_numpy,
                                             init_filter_state)

from tests import _torch_port as tp

TOL = 1e-10
JC, TC = tp.small_configs()


@pytest.fixture(scope="module")
def snaps():
    _, frames, snaps = tp.port_snapshots(TC, 40, at={0, 5, 21, 22, 33})
    return frames, snaps


def _assert_dicts(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_init_filter_state_matches_jax(dtype):
    seq = tp.sequence(TC, 2)
    kw = dict(tp.INIT, b_g=seq.b_g, b_a=seq.b_a)
    want = j_init_state(JC, jinit.ground_truth_init(**kw, dtype=dtype), dtype=dtype)
    got = init_filter_state(TC, tinit.ground_truth_init(**kw, dtype=tp.tdtype(dtype), device="cpu"),
                            dtype=tp.tdtype(dtype), device="cpu")
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want, batched=False), 0.0)


def test_standstill_init_matches_jax():
    rng = np.random.default_rng(0)
    omega = rng.normal(size=(40, 3)) * 0.01 + [0.002, -0.001, 0.0005]
    acc = rng.normal(size=(40, 3)) * 0.05 + [0.3, -0.2, 9.79]
    valid = np.arange(40) < 33
    want = jinit.standstill_init(jnp.asarray(omega), jnp.asarray(acc), jnp.asarray(valid),
                                 dtype=jnp.float64)
    got = tinit.standstill_init(omega, acc, valid, dtype=torch.float64, device="cpu")
    for k in vars(got):
        np.testing.assert_allclose(getattr(got, k).numpy()[0], np.asarray(getattr(want, k)),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_state_dict_round_trip_is_exact(snaps):
    _, s = snaps
    arrays = tp.stack_dicts([s[21], s[33]])
    back = filter_state_to_numpy(filter_state_from_numpy(arrays, device="cpu"))
    _assert_dicts(back, arrays, 0.0)
    jback = tp.jax_to_dict(tp.jax_state(arrays, JC, jnp.float64))
    _assert_dicts(jback, arrays, 0.0)


@pytest.mark.parametrize("at", [5, 22])
def test_augment_state_matches_jax(snaps, at):
    frames, s = snaps
    arrays = s[at]
    f = tp.frame_arrays(frames, at)
    got = taug.augment_state(tp.port_state(arrays), torch.as_tensor(f["state_id"]),
                             torch.as_tensor(f["time"]), TC)
    want = jax.vmap(lambda st, i, t: jaug.augment_state(st, i, t, JC))(
        tp.jax_state(arrays, JC, jnp.float64), jnp.asarray(f["state_id"]), jnp.asarray(f["time"]))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want))


def test_augment_state_full_window_drops_oldest(snaps):
    """A window with every slot in use takes the roll-left path (window_overflow)."""
    frames, s = snaps
    jc, tc = tp.configs(tp.SMALL_FILTER, dict(tp.SMALL_SHAPES, num_slots=22))
    arrays = dict(s[22])
    arrays["window.valid"] = np.ones_like(arrays["window.valid"])
    f = tp.frame_arrays(frames, 22)
    got = taug.augment_state(tp.port_state(arrays), torch.as_tensor(f["state_id"]),
                             torch.as_tensor(f["time"]), tc)
    want = jax.vmap(lambda st, i, t: jaug.augment_state(st, i, t, jc))(
        tp.jax_state(arrays, jc, jnp.float64), jnp.asarray(f["state_id"]), jnp.asarray(f["time"]))
    assert int(got.diag.window_overflow[0]) == int(arrays["diag.window_overflow"][0]) + 1
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want))


def test_compact_slots_matches_jax(snaps):
    _, s = snaps
    arrays = tp.stack_dicts([s[21], s[33]])
    rng = np.random.default_rng(5)
    keep = arrays["window.valid"] & (rng.random(arrays["window.valid"].shape) < 0.6)
    got = twin.compact_slots(tp.port_state(arrays), torch.as_tensor(keep))
    want = jax.vmap(jwin.compact_slots)(tp.jax_state(arrays, JC, jnp.float64), jnp.asarray(keep))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 0.0)


@pytest.mark.parametrize("at", [5, 22, 33])
def test_update_tracks_and_add_features_match_jax(snaps, at):
    frames, s = snaps
    f = tp.frame_arrays(frames, at)
    arrays = s[at]
    # tracks see the frame after augmentation, as in the step
    t_state = taug.augment_state(tp.port_state(arrays), torch.as_tensor(f["state_id"]),
                                 torch.as_tensor(f["time"]), TC)
    j_state = tp.jax_state(filter_state_to_numpy(t_state), JC, jnp.float64)

    t_new, t_staged = ttracks.update_tracks(t_state, torch.as_tensor(f["tracked_uv"]),
                                            torch.as_tensor(f["tracked_ids"]),
                                            torch.as_tensor(f["tracked_valid"]), TC)
    j_new, j_staged = jax.vmap(lambda st, uv, ids, v: jtracks.update_tracks(st, uv, ids, v, JC))(
        j_state, jnp.asarray(f["tracked_uv"]), jnp.asarray(f["tracked_ids"]),
        jnp.asarray(f["tracked_valid"]))
    _assert_dicts(filter_state_to_numpy(t_new), tp.jax_to_dict(j_new), 0.0)
    for k in vars(t_staged):
        np.testing.assert_array_equal(getattr(t_staged, k).numpy(), np.asarray(getattr(j_staged, k)))

    t_add = ttracks.add_features(t_new, torch.as_tensor(f["new_uv"]), torch.as_tensor(f["new_ids"]),
                                 torch.as_tensor(f["new_valid"]), TC)
    j_add = jax.vmap(lambda st, uv, ids, v: jtracks.add_features(st, uv, ids, v, JC))(
        j_new, jnp.asarray(f["new_uv"]), jnp.asarray(f["new_ids"]), jnp.asarray(f["new_valid"]))
    _assert_dicts(filter_state_to_numpy(t_add), tp.jax_to_dict(j_add), 0.0)


def test_add_features_overflow_and_duplicates_match_jax(snaps):
    """More new features than free rows, plus duplicate ids of live tracks."""
    frames, s = snaps
    arrays = s[33]
    f = tp.frame_arrays(frames, 33)
    live = arrays["tracks.feature_id"][0][arrays["tracks.active"][0]]
    F = 40
    ids = np.arange(1000, 1000 + F, dtype=np.int32)
    assert len(live) >= 1
    ids[:len(live[:3])] = live[:3]
    ids[5] = -1
    uv = np.random.default_rng(3).normal(size=(1, F, 2)) * 0.2
    valid = np.ones((1, F), bool)
    t_state = taug.augment_state(tp.port_state(arrays), torch.as_tensor(f["state_id"]),
                                 torch.as_tensor(f["time"]), TC)
    j_state = tp.jax_state(filter_state_to_numpy(t_state), JC, jnp.float64)
    got = ttracks.add_features(t_state, torch.as_tensor(uv), torch.as_tensor(ids[None]),
                               torch.as_tensor(valid), TC)
    want = jax.vmap(lambda st, u, i, v: jtracks.add_features(st, u, i, v, JC))(
        j_state, jnp.asarray(uv), jnp.asarray(ids[None]), jnp.asarray(valid))
    assert int(got.diag.track_overflow[0]) > 0
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 0.0)
