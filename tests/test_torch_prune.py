"""Port window pruning (core/prune.py) against the JAX package (f64).

States come from the default-size synthetic world once its window has reached
the 20 states at which redundant pruning runs (msckf.h:455), taken right
after the frame's augmentation, as the step prunes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import prune as jprune
from msckf_mono_tpu_torch.core import augment as taug
from msckf_mono_tpu_torch.core import prune as tprune
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy

from tests import _torch_port as tp

JC, TC = tp.configs()
AT = (24, 37)


@pytest.fixture(scope="module")
def arrays():
    _, frames, snaps = tp.port_snapshots(TC, 38, at=set(AT))
    out = []
    for t in AT:
        f = tp.frame_arrays(frames, t)
        st = taug.augment_state(tp.port_state(snaps[t]), torch.as_tensor(f["state_id"]),
                                torch.as_tensor(f["time"]), TC)
        out.append(filter_state_to_numpy(st))
    return tp.stack_dicts(out)


def _assert_dicts(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _jstate(arrays):
    return tp.jax_state(arrays, JC, jnp.float64)


def test_find_redundant_slots_matches_jax(arrays):
    got = tprune.find_redundant_slots(tp.port_state(arrays), TC).numpy()
    want = np.asarray(jax.vmap(lambda s: jprune.find_redundant_slots(s, JC))(_jstate(arrays)))
    np.testing.assert_array_equal(got, want)
    assert got.sum(1).max() >= 2  # at least one filter prunes


def test_slot_features_archive_and_clear_match_jax(arrays):
    st, js = tp.port_state(arrays), _jstate(arrays)
    np.testing.assert_array_equal(tprune.slot_has_active_features(st).numpy(),
                                  np.asarray(jax.vmap(jprune.slot_has_active_features)(js)))
    rm = arrays["window.valid"] & (np.arange(arrays["window.valid"].shape[1]) % 3 == 1)
    # two appends into one frame's archive, as the two prune stages do
    got = tprune._archive_removed(tprune._archive_removed(st, torch.as_tensor(rm)),
                                  torch.as_tensor(rm & False | (np.arange(rm.shape[1]) == 0)))
    want = jax.vmap(lambda s, m: jprune._archive_removed(jprune._archive_removed(s, m), m & False | (jnp.arange(m.shape[0]) == 0)))(
        js, jnp.asarray(rm))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 0.0)
    _assert_dicts(filter_state_to_numpy(tprune.clear_frame_archive(got)),
                  tp.jax_to_dict(jax.vmap(jprune.clear_frame_archive)(want)), 0.0)


def test_prune_prep_and_post_match_jax(arrays):
    st, js = tp.port_state(arrays), _jstate(arrays)
    prep = tprune.prune_prep(st, TC)
    jprep = jax.vmap(lambda s: jprune.prune_prep(s, JC))(js)
    assert prep["rm"].numpy().any()
    for k, v in jprep.items():
        w = np.asarray(v)
        g = prep[k].numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)  # LM points
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    gate = torch.as_tensor(np.random.default_rng(0).random(prep["use_track"].shape) < 0.7)
    drop = torch.tensor([3, 0], dtype=torch.int32)
    got = tprune.prune_post(st, prep, gate, drop, TC)
    want = jax.vmap(lambda s, p, g, d: jprune.prune_post(s, p, g, d, JC))(
        js, jprep, jnp.asarray(gate.numpy()), jnp.asarray(drop.numpy()))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 1e-5)


def test_prune_redundant_states_matches_jax(arrays):
    got = tprune.prune_redundant_states(tp.port_state(arrays), TC)
    want = jax.vmap(lambda s: jprune.prune_redundant_states(s, JC))(_jstate(arrays))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 1e-7)
    assert (got.window.count.numpy() < arrays["window.valid"].sum(1)).any()


@pytest.mark.parametrize("max_cam_states", [20, 12])
def test_prune_empty_states_matches_jax(arrays, max_cam_states):
    jc, tc = tp.configs(dict(max_cam_states=max_cam_states))
    a = dict(arrays)
    # empty the oldest slots' observations so there is a leading run to prune
    mask = a["tracks.obs_mask"].copy()
    mask[:, :, :4] = False
    a["tracks.obs_mask"] = mask
    got = tprune.prune_empty_states(tp.port_state(a), tc)
    want = jax.vmap(lambda s: jprune.prune_empty_states(s, jc))(tp.jax_state(a, jc, jnp.float64))
    _assert_dicts(filter_state_to_numpy(got), tp.jax_to_dict(want), 0.0)
    assert (got.window.count.numpy() < a["window.valid"].sum(1)).any()
