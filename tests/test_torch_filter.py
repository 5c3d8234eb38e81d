"""The port's slice as a whole: run_sequence against the JAX package.

* f64, strict reference ordering: positions within 1e-6 m and every
  Diagnostics counter equal;
* f32, the serving configuration (fused updates, observation caps, chunking):
  positions within 2e-5 m and every counter equal;

on the tiny shapes of __graft_entry__._tiny_config() and on a 22-slot variant
in which the 20-state redundant prune runs. Plus the state carried across
mid-sequence, fleets, padded frames and the entry points' default device.

``make_fleet`` draws the JAX package's fleet: against JAX's ``make_fleet``
(key 0) at n in {1, 3, 1024}, every ImuState field within 4·eps of each
vector's largest component (f32; the normals' ``log1p`` is torch's) or
1e-12 (f64), and filter i is bit-equal at n = 3 and n = 1024.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import filter as jfilter
from msckf_mono_tpu.core.init import ground_truth_init as j_gt_init
from msckf_mono_tpu.core.types import init_filter_state as j_init_state
from msckf_mono_tpu.data import synthetic as jsyn
from msckf_mono_tpu.parallel import montecarlo as jmc
from msckf_mono_tpu.parallel import sharding as jsharding
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import init as tinit
from msckf_mono_tpu_torch.core import types as ttypes
from msckf_mono_tpu_torch.core.types import filter_state_from_numpy, filter_state_to_numpy
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.parallel import sharding as tsharding
from msckf_mono_tpu_torch.frontend.track_handler import TrackHandler
from msckf_mono_tpu_torch.interface import LiveFrame, VioInterface
from msckf_mono_tpu_torch.utils import prng

from tests import _torch_port as tp

N_FRAMES = 30
POS_TOL = {jnp.float64: 1e-6, jnp.float32: 2e-5}


def _case_configs(world, serving):
    if world == "tiny":
        f, s = dict(tp.TINY_FILTER, max_track_length=6), dict(tp.TINY_SHAPES)
        serving_shapes = dict(prune_obs_cap=2, marg_obs_cap=6, prune_chunk=8, staged_chunk=2)
    else:
        f, s = dict(tp.SMALL_FILTER), dict(tp.SMALL_SHAPES)
        serving_shapes = dict(tp.SERVING_SHAPES)
    f["fused_updates"] = serving
    if serving:
        f.update(tp.SERVING_FILTER)
        s.update(serving_shapes)
    return tp.configs(f, s)


def _jax_run(jc, seq, dtype, n_frames=None, state=None):
    if state is None:
        imu = j_gt_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=dtype)
        state = j_init_state(jc, imu, dtype=dtype)
    frames = jsyn.to_frame_inputs(seq, dtype)
    if n_frames is not None:
        frames = jax.tree_util.tree_map(lambda x: x[n_frames[0]:n_frames[1]], frames)
    return jax.jit(lambda s, f: jfilter.run_sequence(s, f, jc))(state, frames)


def _seq(jc, tc, n=N_FRAMES):
    jseq = jsyn.generate(jc, n_frames=n, seed=3, pixel_noise=0.5)
    tseq = tsyn.generate(tc, n_frames=n, seed=3, pixel_noise=0.5)
    np.testing.assert_array_equal(jseq.tracked_uv, tseq.tracked_uv)
    np.testing.assert_array_equal(jseq.imu_acc, tseq.imu_acc)
    return jseq, tseq


@pytest.mark.parametrize("world", ["tiny", "small"])
@pytest.mark.parametrize("dtype,serving", [(jnp.float64, False), (jnp.float32, True)],
                         ids=["f64-strict", "f32-serving"])
def test_run_sequence_matches_jax(world, dtype, serving):
    jc, tc = _case_configs(world, serving)
    jseq, tseq = _seq(jc, tc)
    j_final, j_outs = _jax_run(jc, jseq, dtype)
    tdt = tp.tdtype(dtype)
    t_final, t_outs = tfilter.run_sequence(tp.port_initial_state(tc, tseq, tdt), tp.port_frames(tseq, tdt), tc)

    tol = POS_TOL[dtype]
    np.testing.assert_allclose(t_outs.p_I_G[:, 0].numpy(), np.asarray(j_outs.p_I_G), rtol=0, atol=tol)
    np.testing.assert_allclose(t_outs.v_I_G[:, 0].numpy(), np.asarray(j_outs.v_I_G), rtol=0, atol=10 * tol)
    np.testing.assert_allclose(t_outs.q_IG[:, 0].numpy(), np.asarray(j_outs.q_IG), rtol=0, atol=tol)
    np.testing.assert_array_equal(t_outs.cam_count[:, 0].numpy(), np.asarray(j_outs.cam_count))
    np.testing.assert_array_equal(t_outs.num_residualized[:, 0].numpy(), np.asarray(j_outs.num_residualized))
    for k, v in vars(j_final.diag).items():
        assert int(getattr(t_final.diag, k)[0]) == int(v), k
    # the vision path really ran
    assert int(t_final.num_residualized[0]) > 0
    assert int(t_final.diag.updates_applied[0]) > 0
    assert np.all(np.isfinite(t_outs.p_I_G.numpy()))


@pytest.fixture(scope="module")
def small_f64():
    jc, tc = tp.small_configs()
    jseq, tseq = _seq(jc, tc, 36)
    return jc, tc, jseq, tseq


def test_mid_sequence_state_carries_across_exactly(small_f64):
    """A JAX state after 22 frames round-trips through the port unchanged, and
    the port continues from it as the JAX package does."""
    jc, tc, jseq, tseq = small_f64
    j_mid, _ = _jax_run(jc, jseq, jnp.float64, (0, 22))
    arrays = tp.jax_to_dict(j_mid, batched=False)
    back = filter_state_to_numpy(filter_state_from_numpy(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)

    j_end, j_outs = _jax_run(jc, jseq, jnp.float64, (22, 36), state=j_mid)
    frames = ttypes.tree_map(lambda x: x[22:36], tp.port_frames(tseq))
    t_end, t_outs = tfilter.run_sequence(tp.port_state(arrays), frames, tc)
    np.testing.assert_allclose(t_outs.p_I_G[:, 0].numpy(), np.asarray(j_outs.p_I_G), rtol=0, atol=1e-6)
    for k, v in vars(j_end.diag).items():
        assert int(getattr(t_end.diag, k)[0]) == int(v), k


def test_fleet_runs_each_filter_independently(small_f64):
    _, tc, _, tseq = small_f64
    imu = tinit.ground_truth_init(**tp.INIT, b_g=tseq.b_g, b_a=tseq.b_a, dtype=torch.float64, device="cpu")
    fleet = tmc.make_fleet(tc, imu, 3, prng.PRNGKey(7), dtype=torch.float64, device="cpu")
    again = tmc.make_fleet(tc, imu, 3, prng.PRNGKey(7), dtype=torch.float64, device="cpu")
    assert torch.equal(fleet.imu.q_IG, again.imu.q_IG) and torch.equal(fleet.imu.v_I_G, again.imu.v_I_G)
    assert not torch.equal(fleet.imu.v_I_G[0], fleet.imu.v_I_G[1])
    frames = ttypes.tree_map(lambda x: x[:16], tsyn.to_frame_inputs(tseq, torch.float64, device="cpu"))
    run = tsharding.batched_run_sequence(tc)
    final, outs = run(fleet, tmc.broadcast_frames(frames, 3))
    assert outs.p_I_G.shape == (16, 3, 3)
    for b in (0, 2):
        one = ttypes.tree_map(lambda x: x[b:b + 1], fleet)
        f1, o1 = run(one, tmc.broadcast_frames(frames, 1))
        np.testing.assert_allclose(o1.p_I_G[:, 0].numpy(), outs.p_I_G[:, b].numpy(), rtol=0, atol=1e-9)
        assert int(f1.num_residualized[0]) == int(final.num_residualized[b])

    got = tsharding.fleet_metrics(final)
    want = jsharding.fleet_metrics(tp.jax_state(filter_state_to_numpy(final), jc_for(tc), jnp.float64))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("n", [1, 3, 1024])
@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64])
def test_make_fleet_matches_jax(small_f64, jdtype, n):
    jc, tc, jseq, tseq = small_f64
    want = jmc.make_fleet(jc, j_gt_init(**tp.INIT, b_g=jseq.b_g, b_a=jseq.b_a, dtype=jdtype), n,
                          dtype=jdtype).imu
    imu = tinit.ground_truth_init(**tp.INIT, b_g=tseq.b_g, b_a=tseq.b_a, dtype=tp.tdtype(jdtype),
                                  device="cpu")
    got = tmc.make_fleet(tc, imu, n, dtype=tp.tdtype(jdtype), device="cpu").imu
    eps = float(jnp.finfo(jdtype).eps)
    for k, w in vars(want).items():
        g, w = getattr(got, k).numpy().astype(np.float64), np.asarray(w).astype(np.float64)
        assert g.shape == w.shape, k
        if jdtype == jnp.float32:
            assert np.all(np.abs(g - w) <= 4 * eps * np.maximum(np.abs(w), np.abs(w).max(-1, keepdims=True))), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=k)
    if n == 1024:       # filter i does not depend on the fleet size
        three = tmc.make_fleet(tc, imu, 3, dtype=tp.tdtype(jdtype), device="cpu").imu
        for k, v in vars(three).items():
            assert torch.equal(v, getattr(got, k)[:3]), k


def jc_for(tc):
    return tp.configs({f: getattr(tc.filter, f) for f in ("max_cam_states", "min_track_length",
                                                           "max_track_length")},
                      dict(tp.SMALL_SHAPES))[0]


def test_padded_frame_leaves_state_untouched(small_f64):
    _, tc, _, tseq = small_f64
    frames = tp.port_frames(tseq)
    state = tp.port_initial_state(tc, tseq)
    for t in range(12):
        state, _ = tfilter.step(state, tfilter.frame_at(frames, t), tc)
    frame = tfilter.frame_at(frames, 12)
    frame = frame.replace(frame_valid=torch.zeros_like(frame.frame_valid))
    after, out = tfilter.step(state, frame, tc)
    want = filter_state_to_numpy(tfilter.prune.clear_frame_archive(state))
    got = filter_state_to_numpy(after)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(out.p_I_G, state.imu.p_I_G)


@pytest.mark.parametrize("fn", [ttypes.init_imu_state, ttypes.init_filter_state, tinit.ground_truth_init,
                                tinit.standstill_init, tmc.make_fleet, tsyn.to_frame_inputs,
                                tmc.make_grid_fleet, VioInterface, TrackHandler, LiveFrame])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
