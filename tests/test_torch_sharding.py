"""The port's sharded fleet (parallel/sharding.py) on the CPU, against its own
unsharded run and the JAX package's ``make_sharded_run``.

As tests/test_sharding.py does for JAX, over a CPU mesh (``make_mesh(["cpu"]
* 8)``, the counterpart of conftest's 8 virtual CPU devices), at the small
shapes:

* the 8-shard run equals the unsharded run bit for bit (every state leaf and
  every output);
* against JAX's ``make_sharded_run`` on the 8 virtual devices, from the same
  JAX ``make_fleet`` states: f64 positions within 1e-6 m with every counter
  equal; f32 within the JAX test's 2e-2 m (positions) and 1e-4 (P);
* ``fleet_metrics`` with a mesh against numpy on the gathered state, and
  through a one-rank gloo group;
* mesh sizes 1, 2 and 8 agree on the metrics;
* two equal shards on one device (one cached graph) run back to back equal
  two separate runs, and stepping them in turn raises;
* a batch that does not divide into the shards raises.
"""

import datetime
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from msckf_mono_tpu.core.init import ground_truth_init as j_gt_init
from msckf_mono_tpu.data import synthetic as jsyn
from msckf_mono_tpu.parallel import montecarlo as jmc
from msckf_mono_tpu.parallel import sharding as jsharding
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy, tree_map
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.parallel import sharding

from tests import _torch_port as tp

BATCH = 16
FRAMES = 10
JC, TC = tp.small_configs()
COUNTERS = ("total_residualized", "total_row_overflow", "total_staged_overflow")


def _seq():
    return tp.sequence(TC, FRAMES, seed=0)


@pytest.fixture(scope="module")
def fleet():
    """A port fleet (f32) and its broadcast frames."""
    seq = _seq()
    states = tmc.make_fleet(TC, tp.port_initial_state(TC, seq, torch.float32).imu, BATCH,
                            dtype=torch.float32, device="cpu")
    return states, tp.port_frames(seq, torch.float32, BATCH)


@pytest.fixture(scope="module")
def unsharded(fleet):
    states, frames = fleet
    return sharding.batched_run_sequence(TC)(states, frames)


def _np(state):
    return filter_state_to_numpy(state)


def test_sharded_matches_unsharded_bitwise(fleet, unsharded):
    states, frames = fleet
    mesh = sharding.make_mesh(["cpu"] * 8)
    final, outs, metrics = sharding.make_sharded_run(TC, mesh)(sharding.shard_batch(states, mesh),
                                                               frames)
    assert len(final.shards) == 8 and all(s.P.shape[0] == BATCH // 8 for s in final.shards)
    want, got = _np(unsharded[0]), _np(final.gather())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in vars(unsharded[1]).items():
        assert torch.equal(getattr(outs.gather(), k), v), k
    assert int(metrics["total_residualized"]) > 0


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's make_sharded_run on conftest's 8 virtual devices, f64 and f32, from
    JAX make_fleet states (the port starts from the same states)."""
    assert jax.device_count() == 8
    seq = jsyn.generate(JC, n_frames=FRAMES, seed=0, pixel_noise=0.5)
    mesh = jsharding.make_mesh()
    run = jsharding.make_sharded_run(JC, mesh)
    out = {}
    for dtype in (jnp.float64, jnp.float32):
        imu = j_gt_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=dtype)
        states = jmc.make_fleet(JC, imu, BATCH, dtype=dtype)
        final, outs, metrics = run(jsharding.shard_batch(states, mesh),
                                   jmc.broadcast_frames(jsyn.to_frame_inputs(seq, dtype), BATCH))
        out[dtype] = (tp.jax_to_dict(states), final, outs, metrics)
    return out


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_sharded_matches_jax(jax_sharded, dtype):
    arrays, j_final, j_outs, j_metrics = jax_sharded[dtype]
    tdt = tp.tdtype(dtype)
    mesh = sharding.make_mesh(["cpu"] * 8)
    final, outs, metrics = sharding.make_sharded_run(TC, mesh)(
        sharding.shard_batch(tp.port_state(arrays), mesh),
        tp.port_frames(_seq(), tdt, BATCH))
    final, outs = final.gather(), outs.gather()
    pos_tol, p_tol = (1e-6, 1e-6) if dtype == jnp.float64 else (2e-2, 1e-4)
    np.testing.assert_allclose(outs.p_I_G.numpy(), np.asarray(j_outs.p_I_G), rtol=0, atol=pos_tol)
    np.testing.assert_allclose(final.P.numpy(), np.asarray(j_final.P), rtol=0, atol=p_tol)
    if dtype == jnp.float64:
        for k, v in vars(j_final.diag).items():
            np.testing.assert_array_equal(getattr(final.diag, k).numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(final.num_residualized.numpy(),
                                      np.asarray(j_final.num_residualized))
        for k in COUNTERS:
            assert int(metrics[k]) == int(j_metrics[k]), k
    assert int(metrics["total_residualized"]) > 0


def _numpy_metrics(state):
    s = _np(state)
    tr = np.trace(s["P"][:, 12:15, 12:15], axis1=1, axis2=2).astype(np.float64)
    return {
        "mean_pos_cov_trace": tr.mean(), "max_pos_cov_trace": tr.max(),
        "mean_cam_count": s["window.valid"].sum(-1).mean(),
        "total_residualized": s["num_residualized"].sum(),
        "total_row_overflow": s["diag.row_overflow"].sum(),
        "total_staged_overflow": s["diag.staged_overflow"].sum(),
    }


def _assert_metrics(got, want):
    for k, v in want.items():
        if k.startswith("total"):
            assert int(got[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)


def test_fleet_metrics_with_mesh_matches_numpy(unsharded):
    final = unsharded[0]
    mesh = sharding.make_mesh(["cpu"] * 4)
    got = sharding.fleet_metrics(sharding.shard_batch(final, mesh))
    want = _numpy_metrics(final)
    _assert_metrics(got, want)
    unsharded_max = sharding.fleet_metrics(final)["max_pos_cov_trace"]
    assert float(got["max_pos_cov_trace"]) == float(unsharded_max)
    assert all(v.dim() == 0 for v in got.values())
    assert got["total_residualized"].dtype == torch.int64


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fleet_metrics_through_a_process_group(unsharded):
    """make_mesh picks up an initialized default group; the metrics go through
    gloo all-reduces and equal the group-free ones."""
    final = unsharded[0]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = sharding.make_mesh(["cpu"] * 2)
        assert mesh.group is not None and (mesh.rank, mesh.world_size, mesh.size) == (0, 1, 2)
        got = sharding.fleet_metrics(sharding.shard_batch(final, mesh))
    finally:
        dist.destroy_process_group()
    want = sharding.fleet_metrics(sharding.shard_batch(final, sharding.make_mesh(["cpu"] * 2)))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_sizes_agree_on_metrics(fleet, unsharded, n):
    states, frames = fleet
    mesh = sharding.make_mesh(["cpu"] * n)
    # a global state is sharded by the runner
    final, _, metrics = sharding.make_sharded_run(TC, mesh)(states, frames)
    assert len(final.shards) == n
    _assert_metrics(metrics, _numpy_metrics(unsharded[0]))


def test_two_shards_on_one_device_back_to_back(fleet):
    """Two equal shards on one device share one cached graph: run one after
    the other they equal two separate runs of the halves."""
    states, frames = fleet
    mesh = sharding.make_mesh(["cpu", "cpu"])
    final, outs, _ = sharding.make_sharded_run(TC, mesh)(states, frames)
    half = BATCH // 2
    for i, sl in enumerate((slice(0, half), slice(half, BATCH))):
        s, o = tfilter.run_sequence(
            tp.port_state({k: v[sl] for k, v in _np(states).items()}),
            tree_map(lambda x: x[:, sl], frames), TC)
        want, got = _np(s), _np(final.shards[i])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"shard {i} {k}")
        assert torch.equal(outs.shards[i].p_I_G, o.p_I_G)
    two = sharding.shard_batch(states, mesh)
    with pytest.raises(ValueError, match="one device"):
        cuda_graph.scans(tfilter.step, two.shards, [frames, frames], (TC,))


def test_shard_batch_gather_replicate_and_divisibility(fleet):
    states, frames = fleet
    mesh = sharding.make_mesh(["cpu"] * 4)
    sh = sharding.shard_batch(states, mesh)
    assert sh.mesh is mesh and list(mesh.shard_ids) == [0, 1, 2, 3]
    want, got = _np(states), _np(sh.gather())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(sh.shards[1].imu.p_I_G.numpy(), want["imu.p_I_G"][4:8])
    fsh = sharding._split(frames, mesh, 1)
    assert fsh.shards[2].imu_dt.shape[:2] == (FRAMES, BATCH // 4)
    copies = sharding.replicate(states, mesh)
    assert len(copies) == 4 and all(torch.equal(c.P, states.P) for c in copies)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch(states, sharding.make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="does not split"):
        sharding.make_sharded_run(TC, sharding.make_mesh(["cpu"] * 5))(states, frames)


def test_make_mesh_defaults_to_the_card():
    """Without CUDA the default mesh raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh is its devices")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()
    mesh = sharding.make_mesh(["cpu"])
    assert (mesh.group, mesh.rank, mesh.world_size, mesh.size) == (None, 0, 1, 1)
    assert sharding.FILTER_AXIS == jsharding.FILTER_AXIS
