"""The port's counterpart of ``jax.jit`` and ``lax.scan`` (ops/cuda_graph.py) on the CPU.

On CPU tensors a ``StepGraph`` calls the captured function directly on its
static buffers, with the same copy-in, copy-back and aliasing rules the card
replays, so these tests check that logic here:

* the static-buffer runner equals the eager run (``cuda_graph.disabled()``)
  bit for bit: ``run_sequence`` (f64 strict and f32 serving, 2 filters),
  ``run_images`` with a shared camera (Bi = 1) and with Bi = B streams, and
  the live ``VioInterface`` frame loop with ``finish()``, two-point RANSAC
  off and on (its key in the graph's carry);
* a step whose new carry passes a field through, swaps two fields and
  returns a view of an input equals its eager loop;
* the port's ``batched_step`` and ``make_jitted_step`` against JAX's
  ``parallel/sharding.batched_step`` and ``frontend/functional.make_jitted_step``
  under ``jax.jit``: positions within 1e-6 m (f64) and 2e-5 m (f32), every
  counter equal; front-end ids and masks equal, uv within 1e-9 / 1e-4;
* the launch bookkeeping, with a stand-in counter: launches set apart are
  counted as a delta and restored, and warm-up moves no count and no input.

Tiny filter shapes (``__graft_entry__._tiny_config``), the 188 x 120 camera
of tests/test_torch_live.py for the image paths.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import filter as jfilter
from msckf_mono_tpu.frontend import functional as jfunc
from msckf_mono_tpu.parallel import sharding as jsharding
from msckf_mono_tpu_torch import interface as tint
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import pipeline as tpipe
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.parallel import sharding as tsharding
from msckf_mono_tpu_torch.utils import prng

from tests import _torch_port as tp
from tests.test_torch_live import SMALL_CAMERA, TH_KW, _drive, _live_configs, _world, small_configs

T = 10
FRONTEND = dict(max_features=16, window_size=21, max_level=3)
POS_TOL = {jnp.float64: 1e-6, jnp.float32: 2e-5}


def _equal_trees(a, b, tag):
    la, sa = cuda_graph.flatten(a)
    lb, sb = cuda_graph.flatten(b)
    assert sa == sb, tag
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{tag}: leaf {i}"


def _filter_configs(serving):
    f = dict(tp.TINY_FILTER, max_track_length=6, fused_updates=serving)
    s = dict(tp.TINY_SHAPES)
    if serving:
        f.update(tp.SERVING_FILTER)
        s.update(prune_obs_cap=2, marg_obs_cap=6, prune_chunk=8, staged_chunk=2)
    return tp.configs(f, s)


def _fleet(tc, seq, dtype, B=2):
    imu = ground_truth_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=dtype, device="cpu")
    return tmc.make_fleet(tc, imu, B, prng.PRNGKey(1), dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype,serving", [(torch.float64, False), (torch.float32, True)],
                         ids=["f64-strict", "f32-serving"])
def test_run_sequence_replay_equals_eager(dtype, serving):
    # the replay count below is this test's own: another test file in the same
    # worker may have replayed a graph of the same key
    cuda_graph.clear_cache()
    _, tc = _filter_configs(serving)
    seq = tp.sequence(tc, T)
    frames = tp.port_frames(seq, dtype, batch=2)
    got = tfilter.run_sequence(_fleet(tc, seq, dtype), frames, tc)
    again = tfilter.run_sequence(_fleet(tc, seq, dtype), frames, tc)
    with cuda_graph.disabled():
        want = tfilter.run_sequence(_fleet(tc, seq, dtype), frames, tc)
    _equal_trees(got, want, "run_sequence")
    _equal_trees(again, want, "run_sequence, the cached graph again")
    assert int(want[0].num_residualized.min()) > 0
    graph = cuda_graph.step_graph(tfilter.step, got[0], (tfilter.frame_at(frames, 0),), (tc,))
    assert graph.replays == 2 * T
    # finish through the static buffers, too
    fin = tfilter.finish(got[0], tc, collect_map=True)
    with cuda_graph.disabled():
        _equal_trees(fin, tfilter.finish(want[0], tc, collect_map=True), "finish")


@pytest.fixture(scope="module")
def small_world():
    _, tc = _live_configs()
    seq, imgs = _world(tc, T)
    return tc, seq, np.stack(imgs)


@pytest.mark.parametrize("shared", [True, False], ids=["Bi=1", "Bi=B"])
def test_run_images_replay_equals_eager(small_world, shared):
    tc, seq, imgs = small_world
    fcfg = tfunc.FrontendConfig(**FRONTEND)
    B, n = 2, 5
    H, W = imgs.shape[1:]

    def b(x, dtype=torch.float64):
        x = torch.as_tensor(np.asarray(x)[:n], dtype=dtype)
        return x[:, None].expand((n, B) + tuple(x.shape[1:]))

    image = torch.as_tensor(imgs[:n], dtype=torch.float64)
    if not shared:
        image = image[:, None] + 0.5 * torch.arange(B, dtype=torch.float64)[None, :, None, None]
    frames = tpipe.ImageFrameInput(
        image=image, imu_omega=b(seq.imu_omega), imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt),
        state_id=b(np.arange(1, n + 1), torch.int32), time=b(seq.time),
        frame_valid=b(np.ones(n, bool), torch.bool))
    run = (tpipe.batched_run_images_shared if shared else tpipe.batched_run_images)(tc, fcfg)

    def make():
        return (_fleet(tc, seq, torch.float64, B),
                tfunc.init_frontend_state(H, W, fcfg, B, 1 if shared else B, torch.float64,
                                          device="cpu"))

    got = run(*make(), frames)
    with cuda_graph.disabled():
        want = run(*make(), frames)
    _equal_trees(got, want, "run_images")
    assert int(got[1].valid.sum()) > 0


@pytest.mark.parametrize("use_ransac", [False, True], ids=["ransac-off", "ransac-on"])
def test_live_frame_loop_replay_equals_eager(small_world, use_ransac):
    tc, seq, imgs = small_world

    def run(eager):
        vio = tint.VioInterface(tc, dtype=torch.float64, keep_visualizer=True,
                                track_handler_kwargs=dict(TH_KW, use_ransac=use_ransac),
                                device="cpu")
        vio.initialize_from_ground_truth(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a)
        states = []
        with cuda_graph.disabled() if eager else contextlib.nullcontext():
            _drive(vio, seq, imgs, T, lambda v: states.append(v.state_to_numpy()))
            vio.finish()
        return vio, states

    got, got_states = run(False)
    want, want_states = run(True)
    assert [g.replays for g in got._live_frame.graphs.values()] == [T - 1]
    assert not want._live_frame.graphs
    for i, (g, w) in enumerate(zip(got_states, want_states)):
        assert g.keys() == w.keys()
        for k in w:
            assert np.array_equal(g[k], w[k]) if isinstance(w[k], np.ndarray) else g[k] == w[k], \
                f"frame {i} {k}"
    _equal_trees(got.state, want.state, "after finish()")
    np.testing.assert_array_equal(got.map(), want.map())
    np.testing.assert_array_equal(got.track_overlay(), want.track_overlay())
    assert got.host_copies == want.host_copies == T + 1


def _aliasing_step(carry, x):
    """A new carry that passes ``a`` through, swaps ``b`` and ``c``, and
    takes ``d`` as a view of the old ``b``; ``y`` holds the old ``c``."""
    a, b, c, d = carry["a"], carry["b"], carry["c"], carry["d"]
    return dict(a=a, b=c + x, c=b, d=b.view(-1)), (c, d.sum() + x)


def test_step_graph_copy_back_with_aliased_results():
    carry = dict(a=torch.arange(4.0), b=torch.ones(4), c=torch.full((4,), 2.0), d=torch.zeros(4))
    xs = torch.arange(3.0)
    graph = cuda_graph.StepGraph(_aliasing_step, carry, (xs[0],))
    got, ys = carry, []
    for t in range(3):
        got, y = graph(got, xs[t])
        ys.append(cuda_graph.clone(y))
    with cuda_graph.disabled():
        want, wys = cuda_graph.scan(_aliasing_step, carry, xs)
    _equal_trees(got, want, "carry")
    _equal_trees([y[0] for y in ys], list(wys[0]), "y")
    assert got["a"] is graph.carry["a"], "the carry stays in the graph's buffers"


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_batched_step_matches_jax(jdtype):
    serving = jdtype == jnp.float32
    jc, tc = _filter_configs(serving)
    dtype = tp.tdtype(jdtype)
    seq, frames, snaps = tp.port_snapshots(tc, 12, {8, 10}, dtype)
    arrays = tp.stack_dicts([snaps[8], snaps[10]])
    frame = tp.stack_dicts([tp.frame_arrays(frames, 10)] * 2)
    jframe = jfilter.FrameInput(**{k: jnp.asarray(v) for k, v in frame.items()})
    j_state, j_out = jax.jit(jsharding.batched_step(jc))(tp.jax_state(arrays, jc, jdtype), jframe)
    step = tsharding.batched_step(tc)
    t_state, t_out = step(tp.port_state(arrays),
                          tfilter.FrameInput(**{k: torch.as_tensor(v) for k, v in frame.items()}))
    np.testing.assert_allclose(t_out.p_I_G.numpy(), np.asarray(j_out.p_I_G), rtol=0,
                               atol=POS_TOL[jdtype])
    np.testing.assert_array_equal(t_out.num_residualized.numpy(), np.asarray(j_out.num_residualized))
    for k, v in vars(j_state.diag).items():
        np.testing.assert_array_equal(getattr(t_state.diag, k).numpy(), np.asarray(v), err_msg=k)
    # fresh outputs: a second call leaves the first call's results alone
    before = t_out.p_I_G.clone()
    step(t_state, tfilter.FrameInput(**{k: torch.as_tensor(v) for k, v in frame.items()}))
    assert torch.equal(t_out.p_I_G, before)


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_make_jitted_step_matches_jax(small_world, jdtype):
    _, _, imgs = small_world
    jc, tc = small_configs()
    dtype = tp.tdtype(jdtype)
    uv_tol = 1e-9 if jdtype == jnp.float64 else 1e-4
    H, W = SMALL_CAMERA["height"], SMALL_CAMERA["width"]
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    jstep, tstep = jfunc.make_jitted_step(jc, jfc), tfunc.make_jitted_step(tc, tfc)
    js = jfunc.init_frontend_state(H, W, jfc, jdtype)
    ts = tfunc.init_frontend_state(H, W, tfc, 1, 1, dtype, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(4):
        dR = np.eye(3) + np.cross(np.eye(3), rng.normal(size=3) * 1e-3)
        js, jo = jstep(js, jnp.asarray(imgs[i], jdtype), jnp.asarray(dR, jdtype))
        ts, to = tstep(ts, torch.as_tensor(imgs[i][None], dtype=dtype),
                       torch.as_tensor(dR[None], dtype=dtype))
        for k in ("tracked_ids", "tracked_valid", "new_ids", "new_valid"):
            np.testing.assert_array_equal(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {i} {k}")
        for k in ("tracked_uv", "new_uv"):
            np.testing.assert_allclose(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                       rtol=0, atol=uv_tol, err_msg=f"frame {i} {k}")
        assert int(ts.next_id[0]) == int(js.next_id)
    assert int(np.asarray(jo.tracked_valid).sum()) > 0


class _StandIn:
    """A stand-in for a kernel wrapper: counts its calls in ``.launches``."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        self.launches += 1
        return x * 2


def test_launch_bookkeeping_with_a_stand_in_counter():
    kernel = _StandIn()
    kernel.launches = 5
    with cuda_graph.counted_apart((kernel,)) as delta:
        for _ in range(3):
            kernel(torch.ones(2))
    assert delta == [3] and kernel.launches == 5
    # a replay adds the delta: what StepGraph.__call__ does on the card
    for _ in range(2):
        kernel.launches += delta[0]
    assert kernel.launches == 11

    def fn(carry, x):
        carry.add_(1.0)                      # even an in-place step leaves the inputs alone
        return carry, kernel(x)

    carry, x = torch.zeros(3), torch.ones(3)
    cuda_graph.warm_up(fn, (carry, x), (kernel,))
    assert kernel.launches == 11 and torch.equal(carry, torch.zeros(3))


def test_disabled_is_scoped():
    assert cuda_graph.enabled()
    with cuda_graph.disabled():
        assert not cuda_graph.enabled()
        with cuda_graph.disabled():
            assert not cuda_graph.enabled()
        assert not cuda_graph.enabled()
    assert cuda_graph.enabled()
