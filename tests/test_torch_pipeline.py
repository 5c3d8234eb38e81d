"""The image-in-the-loop slice as a whole against the JAX package, on the CPU.

Rendered 480 x 752 frames of the synthetic world (the port's own renderer,
equal to the JAX package's) go through both packages' front-end and fused
pipeline, from the same initial states:

* ``frontend_step`` over 3 frames: ids, valid masks and next_id equal, uv
  within 1e-9 (f64) and 1e-4 (f32);
* a JAX ``FrontendState`` carried into the port continues identically;
* ``run_images`` (B = 1, f64, strict ordering): positions within 1e-6 m and
  every Diagnostics counter equal;
* the shared-camera fleet (B = 2 distinct initial states, one image stream)
  and independent streams (B = 2) against JAX's vmapped runners, f64;
* the f32 serving configuration: positions within 2e-5 m, as the filter
  slice's f32 serving test (tests/test_torch_filter.py), counters equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from msckf_mono_tpu.core import pipeline as jpipe
from msckf_mono_tpu.core.init import ground_truth_init as j_gt_init
from msckf_mono_tpu.core.types import init_filter_state as j_init_state
from msckf_mono_tpu.frontend import functional as jfunc
from msckf_mono_tpu_torch.core import pipeline as tpipe
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.utils import prng

from tests import _torch_port as tp

T = 4
H, W = 480, 752
FRONTEND = dict(max_features=64, window_size=21, max_level=3)
POS_TOL = {jnp.float64: 1e-6, jnp.float32: 2e-5}


def _configs(serving):
    f = dict(tp.TINY_FILTER, max_track_length=6, fused_updates=serving)
    s = dict(tp.TINY_SHAPES)
    if serving:
        f.update(tp.SERVING_FILTER)
        s.update(prune_obs_cap=2, marg_obs_cap=6, prune_chunk=8, staged_chunk=2)
    return tp.configs(f, s)


@pytest.fixture(scope="module")
def world():
    """The tiny filter shapes' world, T frames rendered at the full camera."""
    _, tc = _configs(False)
    seq, w = tsyn.generate(tc, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                           return_world=True)
    return seq, np.stack([trender.render_frame(tc, w, i) for i in range(T)])


def _jax_frames(seq, images, dtype, B=None):
    """JAX ImageFrameInput; with B the IMU fields get a batch axis 1."""
    def b(x):
        x = jnp.asarray(x)
        return x if B is None else jnp.broadcast_to(x[:, None], (x.shape[0], B) + x.shape[1:])

    return jpipe.ImageFrameInput(
        image=jnp.asarray(images, dtype), imu_omega=b(jnp.asarray(seq.imu_omega[:T], dtype)),
        imu_acc=b(jnp.asarray(seq.imu_acc[:T], dtype)), imu_dt=b(jnp.asarray(seq.imu_dt[:T], dtype)),
        state_id=b(jnp.arange(1, T + 1, dtype=jnp.int32)), time=b(jnp.asarray(seq.time[:T], dtype)),
        frame_valid=b(jnp.ones((T,), bool)),
    )


def _port_frames(seq, images, dtype, B):
    """Port ImageFrameInput: images (T, Bi, H, W) or (T, H, W), the rest (T, B, ...)."""
    def b(x):
        x = torch.as_tensor(np.asarray(x))
        return x[:, None].expand((x.shape[0], B) + tuple(x.shape[1:]))

    return tpipe.ImageFrameInput(
        image=torch.as_tensor(images, dtype=dtype),
        imu_omega=b(seq.imu_omega[:T]).to(dtype), imu_acc=b(seq.imu_acc[:T]).to(dtype),
        imu_dt=b(seq.imu_dt[:T]).to(dtype), state_id=b(np.arange(1, T + 1, dtype=np.int32)),
        time=b(seq.time[:T]).to(dtype), frame_valid=b(np.ones((T,), bool)),
    )


def _dRs(n):
    rng = np.random.default_rng(0)
    return [Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix() for _ in range(n)]


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_frontend_step_matches_jax(world, dtype):
    _, images = world
    jc, tc = _configs(False)
    tdt = tp.tdtype(dtype)
    uv_tol = 1e-9 if dtype == jnp.float64 else 1e-4
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    jstep = jfunc.make_jitted_step(jc, jfc)
    js = jfunc.init_frontend_state(H, W, jfc, dtype)
    ts = tfunc.init_frontend_state(H, W, tfc, 1, 1, tdt, device="cpu")
    for i, dR in enumerate(_dRs(3)):
        js, jo = jstep(js, jnp.asarray(images[i], dtype), jnp.asarray(dR, dtype))
        ts, to = tfunc.frontend_step(ts, torch.as_tensor(images[i][None], dtype=tdt),
                                     torch.as_tensor(dR[None], dtype=tdt), tc, tfc)
        for k in ("tracked_ids", "tracked_valid", "new_ids", "new_valid"):
            np.testing.assert_array_equal(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {i} {k}")
        for k in ("tracked_uv", "new_uv"):
            np.testing.assert_allclose(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                       rtol=0, atol=uv_tol, err_msg=f"frame {i} {k}")
        assert int(ts.next_id[0]) == int(js.next_id)
        np.testing.assert_array_equal(ts.valid[0].numpy(), np.asarray(js.valid))
        np.testing.assert_array_equal(ts.ids[0].numpy(), np.asarray(js.ids))
        assert ts.next_id.dtype == ts.ids.dtype == to.new_ids.dtype == torch.int32
    assert int(to.tracked_valid.sum()) > 20 and int(ts.next_id[0]) > 50


def test_frontend_state_carries_across_exactly(world):
    _, images = world
    jc, tc = _configs(False)
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    jstep = jfunc.make_jitted_step(jc, jfc)
    js = jfunc.init_frontend_state(H, W, jfc, jnp.float64)
    dRs = _dRs(3)
    for i in range(2):
        js, _ = jstep(js, jnp.asarray(images[i], jnp.float64), jnp.asarray(dRs[i]))
    arrays = tp.jax_to_dict(js, batched=False)
    ts = tfunc.frontend_state_from_numpy(arrays, device="cpu")
    assert len(ts.pyramid) == 4 and ts.pyramid[3].shape == (1, 60, 94)
    back = tfunc.frontend_state_to_numpy(ts)
    assert set(back) == set(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)

    js, jo = jstep(js, jnp.asarray(images[2], jnp.float64), jnp.asarray(dRs[2]))
    ts, to = tfunc.frontend_step(ts, torch.as_tensor(images[2][None], dtype=torch.float64),
                                 torch.as_tensor(dRs[2][None]), tc, tfc)
    for k in ("tracked_ids", "tracked_valid", "new_ids", "new_valid"):
        np.testing.assert_array_equal(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)))
    np.testing.assert_allclose(to.tracked_uv[0].numpy(), np.asarray(jo.tracked_uv), rtol=0, atol=1e-9)
    assert int(to.tracked_valid.sum()) > 20


def _assert_runs_match(j, t, dtype, B):
    (j_final, j_ffinal, j_outs), (t_final, t_ffinal, t_outs) = j, t
    j_p = np.asarray(j_outs.p_I_G).reshape(T, B, 3)
    np.testing.assert_allclose(t_outs.p_I_G.numpy(), j_p, rtol=0, atol=POS_TOL[dtype])
    np.testing.assert_array_equal(t_outs.cam_count.numpy(),
                                  np.asarray(j_outs.cam_count).reshape(T, B))
    for k, v in vars(j_final.diag).items():
        np.testing.assert_array_equal(getattr(t_final.diag, k).numpy(), np.asarray(v).reshape(B),
                                      err_msg=k)
    np.testing.assert_array_equal(t_ffinal.next_id.numpy(), np.asarray(j_ffinal.next_id).reshape(B))
    np.testing.assert_array_equal(t_ffinal.ids.numpy(), np.asarray(j_ffinal.ids).reshape(B, -1))
    assert np.all(np.isfinite(t_outs.p_I_G.numpy()))
    assert int(t_ffinal.valid.sum()) > 20 * B


@pytest.mark.parametrize("dtype,serving", [(jnp.float64, False), (jnp.float32, True)],
                         ids=["f64-strict", "f32-serving"])
def test_run_images_matches_jax(world, dtype, serving):
    seq, images = world
    jc, tc = _configs(serving)
    tdt = tp.tdtype(dtype)
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    imu = j_gt_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=dtype)
    j = jax.jit(lambda s, fs, f: jpipe.run_images(s, fs, f, jc, jfc))(
        j_init_state(jc, imu, dtype=dtype), jfunc.init_frontend_state(H, W, jfc, dtype),
        _jax_frames(seq, images, dtype))
    t = tpipe.run_images(tp.port_initial_state(tc, seq, tdt),
                         tfunc.init_frontend_state(H, W, tfc, 1, 1, tdt, device="cpu"),
                         _port_frames(seq, images[:, None], tdt, 1), tc, tfc)
    _assert_runs_match(j, t, dtype, 1)


@pytest.mark.parametrize("shared", [True, False], ids=["shared-camera", "independent-streams"])
def test_batched_runners_match_jax(world, shared):
    """B = 2 filters with distinct initial states, carried into JAX from the
    port's fleet. Independent streams differ by a per-stream brightness
    offset, as bench.py's (b mod 7) * 0.5."""
    seq, images = world
    B = 2
    jc, tc = _configs(False)
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    imu = tp.port_initial_state(tc, seq).imu
    fleet = tmc.make_fleet(tc, imu, B, prng.PRNGKey(3), dtype=torch.float64, device="cpu")
    jstates = tp.jax_state(filter_state_to_numpy(fleet), jc, jnp.float64)
    jfs = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                 jfunc.init_frontend_state(H, W, jfc, jnp.float64))
    if shared:
        j_images, t_images, Bi = images, images, 1
        jrun, trun = jpipe.batched_run_images_shared(jc, jfc), tpipe.batched_run_images_shared(tc, tfc)
    else:
        j_images = t_images = images[:, None] + 0.5 * np.arange(B, dtype=np.float32)[None, :, None, None]
        Bi = B
        jrun, trun = jpipe.batched_run_images(jc, jfc), tpipe.batched_run_images(tc, tfc)
    j = jax.jit(jrun)(jstates, jfs, _jax_frames(seq, j_images, jnp.float64, B))
    tfs = tfunc.init_frontend_state(H, W, tfc, B, Bi, torch.float64, device="cpu")
    t = trun(fleet, tfs, _port_frames(seq, t_images, torch.float64, B))
    assert all(p.shape[0] == Bi for p in t[1].pyramid)
    _assert_runs_match(j, t, jnp.float64, B)
    assert not np.allclose(t[2].p_I_G[:, 0].numpy(), t[2].p_I_G[:, 1].numpy())


def test_gyro_dR_matches_jax(world):
    seq, _ = world
    rng = np.random.default_rng(4)
    b_g = rng.normal(0, 0.01, size=(3, 3))
    q_CI = np.asarray(tp.configs()[1].camera.q_CI)
    frame = _port_frames(seq, np.zeros((T, 1, 1, 1)), torch.float64, 3)
    frame = tpipe.ImageFrameInput(**{k: v[1].clone() for k, v in vars(frame).items()})
    frame.imu_dt[2, -1] = 0.0      # a padded sample
    got = tpipe._gyro_dR(frame, torch.as_tensor(b_g), torch.as_tensor(q_CI), torch.float64)
    for b in range(3):
        jf = jpipe.ImageFrameInput(**{k: jnp.asarray(v[0 if k == "image" else b].numpy())
                                      for k, v in vars(frame).items()})
        want = jpipe._gyro_dR(jf, jnp.asarray(b_g[b]), jnp.asarray(q_CI), jnp.float64)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn", [tfunc.init_frontend_state])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
