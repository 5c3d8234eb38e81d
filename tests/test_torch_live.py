"""The port's live path against the JAX package, on the CPU.

Modules: ``frontend/ransac.py``, ``frontend/visualize.py``,
``frontend/track_handler.py`` and ``interface.py`` (the slice as a whole).
Images are rendered by the port's renderer copy (bit-equal to the JAX
package's) at a small camera, 188 x 120 with the EuRoC intrinsics scaled by
1/4. Tolerances:

* RANSAC scoring on the JAX package's own sampled pairs: inlier masks equal;
* ``two_point_ransac`` on a key against the JAX package's on the same key,
  at F = 128 with 0, 3, 5, 40 and 128 valid points, f32 (JAX with x64 off,
  32-bit draws) and f64 (x64 on, 64-bit draws): sampled pairs and inlier
  masks equal;
* ``TrackVisualizer.draw``: pixel-equal;
* ``TrackHandler`` over 12 frames: f64 ids, valid flags and next_feature_id
  equal every frame, uv within 1e-9; f32 the same discrete outputs, uv
  within 1e-4; with RANSAC on over 20 frames in f64, the same (the carried
  key included);
* ``TrackHandler`` against the port's own ``frontend_step`` at B = Bi = 1
  over the same 12 frames and rotations, f64 and f32: the lists and the
  carry bit-equal (one front-end, two drivers);
* ``VioInterface`` at the tiny filter shapes of tests/_torch_port.py, f64,
  crossing ``max_cam_states`` so the pruned-pose archive fires, then
  ``finish()``: odometry within 1e-6 m every frame; cam_states, the
  cumulative map and the pruned states equal in ids and shapes, values within
  1e-6; the standstill calibration within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu import interface as jint
from msckf_mono_tpu.frontend import ransac as jransac
from msckf_mono_tpu.frontend import track_handler as jth
from msckf_mono_tpu.frontend import visualize as jvis
from msckf_mono_tpu.utils import config as jcfg
from msckf_mono_tpu_torch import interface as tint
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.frontend import ransac as transac
from msckf_mono_tpu_torch.frontend import track_handler as tth
from msckf_mono_tpu_torch.frontend import visualize as tvis
from msckf_mono_tpu_torch.utils import config as tcfg
from msckf_mono_tpu_torch.utils import prng

from tests import _torch_port as tp

CPU = "cpu"
_cam0 = tcfg.CameraConfig()
SMALL_CAMERA = dict(f_u=_cam0.f_u / 4, f_v=_cam0.f_v / 4, c_u=_cam0.c_u / 4, c_v=_cam0.c_v / 4,
                    width=188, height=120)
TH_KW = dict(max_features=16, window_size=21, max_level=3)
N_TH_FRAMES = 12
N_LIVE_FRAMES = 14
N_RANSAC_FRAMES = 20


def small_configs(filter_kw=None, shapes_kw=None):
    """(JAX, port) configs at the small camera and the given filter/shape overrides."""
    f, s = dict(filter_kw or {}), dict(shapes_kw or {})
    j = jcfg.MsckfConfig(camera=jcfg.CameraConfig(**SMALL_CAMERA), filter=jcfg.FilterConfig(**f),
                         shapes=jcfg.ShapeConfig(**s))
    t = tcfg.MsckfConfig(camera=tcfg.CameraConfig(**SMALL_CAMERA), filter=tcfg.FilterConfig(**f),
                         shapes=tcfg.ShapeConfig(**s))
    return j, t


def _world(tconfig, n_frames):
    seq, world = tsyn.generate(tconfig, n_frames=n_frames, seed=0, pixel_noise=0.0,
                               n_landmarks=500, return_world=True)
    imgs = [trender.render_frame(tconfig, world, i) for i in range(n_frames)]
    return seq, imgs


def _K(cam):
    return np.array([[cam.f_u, 0, cam.c_u], [0, cam.f_v, cam.c_v], [0, 0, 1.0]])


# ---- RANSAC ----

def _ransac_inputs(seed, F=40):
    rng = np.random.default_rng(seed)
    ang = 0.02
    dR = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    t = np.array([0.3, -0.1, 0.05])
    P = np.c_[rng.uniform(-1, 1, (F, 2)), rng.uniform(3, 8, F)]
    old = P[:, :2] / P[:, 2:]
    Pn = P @ dR.T + t
    new = Pn[:, :2] / Pn[:, 2:] + rng.normal(0, 1e-5, (F, 2))
    new[::7] += rng.normal(0, 0.05, (len(new[::7]), 2))              # outliers
    valid = rng.uniform(size=F) < 0.9
    return dR, old, new, valid


def _jax_pairs(valid, key, num_iters=300):
    """The pairs jransac.two_point_ransac samples for ``key`` (its own code)."""
    valid = jnp.asarray(valid)
    k1, k2 = jax.random.split(key)
    pool = jnp.argsort(jnp.logical_not(valid), stable=True)
    n = jnp.maximum(jnp.sum(valid), 2)
    i1 = pool[jax.random.randint(k1, (num_iters,), 0, n)]
    off = jax.random.randint(k2, (num_iters,), 1, jnp.maximum(n - 1, 1))
    i2 = pool[(jax.random.randint(k1, (num_iters,), 0, n) + off) % n]
    return np.asarray(i1), np.asarray(i2)


@pytest.mark.parametrize("seed,n_valid", [(0, None), (1, None), (2, 4)])
def test_ransac_scoring_matches_jax_on_its_pairs(seed, n_valid):
    dR, old, new, valid = _ransac_inputs(seed)
    if n_valid is not None:
        valid[:] = False
        valid[:n_valid] = True                      # < 5 valid: every valid point kept
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jransac.two_point_ransac(jnp.asarray(dR), jnp.asarray(old), jnp.asarray(new),
                                               jnp.asarray(valid), key))
    i1, i2 = _jax_pairs(valid, key)
    got = transac.score_pairs(torch.as_tensor(dR), torch.as_tensor(old), torch.as_tensor(new),
                              torch.as_tensor(valid), torch.as_tensor(i1), torch.as_tensor(i2))
    np.testing.assert_array_equal(got.numpy(), want)
    if n_valid is None:
        assert 0 < want.sum() < valid.sum()


def test_ransac_sampler_finds_the_outliers():
    dR, old, new, valid = _ransac_inputs(0)
    i1, i2 = transac.sample_pairs(torch.as_tensor(valid), prng.PRNGKey(0))
    assert bool(torch.all(i1 != i2)) and bool(torch.all(torch.as_tensor(valid)[i1]))
    assert bool(torch.all(torch.as_tensor(valid)[i2]))
    got = transac.two_point_ransac(torch.as_tensor(dR), torch.as_tensor(old), torch.as_tensor(new),
                                   torch.as_tensor(valid), prng.PRNGKey(0)).numpy()
    outlier = np.zeros_like(valid)
    outlier[::7] = True
    assert not np.any(got & outlier)
    assert got.sum() >= 0.9 * (valid & ~outlier).sum()


@pytest.mark.parametrize("n_valid", [0, 3, 5, 40, 128])
@pytest.mark.parametrize("bits", [32, 64], ids=["f32", "f64"])
def test_two_point_ransac_matches_jax_on_a_key(bits, n_valid):
    F = 128
    dR, old, new, _ = _ransac_inputs(n_valid, F)
    valid = np.zeros(F, bool)
    valid[np.random.default_rng(F + n_valid).permutation(F)[:n_valid]] = True
    np_dtype, tdtype = (np.float32, torch.float32) if bits == 32 else (np.float64, torch.float64)
    args = [x.astype(np_dtype) for x in (dR, old, new)]
    with jax.enable_x64(bits == 64):
        key = jax.random.PRNGKey(n_valid)
        want = np.asarray(jransac.two_point_ransac(*map(jnp.asarray, args), jnp.asarray(valid), key))
        w1, w2 = _jax_pairs(valid, key)
    tkey = prng.PRNGKey(n_valid)
    targs = [torch.as_tensor(x) for x in args] + [torch.as_tensor(valid)]
    i1, i2 = transac.sample_pairs(targs[-1], tkey, int_bits=bits)
    np.testing.assert_array_equal(i1.numpy(), w1)
    np.testing.assert_array_equal(i2.numpy(), w2)
    got = transac.two_point_ransac(*targs, tkey).numpy()
    np.testing.assert_array_equal(got, want)
    if n_valid >= 40:
        assert 0 < want.sum() < n_valid


# ---- TrackHandler ----

@pytest.fixture(scope="module")
def th_world():
    _, tc = small_configs()
    seq, imgs = _world(tc, N_TH_FRAMES)
    # camera-frame gyro readings, as the interface feeds them
    from msckf_mono_tpu_torch.utils import quat

    q_CI = torch.as_tensor(tc.camera.q_CI, dtype=torch.float64)
    gyro = quat.rotate(q_CI, torch.as_tensor(seq.imu_omega - seq.b_g)).numpy()
    return tc, seq, imgs, gyro


def _run_jax_th(tc, seq, imgs, gyro, dtype, **kw):
    cam = tc.camera
    th = jth.TrackHandler(_K(cam), cam.distortion_coeffs, cam.distortion_model, dtype=dtype,
                          **TH_KW, **kw)
    out = []
    for i, img in enumerate(imgs):
        for g in gyro[i]:
            th.add_gyro_reading(g)
        th.set_current_image(img, float(seq.time[i]))
        t = th.tracked_features()
        n = th.new_features()
        out.append(dict(tracked=[np.asarray(x) for x in t], new=[np.asarray(x) for x in n],
                        next_id=th.next_feature_id, cur_pts=np.asarray(th.cur_pts),
                        key=np.asarray(th._key).astype(np.int64)))
    return out, th


@pytest.fixture(scope="module")
def jax_th_runs(th_world):
    tc, seq, imgs, gyro = th_world
    return {dt: _run_jax_th(tc, seq, imgs, gyro, dt)[0] for dt in (jnp.float64, jnp.float32)}


@pytest.mark.parametrize("jdtype,tol", [(jnp.float64, 1e-9), (jnp.float32, 1e-4)])
def test_track_handler_matches_jax(th_world, jax_th_runs, jdtype, tol):
    tc, seq, imgs, gyro = th_world
    _check_track_handler(tc, seq, imgs, gyro, jax_th_runs[jdtype], tp.tdtype(jdtype), tol)


def _check_track_handler(tc, seq, imgs, gyro, jax_run, dtype, tol, **kw):
    """The port's TrackHandler over ``imgs`` against a ``_run_jax_th`` run."""
    cam = tc.camera
    th = tth.TrackHandler(_K(cam), cam.distortion_coeffs, cam.distortion_model,
                          dtype=dtype, device=CPU, **TH_KW, **kw)
    tracked_any = 0
    for i, (img, want) in enumerate(zip(imgs, jax_run)):
        th.add_gyro_reading(gyro[i])
        th.set_current_image(img, float(seq.time[i]))
        t = th.tracked_features()
        n = th.new_features()
        for name, got, ref in (("tracked", t, want["tracked"]), ("new", n, want["new"])):
            uv, ids, valid = (x[0].numpy() for x in got)
            np.testing.assert_array_equal(valid, ref[2], err_msg=f"frame {i} {name} valid")
            np.testing.assert_array_equal(ids, ref[1], err_msg=f"frame {i} {name} ids")
            np.testing.assert_allclose(uv, ref[0], rtol=0, atol=tol, err_msg=f"frame {i} {name} uv")
        assert th.next_feature_id == want["next_id"], i
        v = want["tracked"][2]
        np.testing.assert_allclose(th.cur_pts[0].numpy()[v], want["cur_pts"][v], rtol=0,
                                   atol=tol * 1e3)
        np.testing.assert_array_equal(th._key.numpy(), want["key"], err_msg=f"frame {i} key")
        tracked_any += int(v.sum())
    assert tracked_any > 5 * len(imgs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_track_handler_and_frontend_step_are_one_front_end(th_world, dtype):
    """The live driver and the image fleets' step run the same stages: fed
    the handler's rotation each frame, ``frontend_step`` at B = Bi = 1 gives
    bit-equal tracked and new lists, and its state is the handler's deduped
    carry after the next ingest. K⁻¹ is the one input the two derive apart
    (the handler inverts its K with LAPACK, 1 ulp from the config's closed
    form in f64), so the handler is given the closed form here."""
    tc, seq, imgs, gyro = th_world
    cam = tc.camera
    th = tth.TrackHandler(_K(cam), cam.distortion_coeffs, cam.distortion_model, dtype=dtype,
                          device=CPU, **TH_KW)
    th.K_inv = tfunc._camera_arrays(tc, dtype, torch.device(CPU))[1]
    fs = tfunc.init_frontend_state(cam.height, cam.width, th.fcfg, 1, 1, dtype, device=CPU)
    names = ("tracked_uv", "tracked_ids", "tracked_valid", "new_uv", "new_ids", "new_valid")
    tracked = 0
    for i, img in enumerate(imgs):
        th.add_gyro_reading(gyro[i])
        th.set_current_image(img, float(seq.time[i]))
        for name in ("pts", "ids", "valid"):
            assert torch.equal(getattr(th, "prev_" + name), getattr(fs, name)), (i, name)
        got = th.tracked_features() + th.new_features()
        fs, out = tfunc.frontend_step(fs, torch.as_tensor(img[None], dtype=dtype), th.dR, tc,
                                      th.fcfg)
        for name, g in zip(names, got):
            want = getattr(out, name)
            assert g.dtype == want.dtype and torch.equal(g, want), (i, name)
        assert int(fs.next_id[0]) == th.next_feature_id
        tracked += int(out.tracked_valid.sum())
    assert tracked > 5 * len(imgs)


@pytest.fixture(scope="module")
def ransac_world():
    _, tc = small_configs()
    seq, imgs = _world(tc, N_RANSAC_FRAMES)
    from msckf_mono_tpu_torch.utils import quat

    q_CI = torch.as_tensor(tc.camera.q_CI, dtype=torch.float64)
    gyro = quat.rotate(q_CI, torch.as_tensor(seq.imu_omega - seq.b_g)).numpy()
    return tc, seq, imgs, gyro


def test_track_handler_with_ransac_matches_jax(ransac_world):
    """RANSAC on, f64: JAX's draws from the same carried key, track for track."""
    tc, seq, imgs, gyro = ransac_world
    want, _ = _run_jax_th(tc, seq, imgs, gyro, jnp.float64, use_ransac=True)
    off, _ = _run_jax_th(tc, seq, imgs, gyro, jnp.float64)
    # RANSAC dropped tracks, so the draws decided something
    assert sum(int(a["tracked"][2].sum()) for a in want) < sum(int(a["tracked"][2].sum()) for a in off)
    _check_track_handler(tc, seq, imgs, gyro, want, torch.float64, 1e-9, use_ransac=True)


def test_track_handler_ransac_on_keeps_the_contract(th_world):
    """With RANSAC on, tracked features are a subset of those without it."""
    tc, seq, imgs, gyro = th_world
    cam = tc.camera
    ths = [tth.TrackHandler(_K(cam), cam.distortion_coeffs, cam.distortion_model,
                            dtype=torch.float64, device=CPU, use_ransac=on, **TH_KW)
           for on in (False, True)]
    for i, img in enumerate(imgs[:6]):
        outs = []
        for th in ths:
            th.add_gyro_reading(gyro[i])
            th.set_current_image(img, float(seq.time[i]))
            outs.append(th.tracked_features()[2][0].numpy())
            th.new_features()
            # keep both on the same tracks
        ths[1].state_from_numpy(ths[0].state_to_numpy())
        assert not np.any(outs[1] & ~outs[0])


def test_track_visualizer_draw_is_pixel_equal(th_world, jax_th_runs):
    tc, seq, imgs, gyro = th_world
    jv, tv = jvis.TrackVisualizer(), tvis.TrackVisualizer()
    for i, frame in enumerate(jax_th_runs[jnp.float64]):
        for v in (jv, tv):
            v.add_current_features(frame["cur_pts"], frame["tracked"][1], frame["tracked"][2])
            v.add_new_features(frame["cur_pts"] * 0 + 5 * i, frame["new"][1], frame["new"][2])
        jv.add_predicted(frame["cur_pts"] + 1.5, frame["tracked"][1], frame["tracked"][2])
        tv.add_predicted(frame["cur_pts"] + 1.5, frame["tracked"][1], frame["tracked"][2])
    want, got = jv.draw(imgs[-1]), tv.draw(imgs[-1])
    assert got.dtype == np.uint8 and got.shape == (120, 188, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != np.stack([imgs[-1].astype(np.uint8)] * 3, -1)).any()


# ---- the slice: VioInterface ----

def _live_configs():
    return small_configs(dict(tp.TINY_FILTER, fused_updates=False, max_track_length=4),
                         dict(tp.TINY_SHAPES, max_features_per_frame=8))


def _drive(vio, seq, imgs, n_frames, record):
    K = seq.imu_omega.shape[1]
    for i in range(n_frames):
        for k in range(K):
            vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                             float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        assert vio.image_callback(imgs[i], float(seq.time[i]))
        record(vio)


def _gt_init(vio, seq):
    vio.initialize_from_ground_truth(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a)


def _surface(vio):
    out = {"map": vio.map(), **{"pruned." + k: v for k, v in vio.pruned_states().items()}}
    out.update({"cam." + k: v for k, v in vio.cam_states().items()})
    return out


@pytest.fixture(scope="module")
def live_world():
    jc, tc = _live_configs()
    seq, imgs = _world(tc, N_LIVE_FRAMES)
    return jc, tc, seq, imgs


@pytest.fixture(scope="module")
def jax_live(live_world):
    jc, tc, seq, imgs = live_world
    vio = jint.VioInterface(jc, dtype=jnp.float64, keep_visualizer=True, track_handler_kwargs=TH_KW)
    _gt_init(vio, seq)
    odo, ids = [], []
    _drive(vio, seq, imgs, N_LIVE_FRAMES,
           lambda v: (odo.append(v.odometry()["p_I_G"]),
                      ids.append(np.asarray(v.track_handler.cur_ids))))
    before = _surface(vio)
    vio.finish()
    return dict(odo=np.asarray(odo), ids=ids, before=before, after=_surface(vio),
                overlay=vio.track_overlay())


def _assert_surface(got, want, tag):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, f"{tag} {k}: {g.shape} != {w.shape}"
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


def test_vio_interface_matches_jax(live_world, jax_live):
    jc, tc, seq, imgs = live_world
    vio = tint.VioInterface(tc, dtype=torch.float64, keep_visualizer=True,
                            track_handler_kwargs=TH_KW, device=CPU)
    _gt_init(vio, seq)
    odo, ids = [], []
    _drive(vio, seq, imgs, N_LIVE_FRAMES,
           lambda v: (odo.append(v.odometry()["p_I_G"]), ids.append(v.track_handler.cur_ids[0].numpy().copy())))
    # one device->host copy a frame: odometry, archives and features together
    assert vio.host_copies == N_LIVE_FRAMES
    np.testing.assert_allclose(np.asarray(odo), jax_live["odo"], rtol=0, atol=1e-6)
    for i, (g, w) in enumerate(zip(ids, jax_live["ids"])):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i} ids")
    before = _surface(vio)
    assert len(before["pruned.state_id"]) > 0, "the window crossed max_cam_states: prunes archive"
    assert len(before["map"]) > 0
    _assert_surface(before, jax_live["before"], "before finish")
    vio.finish()
    after = _surface(vio)
    assert len(after["map"]) >= len(before["map"])
    _assert_surface(after, jax_live["after"], "after finish")
    np.testing.assert_array_equal(vio.track_overlay(), jax_live["overlay"])


def test_vio_interface_multi_block_and_state_carry(live_world):
    """More readings than one IMU block propagate first (the JAX path's
    propagate-only frames); and a state carried through numpy continues the
    same run."""
    jc, tc, seq, imgs = live_world
    jv = jint.VioInterface(jc, dtype=jnp.float64, track_handler_kwargs=TH_KW, collect_archives=False)
    tv = tint.VioInterface(tc, dtype=torch.float64, track_handler_kwargs=TH_KW, device=CPU,
                           collect_archives=False)
    K = seq.imu_omega.shape[1]
    for v in (jv, tv):
        _gt_init(v, seq)
        # the first image comes after the readings of two frames: two blocks
        for i in (0, 1):
            for k in range(K):
                v.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                               float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        v.image_callback(imgs[1], float(seq.time[1]))
    np.testing.assert_allclose(tv.odometry()["p_I_G"], jv.odometry()["p_I_G"], rtol=0, atol=1e-9)
    assert tv.host_copies == 1            # the odometry getter; no per-frame copy

    carried = tint.VioInterface(tc, dtype=torch.float64, track_handler_kwargs=TH_KW, device=CPU,
                                collect_archives=False)
    carried.state_from_numpy(tv.state_to_numpy())
    for v in (tv, carried):
        for i in range(2, 5):
            for k in range(K):
                v.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                               float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
            v.image_callback(imgs[i], float(seq.time[i]))
    np.testing.assert_array_equal(carried.odometry()["p_I_G"], tv.odometry()["p_I_G"])
    np.testing.assert_array_equal(carried.track_handler.cur_ids.numpy(),
                                  tv.track_handler.cur_ids.numpy())


def test_vio_interface_standstill_calibration_matches_jax():
    jc, tc = _live_configs()
    rng = np.random.default_rng(0)
    b_g = np.array([0.01, -0.02, 0.005])
    b_a = np.array([0.05, 0.02, -0.03])
    readings = [(b_g + rng.normal(scale=1e-4, size=3),
                 np.array([0.3, -0.2, 9.81]) + b_a + rng.normal(scale=1e-4, size=3), 0.005 * i)
                for i in range(120)]
    jv = jint.VioInterface(jc, stand_still_time=0.5, dtype=jnp.float64)
    tv = tint.VioInterface(tc, stand_still_time=0.5, dtype=torch.float64, device=CPU)
    assert not tv.image_callback(np.zeros((120, 188), np.float32), 0.0)
    for v in (jv, tv):
        for omega, acc, t in readings:
            v.imu_callback(omega, acc, t)
    assert tv.imu_calibrated and jv.imu_calibrated
    assert len(tv.imu_queue) == len(jv.imu_queue)
    for k in ("q_IG", "b_g", "b_a", "p_I_G", "v_I_G"):
        np.testing.assert_allclose(getattr(tv.state.imu, k)[0].numpy(),
                                   np.asarray(getattr(jv.state.imu, k)), rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tv.state.P[0].numpy(), np.asarray(jv.state.P), rtol=0, atol=1e-15)
    np.testing.assert_allclose(tv.state.imu.b_g[0].numpy(), b_g, atol=1e-3)


def test_to_host_keeps_dtypes_and_values():
    ts = [torch.tensor([True, False]), torch.tensor([[3, -1]], dtype=torch.int32),
          torch.tensor([1.5, float(np.float32(0.1))], dtype=torch.float32),
          torch.tensor([0.1, 2.0 ** -60], dtype=torch.float64)]
    out = tint.to_host(ts)
    for g, t in zip(out, ts):
        assert g.dtype == t.numpy().dtype and g.shape == tuple(t.shape)
        np.testing.assert_array_equal(g, t.numpy())


@pytest.mark.parametrize("n", [0, 3, 4, 9])
def test_pack_imu_blocks_and_budget_match_jax(n):
    rng = np.random.default_rng(n)
    readings = [jint.ImuReading(omega=rng.normal(size=3), acc=rng.normal(size=3), time=0.005 * i,
                                dt=0.005) for i in range(n)]
    want = jint._pack_imu_blocks(readings, 4, jnp.float64)
    got = tint._pack_imu_blocks([tint.ImuReading(**vars(r)) for r in readings], 4, torch.float64,
                                device=CPU)
    assert len(got) == len(want) == max(1, -(-n // 4))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    valid = rng.uniform(size=12) < 0.5
    uv, ids = rng.normal(size=(12, 2)), np.arange(12, dtype=np.int32) * 3
    w = jint._budget(jnp.asarray(uv), jnp.asarray(ids), jnp.asarray(valid), 8, jnp.float64)
    g_valid, g_uv, g_ids = tfunc.first_valid(torch.as_tensor(valid)[None], 8,
                                             torch.as_tensor(uv)[None], torch.as_tensor(ids)[None])
    for a, b in zip((g_uv, g_ids, g_valid), w):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
