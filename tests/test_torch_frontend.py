"""The port's image front-end modules against the JAX package, on the CPU.

Inputs are made from seeded numpy and fed to both packages. The JAX image
functions run as the JAX tests run them on the CPU: the jnp path, and the
Pallas kernels in interpret mode. Tolerances:

* undistort (radtan, equidistant, fallback): f64 1e-12;
* pyrDown / build_pyramid, odd sizes included: f64 1e-10, f32 1e-4;
* Shi-Tomasi: f64 1e-9;
* FAST-10 + NMS: exact; the plain version against the Pallas kernel in
  interpret mode: atol 1e-4, as tests/test_fast_pallas.py;
* detect_features on one shared image with per-filter occupancy: exact;
* one LK level: f64 1e-9 with good flags exact against klt._track_level
  (interior and border features, and windows of 51 and 71 px); against the
  Pallas kernel in interpret mode on interior features, right-edge level-2
  features included: 0.05 px and good flags exact, as
  tests/test_klt_pallas.py;
* the LK pyramid loop (window 51 drops levels): f64 1e-9;
* reject_outliers and _grid_dedup: exact.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.frontend import detect as jdetect
from msckf_mono_tpu.frontend import functional as jfunc
from msckf_mono_tpu.frontend import klt as jklt
from msckf_mono_tpu.frontend import undistort as jund
from msckf_mono_tpu.ops import fast_pallas, klt_pallas
from msckf_mono_tpu_torch.frontend import detect as tdetect
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.frontend import klt as tklt
from msckf_mono_tpu_torch.frontend import undistort as tund
from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda
from msckf_mono_tpu_torch.utils.config import MsckfConfig

from tests import _torch_port as tp  # noqa: F401  (one intra-op thread)
from tests.test_torch_image_cuda import _shift_image, _smooth_image

RADTAN = MsckfConfig().camera.distortion_coeffs
EQUIDISTANT = (-0.013721808247486035, 0.020727425669427896, -0.012786476702685545,
               0.0025242267320687625)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _corner_image(rng, shape):
    """Uniform noise with a few planted FAST corners (as tests/test_fast_pallas.py)."""
    img = rng.uniform(0, 255, size=shape).astype(np.float32)
    for y, x in [(20, 30), (40, 70), (shape[0] - 10, shape[1] - 20)]:
        img[y - 2 : y + 3, x - 2 : x + 3] = 10.0
        img[y, x] = 250.0
    return img


# ---------------------------------------------------------------- undistort


@pytest.mark.parametrize("model", ["radtan", "equidistant", "unknown"])
def test_undistort_matches_jax(model):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.6, 0.6, size=(5, 40, 2))
    coeffs = EQUIDISTANT if model == "equidistant" else RADTAN
    jd = jund.distort_equidistant if model == "equidistant" else jund.distort_radtan
    td = tund.distort_equidistant if model == "equidistant" else tund.distort_radtan
    np.testing.assert_allclose(td(_t(xy), coeffs).numpy(), np.asarray(jd(jnp.asarray(xy), coeffs)),
                               rtol=0, atol=1e-12)
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
    uv = rng.uniform(0, 480, size=(5, 40, 2))
    want = np.asarray(jund.undistort_points(jnp.asarray(uv), jnp.asarray(K), coeffs, model))
    got = tund.undistort_points(_t(uv), _t(K), coeffs, model).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    back = tund.normalized_to_pixels(tund.pixels_to_normalized(_t(uv), _t(K)), _t(K)).numpy()
    np.testing.assert_allclose(back, uv, rtol=0, atol=1e-12)
    if model == "radtan":   # iteration count is a parameter of both
        np.testing.assert_allclose(
            tund.undistort_radtan(_t(xy), coeffs, iters=8).numpy(),
            np.asarray(jund.undistort_radtan(jnp.asarray(xy), coeffs, iters=8)), rtol=0, atol=1e-12)


# ---------------------------------------------------------------- pyramid


@pytest.mark.parametrize("shape", [(480, 752), (121, 187), (33, 50)])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_pyramid_matches_jax(shape, dtype):
    jdt, tdt, tol = (jnp.float64, torch.float64, 1e-10) if dtype == "f64" else \
        (jnp.float32, torch.float32, 1e-4)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, size=(2,) + shape)
    got = tklt.build_pyramid(_t(imgs, tdt), 3)
    for b in range(2):
        want = jklt.build_pyramid(jnp.asarray(imgs[b], jdt), 3)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=tol)


# ---------------------------------------------------------------- detection


def test_shi_tomasi_matches_jax():
    rng = np.random.default_rng(3)
    imgs = np.stack([_smooth_image(rng, (120, 188)) for _ in range(2)]).astype(np.float64)
    got = tdetect.shi_tomasi_score(_t(imgs))
    for b in range(2):
        want = np.asarray(jdetect.shi_tomasi_score(jnp.asarray(imgs[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fast_and_nms_match_jax_exactly(dtype):
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(4)
    imgs = np.stack([_corner_image(rng, (97, 131)), _smooth_image(rng, (97, 131))])
    t_mask, t_score = tdetect.fast_score_10(_t(imgs, tdt), 20.0)
    t_keep = tdetect.nonmax_3x3(t_score, t_mask)
    for b in range(2):
        j_mask, j_score = jdetect.fast_score_10(jnp.asarray(imgs[b], jdt), 20.0)
        j_keep = jdetect.nonmax_3x3(j_score, j_mask)
        np.testing.assert_array_equal(t_mask[b].numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(t_score[b].numpy(), np.asarray(j_score))
        np.testing.assert_array_equal(t_keep[b].numpy(), np.asarray(j_keep))
    assert int(t_keep.sum()) > 3


@pytest.mark.parametrize("shape", [(64, 96), (120, 160), (201, 300)])
def test_fast_plain_matches_pallas_interpret(shape):
    img = _corner_image(np.random.default_rng(7), shape)
    want = np.asarray(fast_pallas.fast_nms_score(jnp.asarray(img), 20.0, tile_h=48, interpret=True))
    got = fast_cuda.fast_nms_score(_t(img[None], torch.float32), 20.0)   # CPU: the plain version
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-4)
    assert (want > 0).sum() > 0


def test_detect_features_shared_image_per_filter_occupancy():
    rng = np.random.default_rng(5)
    H, W = 120, 188
    img = _smooth_image(rng, (H, W))
    for y, x in rng.integers(20, 100, size=(12, 2)):
        img[y - 2 : y + 3, x - 2 : x + 3] = 5.0
        img[y, x] = 255.0
    occ = rng.uniform(size=(3, 100)) < np.array([[0.0], [0.3], [0.7]])
    xy, score, valid = tdetect.detect_features(_t(img[None]), torch.as_tensor(occ), 10, 10,
                                               20.0, 40.0)
    assert xy.shape == (3, 100, 2) and valid.shape == (3, 100)
    for b in range(3):
        jxy, jscore, jvalid = jdetect.detect_features(jnp.asarray(img, jnp.float64),
                                                      jnp.asarray(occ[b]), 10, 10, 20.0, 40.0)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(xy[b].numpy(), np.asarray(jxy))
        np.testing.assert_allclose(score[b].numpy(), np.asarray(jscore), rtol=1e-9, atol=0)
    assert int(valid[0].sum()) > int(valid[2].sum()) > 0


# ---------------------------------------------------------------- LK


@pytest.fixture(scope="module")
def lk_pair():
    rng = np.random.default_rng(3)
    img0 = _smooth_image(rng, (96, 144))
    return img0, _shift_image(img0, 1.7, -1.2), rng


def _lk_points(rng, F, H, W, margin):
    pts = np.stack([rng.uniform(margin, W - margin, size=F), rng.uniform(margin, H - margin, size=F)],
                   -1)
    return pts, pts + rng.normal(0, 1.0, size=(F, 2))


@pytest.mark.parametrize("where", ["interior", "border"])
def test_track_level_plain_matches_jax(lk_pair, where):
    img0, img1, _ = lk_pair
    rng = np.random.default_rng(8)
    H, W = img0.shape
    if where == "interior":
        pts, pred = _lk_points(rng, 24, H, W, 30)
    else:   # windows that leave the image on every side, and points off it
        pts = np.array([[1.0, 1.0], [W - 2.0, 40.0], [70.0, H - 1.5], [3.0, H - 4.0],
                        [W + 2.0, 10.0], [-2.5, 50.0], [W - 8.0, H - 8.0], [60.0, 0.5]])
        pred = pts + rng.normal(0, 1.0, size=pts.shape)
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    jp, jg = jklt._track_level(jnp.asarray(img0, jnp.float64), jnp.asarray(img1, jnp.float64),
                               jnp.asarray(pts), jnp.asarray(pred), jnp.asarray(valid),
                               7, 30, 0.03, 1e-4)
    tpts, tgood = klt_cuda.track_level_plain(
        _t(img0[None]), _t(img1[None]), _t(pts[None]), _t(pred[None]), torch.as_tensor(valid[None]),
        window_size=15, max_iters=30, eps=0.03, min_eigen_threshold=1e-4)
    np.testing.assert_array_equal(tgood[0].numpy(), np.asarray(jg))
    np.testing.assert_allclose(tpts[0].numpy(), np.asarray(jp), rtol=0, atol=1e-9)
    assert int(tgood.sum()) >= 3


@pytest.mark.parametrize("window", [51, 71])
def test_track_level_plain_matches_jax_wide_windows(window):
    """Windows the earlier CUDA kernel refused (wider than 45 px), on a
    level-1-sized image with features near its borders too."""
    rng = np.random.default_rng(window)
    img0 = _smooth_image(rng, (240, 376))
    img1 = _shift_image(img0, 2.1, -1.4)
    pts, pred = _lk_points(rng, 10, 240, 376, 20)
    pts[:2] = [[5.0, 230.0], [370.0, 8.0]]
    valid = np.ones(len(pts), bool)
    valid[3] = False
    jp, jg = jklt._track_level(jnp.asarray(img0, jnp.float64), jnp.asarray(img1, jnp.float64),
                               jnp.asarray(pts), jnp.asarray(pred), jnp.asarray(valid),
                               window // 2, 30, 0.03, 1e-4)
    tpts, tgood = klt_cuda.track_level_plain(
        _t(img0[None]), _t(img1[None]), _t(pts[None]), _t(pred[None]), torch.as_tensor(valid[None]),
        window_size=window, max_iters=30, eps=0.03, min_eigen_threshold=1e-4)
    np.testing.assert_array_equal(tgood[0].numpy(), np.asarray(jg))
    np.testing.assert_allclose(tpts[0].numpy(), np.asarray(jp), rtol=0, atol=1e-9)
    assert int(tgood.sum()) >= 5


@pytest.mark.parametrize("case", ["interior", "right-edge-level2"])
def test_track_level_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(3 if case == "interior" else 5)
    if case == "interior":
        img0 = _smooth_image(rng, (96, 144))
        img1 = _shift_image(img0, 1.7, -1.2)
        pts, pred = _lk_points(rng, 16, 96, 144, 30)
        window, eps, thr = 15, 0.03, 1e-4
    else:   # tests/test_klt_pallas.py:127-150's fixture: 120 x 188 is level 2 of 480 x 752
        img0 = _smooth_image(rng, (120, 188))
        img1 = _shift_image(img0, 1.3, 0.8)
        pts = np.stack([[40.0, 120.0, 132.0, 150.0, 165.0, 174.0],
                        [30.0, 55.0, 80.0, 95.0, 60.0, 40.0]], -1)
        pred = pts
        window, eps, thr = 21, 1.0, 1e-5
    pts, pred = pts.astype(np.float32), pred.astype(np.float32)
    valid = np.ones(len(pts), bool)
    jp, jg = klt_pallas.track_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                                    jnp.asarray(pred), jnp.asarray(valid), window_size=window,
                                    max_iters=30, eps=eps, min_eigen_threshold=thr, interpret=True)
    tpts, tgood = klt_cuda.track_level(
        _t(img0[None], torch.float32), _t(img1[None], torch.float32),
        _t(pts[None], torch.float32), _t(pred[None], torch.float32), torch.as_tensor(valid[None]),
        window_size=window, max_iters=30, eps=eps, min_eigen_threshold=thr)
    np.testing.assert_array_equal(tgood[0].numpy(), np.asarray(jg))
    np.testing.assert_allclose(tpts[0].numpy(), np.asarray(jp), rtol=0, atol=0.05)


@pytest.mark.parametrize("window,levels", [(21, 3), (51, 4)])
def test_track_features_pyr_matches_jax(window, levels):
    """At window 51, levels 4 (15 x 24 px) and 3 (30 x 47 px) of 240 x 376
    are smaller than the window: the cv2 clamp drops both."""
    rng = np.random.default_rng(11)
    H, W = (120, 160) if window == 21 else (240, 376)
    img0 = _smooth_image(rng, (H, W)).astype(np.float64)
    img1 = _shift_image(img0, -3.3, 2.6).astype(np.float64)
    pts, _ = _lk_points(rng, 12, H, W, 30)
    valid = np.ones(len(pts), bool)
    valid[3] = False
    p0, p1 = jklt.build_pyramid(jnp.asarray(img0), levels), jklt.build_pyramid(jnp.asarray(img1), levels)
    jp, js = jklt.track_features_pyr(p0, p1, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid),
                                     window_size=window, use_pallas=False)
    t0, t1 = tklt.build_pyramid(_t(img0[None]), levels), tklt.build_pyramid(_t(img1[None]), levels)
    tp_, ts_ = tklt.track_features_pyr(t0, t1, _t(pts[None]), _t(pts[None]),
                                       torch.as_tensor(valid[None]), window_size=window)
    np.testing.assert_array_equal(ts_[0].numpy(), np.asarray(js))
    np.testing.assert_allclose(tp_[0].numpy(), np.asarray(jp), rtol=0, atol=1e-9)
    ok = np.asarray(js)
    assert ok.sum() >= 6
    np.testing.assert_allclose(tp_[0].numpy()[ok] - pts[ok], np.tile([-3.3, 2.6], (ok.sum(), 1)),
                               atol=0.3)


def test_reject_outliers_matches_jax():
    rng = np.random.default_rng(12)
    prev = rng.uniform(-20, 780, size=(3, 50, 2))
    cur = prev + rng.normal(0, 15, size=prev.shape)
    status = rng.uniform(size=(3, 50)) < 0.8
    got = tklt.reject_outliers(_t(prev), _t(cur), torch.as_tensor(status), (480, 752), 25.0)
    for b in range(3):
        want = jklt.reject_outliers(jnp.asarray(prev[b]), jnp.asarray(cur[b]), jnp.asarray(status[b]),
                                    (480, 752), 25.0)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(status.sum())


def test_grid_dedup_matches_jax():
    """Points crowd a few cells, so most cells hold several and keep the first."""
    rng = np.random.default_rng(13)
    N, B = 60, 3
    pts = rng.uniform(0, 1, size=(B, N, 2)) * np.array([752.0, 480.0]) * 0.4
    pts[:, ::9] = [[-5.0, 700.0]]      # off the image: clipped into an edge cell
    ids = rng.integers(0, 1000, size=(B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) < 0.7
    gp, gi, gv = tfunc._grid_dedup(_t(pts), torch.as_tensor(ids), torch.as_tensor(valid),
                                   480, 752, 10, 10, 32)
    for b in range(B):
        wp, wi, wv = jfunc._grid_dedup(jnp.asarray(pts[b]), jnp.asarray(ids[b]),
                                       jnp.asarray(valid[b]), 480, 752, 10, 10, 32)
        np.testing.assert_array_equal(gv[b].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi[b].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gp[b].numpy(), np.asarray(wp))
        assert 0 < int(gv[b].sum()) < int(valid[b].sum())


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the kernels' wrappers run the plain versions and count
    no launch."""
    img = torch.as_tensor(_corner_image(np.random.default_rng(0), (64, 96))[None])
    pts = torch.full((1, 2, 2), 40.0)
    before = (fast_cuda.fast_nms_score.launches, klt_cuda.track_level.launches)
    assert torch.equal(fast_cuda.fast_nms_score(img), fast_cuda.fast_nms_score_plain(img))
    got = klt_cuda.track_level(img, img, pts, pts, torch.ones(1, 2, dtype=torch.bool))
    want = klt_cuda.track_level_plain(img, img, pts, pts, torch.ones(1, 2, dtype=torch.bool))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fast_cuda.fast_nms_score.launches, klt_cuda.track_level.launches) == before
    with pytest.raises(ValueError):
        klt_cuda.track_level(img, img, pts, pts, torch.ones(2, 2, dtype=torch.bool))
