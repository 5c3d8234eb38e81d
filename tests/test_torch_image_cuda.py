"""The FAST-10+NMS and LK-level CUDA kernels (csrc/fast_nms.cu, csrc/klt_level.cu) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_image_cuda.py -q

* FAST: the kernel equals its plain version bit for bit, at ragged shapes and
  at Bi in {1, 3}, on random and rendered images.
* KLT: the kernel's good flags equal the plain version's and its positions
  are within 0.05 px (the window is summed in another order; eps = 0.03 px
  keeps a stop test that fires one iteration apart below that), with shared
  and per-stream images, F in {1, 7, 64}, right-edge features at pyramid
  level 2 and features whose window leaves the image.
* The wrappers raise on float64, on CPU/CUDA mixes and on non-contiguous
  input, and count their launches.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import klt
from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda
from msckf_mono_tpu_torch.utils.config import MsckfConfig

pytestmark = pytest.mark.cuda

KLT_ATOL = 0.05


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def frames():
    """Two consecutive rendered 480 x 752 frames of the synthetic world."""
    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=6, seed=0, pixel_noise=0.0, n_landmarks=500,
                                  return_world=True)
    return np.stack([render.render_frame(cfg, world, i) for i in (4, 5)])


def _smooth_image(rng, shape, octaves=4):
    """Band-limited random image, so LK has usable gradients everywhere."""
    img = np.zeros(shape, np.float32)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = rng.uniform(0, 1, size=(shape[0] // s + 2, shape[1] // s + 2))
        img += np.kron(small, np.ones((s, s)))[: shape[0], : shape[1]].astype(np.float32) * 2.0**o
    img -= img.min()
    return img * (255.0 / img.max())


def _shift_image(img, dx, dy):
    """Subpixel shift by bilinear resampling (content moves by +dx, +dy)."""
    H, W = img.shape
    ys = np.clip(np.arange(H)[:, None] - dy, 0, H - 1.001)
    xs = np.clip(np.arange(W)[None, :] - dx, 0, W - 1.001)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = ys - y0, xs - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 201, 300), (3, 97, 131), (1, 480, 752), (3, 64, 96)])
def test_fast_kernel_equals_plain(card, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 255, size=shape).astype(np.float32)
    for y, x in [(20, 30), (40, 70), (shape[1] - 10, shape[2] - 20)]:
        img[:, y - 2 : y + 3, x - 2 : x + 3] = 10.0
        img[:, y, x] = 250.0
    t = torch.as_tensor(img, device=card)
    before = fast_cuda.fast_nms_score.launches
    got = fast_cuda.fast_nms_score(t, 20.0)
    torch.cuda.synchronize()
    assert fast_cuda.fast_nms_score.launches == before + 1
    want = fast_cuda.fast_nms_score_plain(t, 20.0)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 0


def test_fast_kernel_equals_plain_on_rendered_frames(card, frames):
    t = torch.as_tensor(frames, device=card)
    for imgs in (t[:1], t, t[:, 13:214, 7:307].contiguous()):
        got = fast_cuda.fast_nms_score(imgs, 20.0)
        want = fast_cuda.fast_nms_score_plain(imgs, 20.0)
        assert torch.equal(got, want)
        assert int((want > 0).sum()) > 20


def _klt_pair(card, plain_imgs, pts, pred, valid, window, eps=0.03, iters=30, thr=1e-4):
    img0, img1 = (torch.as_tensor(a, device=card) for a in plain_imgs)
    args = [torch.as_tensor(a, device=card) for a in (pts, pred)]
    v = torch.as_tensor(valid, device=card)
    before = klt_cuda.track_level.launches
    got = klt_cuda.track_level(img0, img1, *args, v, window_size=window, max_iters=iters,
                               eps=eps, min_eigen_threshold=thr)
    torch.cuda.synchronize()
    assert klt_cuda.track_level.launches == before + 1
    want = klt_cuda.track_level_plain(img0, img1, *args, v, window_size=window, max_iters=iters,
                                      eps=eps, min_eigen_threshold=thr)
    return got, want


def _assert_klt_close(got, want):
    assert torch.equal(got[1], want[1])
    good = want[1]
    err = (got[0] - want[0]).abs().amax(-1)
    assert bool((err[good] < KLT_ATOL).all()), float(err.max())
    # features that are not good keep their starting point exactly
    assert torch.equal(got[0][~good], want[0][~good])


@pytest.mark.parametrize("F", [1, 7, 64])
@pytest.mark.parametrize("shared", [True, False])
def test_klt_kernel_matches_plain(card, F, shared):
    rng = np.random.default_rng(F)
    B, H, W = 3, 96, 144
    base = [_smooth_image(rng, (H, W)) for _ in range(1 if shared else B)]
    img0 = np.stack(base)
    img1 = np.stack([_shift_image(b, 1.7, -1.2) for b in base])
    pts = np.stack([rng.uniform(20, W - 20, size=(B, F)), rng.uniform(20, H - 20, size=(B, F))],
                   -1).astype(np.float32)
    pred = (pts + rng.normal(0, 1.0, size=pts.shape)).astype(np.float32)
    valid = np.ones((B, F), bool)
    valid[:, 1::5] = False
    for window in (15, 21):
        got, want = _klt_pair(card, (img0, img1), pts, pred, valid, window)
        _assert_klt_close(got, want)
        assert bool(want[1].any())


def test_klt_kernel_right_edge_level2(card):
    """Right-edge features on a level-2-sized image (120 x 188 of 480 x 752):
    the window base clamp there once took the image ATE from 0.25 to 1.05 m."""
    rng = np.random.default_rng(5)
    img0 = _smooth_image(rng, (120, 188))
    img1 = _shift_image(img0, 1.3, 0.8)
    xs = np.array([40.0, 120.0, 132.0, 150.0, 165.0, 174.0, 180.0, 186.5])
    ys = np.array([30.0, 55.0, 80.0, 95.0, 60.0, 40.0, 70.0, 50.0])
    pts = np.stack([xs, ys], -1)[None].astype(np.float32)
    valid = np.ones((1, len(xs)), bool)
    got, want = _klt_pair(card, (img0[None], img1[None]), pts, pts, valid, 21, eps=1.0,
                          thr=1e-5)
    _assert_klt_close(got, want)


def test_klt_kernel_window_leaves_image(card, frames):
    """Features near every edge and corner of a rendered level, and off it:
    each sample is clamped in both versions, so they agree there too."""
    pyr0 = klt.build_pyramid(torch.as_tensor(frames[:1], device=card), 3)
    pyr1 = klt.build_pyramid(torch.as_tensor(frames[1:], device=card), 3)
    for lvl in range(4):
        H, W = pyr0[lvl].shape[-2:]
        xs = np.array([0.0, 2.5, W / 2, W - 3.2, W - 1.0, W + 4.0, 5.0, W - 6.0, -3.0])
        ys = np.array([0.0, H / 2, 1.5, H - 2.7, H - 1.0, H / 3, H - 5.0, 4.0, 10.0])
        pts = np.stack([xs, ys], -1)[None].astype(np.float32)
        valid = np.ones((1, len(xs)), bool)
        got, want = _klt_pair(card, (pyr0[lvl].cpu().numpy(), pyr1[lvl].cpu().numpy()), pts, pts,
                              valid, 21, eps=0.03, thr=1e-5)
        _assert_klt_close(got, want)


def test_wrappers_reject_wrong_input(card):
    img = torch.rand(2, 40, 50, device=card) * 255
    with pytest.raises(TypeError):
        fast_cuda.fast_nms_score(img.double())
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_score(img.transpose(1, 2))
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_score(img[0])

    pts = torch.full((2, 3, 2), 20.0, device=card)
    valid = torch.ones(2, 3, dtype=torch.bool, device=card)
    before = klt_cuda.track_level.launches
    with pytest.raises(TypeError):
        klt_cuda.track_level(img.double(), img.double(), pts, pts, valid)
    with pytest.raises(ValueError):
        klt_cuda.track_level(img, img.cpu(), pts, pts, valid)
    with pytest.raises(ValueError):
        klt_cuda.track_level(img, img, pts.cpu(), pts, valid)
    with pytest.raises(ValueError):
        klt_cuda.track_level(img.transpose(1, 2).contiguous().transpose(1, 2), img, pts, pts, valid)
    with pytest.raises(RuntimeError, match="window 51"):
        klt_cuda.track_level(img, img, pts, pts, valid, window_size=51)
    assert klt_cuda.track_level.launches == before
    # the failed launches left no error behind
    out, good = klt_cuda.track_level(img, img, pts, pts, valid, window_size=7)
    assert klt_cuda.track_level.launches == before + 1
    assert out.shape == (2, 3, 2) and good.dtype == torch.bool
