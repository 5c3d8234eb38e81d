"""The FAST-10+NMS and LK-level CUDA kernels (csrc/fast_nms.cu, csrc/klt_level.cu) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_image_cuda.py -q

* FAST: the kernel equals its plain version bit for bit, in one launch, at
  ragged, odd-width and tiny shapes (5 x 5 up), at Bi in {1, 2, 3, 64}, on
  random, rendered and flat images, on arcs whose differences are exactly the
  threshold or one ulp above it, at thresholds -5, 0, 20 and 20.3, and on a
  contiguous view 4 bytes past a 16-byte boundary (the 4-byte variant).
* KLT: the kernel's good flags equal the plain version's and its positions
  are within 0.05 px (the window is summed in another order; eps = 0.03 px
  keeps a stop test that fires one iteration apart below that), with shared
  and per-stream images, F in {1, 7, 64}, right-edge features at pyramid
  level 2 and features whose window leaves the image.
* KLT takes any window: 51 and 71 px stage in shared memory, 171 px runs
  the variant without shared memory; the launcher's plan fits the card for
  every odd window of 3..151 px. Its patch copies are 16, 8 or 4 bytes a
  lane, by the rows' alignment.
* At Bi = 64, on 64 robots' own rendered frames (robot b sees the loop's
  frame 5b + t, as the multi-robot benchmark cell): FAST equals its plain
  version bit for bit; KLT, from each robot's own detected corners through
  the four pyramid levels, keeps the rules above.
* The wrappers raise on float64, on CPU/CUDA mixes and on non-contiguous
  input, and count their launches.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import detect, klt
from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda
from msckf_mono_tpu_torch.utils.config import MsckfConfig

pytestmark = pytest.mark.cuda

KLT_ATOL = 0.05
ROBOTS, PHASE_STEP = 64, 5


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


@pytest.fixture(scope="module")
def robots():
    """(2, 64, 480, 752): robot b's frames t = 0 and 1, the loop's frames
    5b and 5b + 1, rendered on the host (the check is inside: a module
    fixture is made before the function-scoped ``card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=PHASE_STEP * (ROBOTS - 1) + 2, seed=0,
                                  pixel_noise=0.0, n_landmarks=500, return_world=True)
    return np.stack([[render.render_frame(cfg, world, PHASE_STEP * b + t) for b in range(ROBOTS)]
                     for t in (0, 1)]).astype(np.float32)


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


def _arcs(threshold, bright, ulps):
    """Centres on a 0 background, each with one arc of 10 circle pixels (every
    start position of the 16) at d >= t, its compass points at exactly t, or
    t + ``ulps`` ulps; the other 6 circle pixels at 0 (d = 0). Above t = 0
    the step is the least normal float32: the JAX package's CPU backend
    flushes subnormals to zero."""
    t = np.float32(threshold)
    edge = t
    for _ in range(ulps):
        edge = np.nextafter(edge, np.float32(np.inf))
    if ulps and t == 0:
        edge = np.finfo(np.float32).tiny
    sign = np.float32(1.0 if bright else -1.0)
    img = np.zeros((2 * 12, 8 * 12), np.float32)
    centres = []
    for k in range(16):
        y, x = 6 + 12 * (k // 8), 6 + 12 * (k % 8)
        for j in range(10):
            dx, dy = fast_cuda.FAST_OFFSETS[(k + j) % 16]
            # compass points (0, 4, 8, 12) at the edge value, the rest above it
            v = edge if (k + j) % 4 == 0 else np.float32(edge + np.float32(7.0))
            img[y + dy, x + dx] = sign * v
        centres.append((y, x))
    return img[None], centres


def _fast_once(t, threshold=20.0):
    """One kernel launch on t, bit for bit the plain version's output."""
    before = fast_cuda.fast_nms_score.launches
    got = fast_cuda.fast_nms_score(t, threshold)
    torch.cuda.synchronize()
    assert fast_cuda.fast_nms_score.launches == before + 1
    want = fast_cuda.fast_nms_score_plain(t, threshold)
    assert torch.equal(got, want), f"{int((got != want).sum())} pixels differ"
    return want


def test_fast_kernel_on_a_misaligned_view(card):
    """A contiguous view 4 bytes past a 16-byte boundary takes the 4-byte
    variant; the aligned base the 16-byte one."""
    rng = np.random.default_rng(11)
    flat = torch.as_tensor(rng.uniform(0, 255, size=2 * 96 * 128 + 1).astype(np.float32),
                           device=card)
    view = flat[1:].view(2, 96, 128)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert fast_cuda.launch_variant(view) == "scalar"
    assert int((_fast_once(view) > 0).sum()) > 0
    base = flat[:-1].view(2, 96, 128)
    assert fast_cuda.launch_variant(base) == "vector"
    _fast_once(base)


@pytest.mark.parametrize("shape", [(2, 60, 301), (1, 45, 131), (1, 5, 5), (1, 7, 9), (2, 33, 17)])
def test_fast_kernel_at_odd_and_small_shapes(card, shape):
    """Odd widths (the 4-byte variant) and images smaller than a tile, down
    to 5 x 5, where no pixel is 3 px from every edge."""
    img = np.random.default_rng(sum(shape)).uniform(0, 255, size=shape).astype(np.float32)
    t = torch.as_tensor(img, device=card)
    assert fast_cuda.launch_variant(t) == ("vector" if shape[2] % 4 == 0 else "scalar")
    want = _fast_once(t)
    if min(shape[1:]) < 7:
        assert not bool(want.any())


@pytest.mark.parametrize("threshold", [20.0, 0.0, -5.0])
def test_fast_kernel_on_a_flat_image(card, threshold):
    """Every difference 0: no corner at t >= 0; at t = -5 every interior
    pixel scores 0 > t and ties all its neighbours, so NMS keeps it with 0."""
    _fast_once(torch.full((1, 40, 100), 128.0, device=card), threshold)


@pytest.mark.parametrize("ulps", [0, 1])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 20.0, 20.3])
def test_fast_kernel_on_exact_threshold_arcs(card, threshold, bright, ulps):
    img, centres = _arcs(threshold, bright, ulps)
    want = _fast_once(torch.as_tensor(img, device=card), threshold)
    for y, x in centres:
        assert (float(want[0, y, x]) > threshold) == (ulps == 1)


def test_fast_kernel_on_random_image_at_threshold_zero(card):
    """Uniform noise at t = 0: nearly every pixel is a candidate."""
    img = np.random.default_rng(2).uniform(0, 255, size=(1, 480, 752)).astype(np.float32)
    t = torch.as_tensor(img, device=card)
    assert float(fast_cuda.fast_pretest_plain(t, 0.0).float().mean()) > 0.9
    _fast_once(t, 0.0)


def test_fast_kernel_on_a_rendered_batch_of_64(card, frames):
    """(64, 480, 752): the 64-stream path's launch, with its brightness offsets."""
    t = torch.as_tensor(frames[:1], device=card)
    batch = (t + 0.5 * (torch.arange(64, device=card) % 7)[:, None, None]).contiguous()
    assert int((_fast_once(batch) > 0).sum()) > 64 * 20


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


@pytest.mark.parametrize("W", [144, 146, 143])
def test_klt_kernel_copy_widths(card, W):
    """Rows 16-byte aligned (W = 144), 8-byte aligned (146) and neither (143):
    the patch is staged 16, 8 or 4 bytes a lane; features by both side edges
    too."""
    rng = np.random.default_rng(W)
    B, F, H = 2, 12, 90
    img0 = _smooth_image(rng, (H, W))
    img1 = _shift_image(img0, 1.1, -0.7)
    xs = np.concatenate([[0.5, 3.0, W - 4.5, W - 1.2], rng.uniform(0, W, size=F - 4)])
    pts = np.stack([np.broadcast_to(xs, (B, F)), rng.uniform(5, H - 5, size=(B, F))],
                   -1).astype(np.float32)
    pred = (pts + rng.normal(0, 0.8, size=pts.shape)).astype(np.float32)
    valid = np.ones((B, F), bool)
    got, want = _klt_pair(card, (img0[None], img1[None]), pts, pred, valid, 21)
    _assert_klt_close(got, want)
    assert bool(want[1].any())


def test_klt_launch_plan_fits_every_window(card):
    """Every odd window of 3..151 px gets the staged variant within this
    card's shared memory a block, or the global variant, which uses none."""
    limit = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 232448)
    seen = set()
    for window in range(3, 152, 2):
        plan = klt_cuda.launch_plan(window)
        seen.add(plan.variant)
        assert plan.smem_bytes <= limit and 1 <= plan.warps <= 4
        assert plan.variant == "staged" or plan.smem_bytes == 0
    assert seen == set(klt_cuda.VARIANTS)
    assert klt_cuda.launch_plan(21) == klt_cuda.LaunchPlan("staged", 4, 4 * 8368)
    assert klt_cuda.launch_plan(117).variant == "staged"
    assert klt_cuda.launch_plan(119).variant == "global"


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
    assert klt_cuda.track_level.launches == before
    out, good = klt_cuda.track_level(img, img, pts, pts, valid, window_size=7)
    assert klt_cuda.track_level.launches == before + 1
    assert out.shape == (2, 3, 2) and good.dtype == torch.bool


@pytest.mark.parametrize("window", [51, 71, 171])
def test_klt_kernel_wide_windows(card, window):
    """Windows of 51 and 71 px (the staged variant) and 171 px (beyond one
    block's shared memory: the global variant), on a level-1-sized image,
    against the plain version."""
    assert klt_cuda.launch_plan(window).variant == ("global" if window == 171 else "staged")
    rng = np.random.default_rng(window)
    B, F, H, W = 2, 9, 240, 376
    img0 = _smooth_image(rng, (H, W))
    img1 = _shift_image(img0, -2.2, 1.4)
    pts = np.stack([rng.uniform(0, W, size=(B, F)), rng.uniform(0, H, size=(B, F))],
                   -1).astype(np.float32)
    pred = (pts + rng.normal(0, 1.0, size=pts.shape)).astype(np.float32)
    valid = np.ones((B, F), bool)
    valid[:, ::4] = False
    got, want = _klt_pair(card, (img0[None], img1[None]), pts, pred, valid, window)
    _assert_klt_close(got, want)
    assert bool(want[1].any())


def test_fast_kernel_on_64_robots(card, robots):
    """(64, 480, 752) of 64 robots' own frames: one launch, bit for bit the
    plain version; each robot finds corners of its own."""
    want = _fast_once(torch.as_tensor(robots[0], device=card))
    assert bool(((want > 0).sum((1, 2)) > 20).all())
    assert not torch.equal(want[0] > 0, want[1] > 0)


def test_klt_kernel_on_64_robots(card, robots):
    """Each robot's features at its own corners of frame 0 (FAST +
    Shi-Tomasi, as the front-end detects them), predicted with noise,
    tracked into its frame 1 at every level of its own pyramid, top level
    first, with the front-end's window, against the plain version."""
    img0, img1 = (torch.as_tensor(robots[t], device=card) for t in (0, 1))
    pyr0, pyr1 = klt.build_pyramid(img0, 3), klt.build_pyramid(img1, 3)
    xy, _, valid = detect.detect_features(
        img0, torch.zeros(ROBOTS, 100, dtype=torch.bool, device=card))
    assert bool((valid.sum(1) > 20).all())
    rng = np.random.default_rng(64)
    pred = xy + torch.as_tensor(rng.normal(0, 1.0, size=tuple(xy.shape)), dtype=torch.float32,
                                device=card)
    for lvl in (3, 2, 1, 0):
        s = 2.0 ** lvl
        got, want = _klt_pair(card, (pyr0[lvl].cpu().numpy(), pyr1[lvl].cpu().numpy()),
                              (xy / s).cpu().numpy(), (pred / s).cpu().numpy(),
                              valid.cpu().numpy(), 21, eps=0.03, thr=1e-5)
        _assert_klt_close(got, want)
        assert int(want[1].sum()) > 10 * ROBOTS
