"""The Shi-Tomasi score + per-cell best CUDA kernel (csrc/shi_tomasi.cu) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_shi_tomasi_cuda.py -q

The kernel (``ops/shi_tomasi_cuda.shi_tomasi_cells``) is held to the plain
version computed in float64 on the same float32 images and the same FAST/NMS
map, cell by cell:

* ``best`` within ``_tol`` of the float64 best. The kernel takes dx and dy as
  float32 differences (the float64 version's are exact), sums their
  products in float64 and rounds the eigenvalue to float32 once: ~6e-8
  relative. REL_TOL = 1e-5 leaves a factor of ~100 for the cancellation in
  tr^2 - 4 det where the two eigenvalues differ much; ABS_TOL = 1e-4 (grey
  levels squared, against scores of 40 and more that matter) covers scores
  near 0, whose error scales with the larger eigenvalue instead;
* ``local`` equal wherever the cell's float64 top-two gap exceeds the
  tolerance; elsewhere the chosen pixel's float64 score within it of the
  cell's maximum;
* ``valid = best > 40`` equal except within the tolerance of 40;
* on an integer-valued periodic image every sum is exact in both, so equal
  patches give equal scores: the smallest index wins, exactly;
* one launch a call, on rendered frames (Bi = 1), on 64 robots' own frames,
  on random images, at odd and small shapes (no interior pixel at all
  included), on 8 x 12 and other grids, with half-widths 7 and 10, and on one cell
  wider than a block stages at once;
* the wrapper raises on float64, on non-contiguous input, on mixed devices
  and on sizes it does not take.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import detect
from msckf_mono_tpu_torch.ops import fast_cuda, shi_tomasi_cuda
from msckf_mono_tpu_torch.utils.config import MsckfConfig

from tests.test_torch_image_cuda import PHASE_STEP, ROBOTS, _smooth_image

pytestmark = pytest.mark.cuda

REL_TOL, ABS_TOL = 1e-5, 1e-4
DETECTION_THRESHOLD = 40.0


def _tol(v):
    return REL_TOL * v.abs() + ABS_TOL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def robot_frames():
    """(64, 480, 752): robot b's first frame, the loop's frame 5b, rendered on
    the host (the check is inside: a module fixture is made before the
    function-scoped ``card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=PHASE_STEP * (ROBOTS - 1) + 1, seed=0,
                                  pixel_noise=0.0, n_landmarks=500, return_world=True)
    return np.stack([render.render_frame(cfg, world, PHASE_STEP * b)
                     for b in range(ROBOTS)]).astype(np.float32)


def _cells(imgs, nms, halfbox, n_rows, n_cols):
    """One launch on the card; returns (best, local, float64 tiles)."""
    before = shi_tomasi_cuda.shi_tomasi_cells.launches
    best, local = shi_tomasi_cuda.shi_tomasi_cells(imgs, nms, halfbox, n_rows, n_cols)
    torch.cuda.synchronize()
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before + 1
    assert best.dtype == torch.float32 and local.dtype == torch.int64
    assert best.shape == local.shape == (imgs.shape[0], n_rows * n_cols)
    st64 = shi_tomasi_cuda.shi_tomasi_score_plain(imgs.double(), halfbox)
    flat = shi_tomasi_cuda.cell_tiles(torch.where(nms > 0, st64, torch.full_like(st64, -1.0)),
                                      n_rows, n_cols)
    return best, local, flat


def _check(card, imgs, halfbox=15, n_rows=10, n_cols=10, threshold=20.0):
    """The kernel against the float64 plain version by the rules above.
    Returns (best, largest error of best, cells whose f64 best is a corner)."""
    imgs = torch.as_tensor(imgs, device=card)
    nms = fast_cuda.fast_nms_score(imgs, threshold)
    best, local, flat = _cells(imgs, nms, halfbox, n_rows, n_cols)
    want_best, want_local = flat.max(-1)
    tol = _tol(want_best)
    err = (best.double() - want_best).abs()
    assert bool((err <= tol).all()), f"best off by {float(err.max())} (tolerance {float(tol.max())})"
    top2 = flat.topk(2, dim=-1).values if flat.shape[-1] > 1 else flat.expand(-1, -1, 2)
    clear = (top2[..., 0] - top2[..., 1]) > tol
    assert torch.equal(local[clear], want_local[clear])
    chosen = flat.gather(-1, local[..., None])[..., 0]
    assert bool(((want_best - chosen) <= tol).all())
    near = (want_best - DETECTION_THRESHOLD).abs() <= _tol(torch.full_like(want_best,
                                                                           DETECTION_THRESHOLD))
    assert torch.equal((best > DETECTION_THRESHOLD)[~near], (want_best > DETECTION_THRESHOLD)[~near])
    return best, float(err.max()), int((want_best > -1).sum())


def test_kernel_on_a_rendered_frame(card):
    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=6, seed=0, pixel_noise=0.0, n_landmarks=500,
                                  return_world=True)
    frame = render.render_frame(cfg, world, 5)[None].astype(np.float32)
    best, _, corners = _check(card, frame)
    assert corners > 30 and int((best > DETECTION_THRESHOLD).sum()) > 20


def test_kernel_on_64_robots(card, robot_frames):
    """(64, 480, 752): the per-stream path's launch, each robot its own frame."""
    best, _, corners = _check(card, robot_frames)
    assert corners > 64 * 30
    assert bool(((best > DETECTION_THRESHOLD).sum(1) > 10).all())


@pytest.mark.parametrize("shape", [(1, 480, 752), (3, 97, 131), (2, 201, 300)])
def test_kernel_on_random_images(card, shape):
    """Uniform noise: FAST marks pixels all over, so most cells' boxes span the
    whole interior part of the cell (a middle cell's 49 rows in two sub-tiles)."""
    img = np.random.default_rng(sum(shape)).uniform(0, 255, size=shape).astype(np.float32)
    _, _, corners = _check(card, img)
    assert corners > shape[0] * 50


@pytest.mark.parametrize("shape", [(1, 5, 5), (1, 20, 25), (2, 33, 17), (1, 45, 131), (2, 60, 301),
                                   (1, 36, 36)])
def test_kernel_at_odd_and_small_shapes(card, shape):
    """Cells smaller than a warp, odd widths, and images with no interior
    pixel at all (every marked pixel scores 0) or a few rows of them."""
    img = np.random.default_rng(sum(shape)).uniform(0, 255, size=shape).astype(np.float32)
    best, _, _ = _check(card, img)
    if min(shape[1:]) < 2 * 15 + 3:
        assert bool((best <= 0).all())


@pytest.mark.parametrize("halfbox,n_rows,n_cols", [(15, 8, 12), (7, 10, 10), (10, 8, 12),
                                                   (15, 1, 1), (15, 2, 3)])
def test_kernel_other_grids_and_half_widths(card, halfbox, n_rows, n_cols):
    """Other grids and boxes; one 1 x 1 grid cell of a 480 x 752 image is
    wider than a block stages at once, so its box is cut by columns too."""
    rng = np.random.default_rng(halfbox * 100 + n_rows * 10 + n_cols)
    imgs = np.stack([_smooth_image(rng, (480, 752)) for _ in range(2)])
    imgs[1] += rng.uniform(0, 40, size=imgs[1].shape).astype(np.float32)
    if (n_rows, n_cols) == (1, 1):
        th, tw, smem = shi_tomasi_cuda.launch_plan(480, 752, halfbox, 1, 1)
        assert th == 1 and tw < 752 and smem > 0
    _check(card, imgs, halfbox, n_rows, n_cols)


def _periodic_image(H, W, period):
    """Integer grey levels that repeat every ``period`` px in both axes: every
    product and sum is an exact integer in float32 and float64, so two
    marked pixels a multiple of the period apart score exactly the same."""
    y, x = np.mgrid[:H, :W]
    return (((y % period) * 37 + (x % period) * 11 + (y % period) * (x % period) * 5) % 97
            + 20).astype(np.float32)


def test_kernel_tie_break_takes_the_smallest_index(card):
    H, W, period = 480, 752, 8
    img = torch.as_tensor(_periodic_image(H, W, period)[None], device=card)
    img[0, :60, :60] = 100.0
    gh, gw = H // 10 + 1, W // 10 + 1
    # Cell (2, 3) spans rows 98..146 and columns 228..303. Of its pixels
    # (105 + dy, 237 + dx), the offset scoring highest is marked at four
    # places a period apart, equal scores, and the one scoring lowest once.
    st64 = shi_tomasi_cuda.shi_tomasi_score_plain(img.double(), 15)[0]
    offs = [(dy, dx) for dy in range(period) for dx in range(period)]
    ranked = sorted(offs, key=lambda o: float(st64[105 + o[0], 237 + o[1]]))
    (ly, lx), (hy, hx) = ranked[0], ranked[-1]
    ties = [(113 + hy, 245 + hx), (105 + hy, 253 + hx), (105 + hy, 237 + hx), (121 + hy, 237 + hx)]
    nms = torch.zeros_like(img)
    for y, x in ties + [(105 + ly, 237 + lx)]:
        nms[0, y, x] = 1.0
    # cell (0, 0): an interior mark on the flat patch (score 0) after a mark
    # outside the interior (score 0 too): the smaller index wins
    nms[0, 20, 20] = 1.0
    nms[0, 3, 30] = 1.0
    best, local, flat = _cells(img, nms, 15, 10, 10)
    c = 2 * 10 + 3
    scores = {float(flat[0, c, (y - 98) * gw + (x - 228)]) for y, x in ties}
    assert len(scores) == 1
    tie = scores.pop()
    assert tie > float(flat[0, c, (105 + ly - 98) * gw + (237 + lx - 228)])
    assert int(local[0, c]) == (105 + hy - 98) * gw + (237 + hx - 228)
    assert float(best[0, c]) == np.float32(tie)
    assert float(best[0, 0]) == 0.0 and int(local[0, 0]) == 3 * gw + 30
    # every cell without a mark: -1 at index 0, as torch.max over a tile of -1
    marked = shi_tomasi_cuda.cell_tiles(nms).amax(-1)[0] > 0
    assert int(marked.sum()) == 2
    assert bool((best[0][~marked] == -1).all()) and bool((local[0][~marked] == 0).all())
    assert gh == 49


def test_detect_features_routes_by_tier(card, robot_frames):
    """At "highest" detect_features launches the kernel once a call; at
    "default" (TF32) it keeps the banded products and launches none. Both
    give the 64 robots' corners, and agree away from ties."""
    imgs = torch.as_tensor(robot_frames[:8], device=card)
    occ = torch.zeros(8, 100, dtype=torch.bool, device=card)
    occ[:, ::3] = True
    before = shi_tomasi_cuda.shi_tomasi_cells.launches
    xy, score, valid = detect.detect_features(imgs, occ)
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before + 1
    xy_d, _, valid_d = detect.detect_features(imgs, occ, st_precision="default")
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before + 1
    assert not bool(valid[occ].any()) and int(valid.sum()) > 8 * 20
    same = valid & valid_d
    assert float((xy[same] == xy_d[same]).all(-1).float().mean()) > 0.9
    assert bool((score[valid] > DETECTION_THRESHOLD).all())


def test_wrapper_rejects_wrong_input(card):
    img = torch.rand(2, 64, 80, device=card) * 255
    nms = fast_cuda.fast_nms_score(img, 20.0)
    before = shi_tomasi_cuda.shi_tomasi_cells.launches
    with pytest.raises(TypeError):
        shi_tomasi_cuda.shi_tomasi_cells(img.double(), nms.double())
    with pytest.raises(TypeError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms.double())
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img.transpose(1, 2), nms.transpose(1, 2))
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms.cpu())
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img[0], nms[0])
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms, halfbox=0)
    with pytest.raises(RuntimeError):    # a box the launcher's shared memory cannot hold
        shi_tomasi_cuda.shi_tomasi_cells(torch.rand(1, 400, 400, device=card), nms[:1, :1, :1]
                                         .expand(1, 400, 400).contiguous(), halfbox=150)
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before
    assert shi_tomasi_cuda.launch_plan(400, 400, 150) is None
    best, local = shi_tomasi_cuda.shi_tomasi_cells(img, nms)
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before + 1
    assert best.shape == local.shape == (2, 100)
