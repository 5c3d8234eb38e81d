"""The FAST kernel's exact four-point pre-test (ops/fast_cuda.fast_pretest_plain).

``csrc/fast_nms.cu`` runs the full 16-difference segment test only where the
pre-test passes, so the pre-test must hold every pixel whose FAST-10 score is
above the threshold: ``fast_score_10``'s mask lies inside the pre-test map,
for any image and any threshold (negative and zero too). The port's mask is
held against the JAX package's ``frontend/detect.fast_score_10`` on the same
inputs, exactly. Cases: uniform noise, a rendered frame of the image path's
world, a flat image, hypothesis-drawn images, and synthetic arcs of 10 whose
two compass differences are exactly t or t + 1 ulp, of both polarities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from msckf_mono_tpu.frontend import detect as jdetect
from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.ops import fast_cuda
from msckf_mono_tpu_torch.utils.config import MsckfConfig

from tests import _torch_port as tp  # noqa: F401  (one intra-op thread)
from tests.test_torch_image_cuda import _arcs

THRESHOLDS = [-5.0, 0.0, 20.0, 20.3]


@pytest.fixture(scope="module")
def rendered():
    """Frame 30 of the image path's world (seed 0, 500 landmarks), 480 x 752."""
    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=31, seed=0, pixel_noise=0.0, n_landmarks=500,
                                  return_world=True)
    return render.render_frame(cfg, world, 30)[None]


def _check(img, threshold, against_jax=True):
    """The port's mask equals JAX's and lies inside the pre-test map; returns
    (mask, pre-test map)."""
    t = torch.as_tensor(img)
    mask, _ = fast_cuda.fast_score_10(t, threshold)
    if against_jax:
        jmask, _ = jdetect.fast_score_10(jnp.asarray(img[0]), threshold)
        np.testing.assert_array_equal(mask[0].numpy(), np.asarray(jmask))
    pre = fast_cuda.fast_pretest_plain(t, threshold)
    assert pre.dtype == torch.bool and pre.shape == t.shape
    assert not bool((mask & ~pre).any()), f"{int((mask & ~pre).sum())} corners fail the pre-test"
    return mask, pre


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_pretest_holds_every_corner_of_random_images(threshold):
    img = np.random.default_rng(3).uniform(0, 255, size=(1, 61, 97)).astype(np.float32)
    mask, pre = _check(img, threshold)
    assert int(mask.sum()) > 0


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_pretest_holds_every_corner_of_a_rendered_frame(rendered, threshold):
    mask, pre = _check(rendered, threshold)
    if threshold == 20.0:
        # the pre-test is what makes the kernel cheap: it rejects ~99.5% here
        assert int(mask.sum()) > 100
        assert float(pre.float().mean()) < 0.01


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_pretest_on_a_flat_image(threshold):
    img = np.full((1, 20, 33), 128.0, np.float32)
    mask, pre = _check(img, threshold)
    # d = 0 everywhere: every interior pixel scores 0 and passes exactly when 0 > t
    interior = 14 * 27 if threshold < 0 else 0
    assert int(mask.sum()) == int(pre.sum()) == interior


@pytest.mark.parametrize("ulps", [0, 1])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 20.0, 20.3])
def test_pretest_on_exact_threshold_arcs(threshold, bright, ulps):
    """An arc whose compass differences are exactly t scores t, not above it,
    and fails the strict pre-test; one ulp more and it passes both."""
    img, centres = _arcs(threshold, bright, ulps)
    mask, pre = _check(img, threshold)
    for y, x in centres:
        assert bool(mask[0, y, x]) == (ulps == 1)
        assert bool(pre[0, y, x]) == (ulps == 1)
    kept = fast_cuda.fast_nms_score_plain(torch.as_tensor(img), threshold)
    for y, x in centres:
        assert (float(kept[0, y, x]) > threshold) == (ulps == 1)


@pytest.mark.parametrize("bright", [True, False])
def test_pretest_on_arcs_below_a_negative_threshold(bright):
    img, centres = _arcs(-5.0, bright, 1)
    mask, pre = _check(img, -5.0)
    assert all(bool(pre[0, y, x]) for y, x in centres)


@settings(max_examples=60, deadline=None, database=None)
@given(
    H=st.integers(1, 18),
    W=st.integers(1, 18),
    levels=st.lists(st.sampled_from([0.0, 19.5, 20.0, 20.3, 40.0, 60.0, 255.0]), min_size=1,
                    max_size=6),
    threshold=st.sampled_from(THRESHOLDS),
    seed=st.integers(0, 2**16),
)
def test_pretest_holds_every_corner_of_drawn_images(H, W, levels, threshold, seed):
    """Images of few grey levels (ties and exact-threshold differences are
    common), any size from 1 x 1 up. The port alone: JAX would compile anew
    for every drawn shape."""
    rng = np.random.default_rng(seed)
    img = np.asarray(levels, np.float32)[rng.integers(0, len(levels), size=(1, H, W))]
    _check(img, threshold, against_jax=False)
