"""The benchmark's arithmetic on fixed inputs: interval unions, idle gaps,
percentiles, spreads, and the kernels' bounds."""

import math

import numpy as np
import pytest
import torch

from portbench.harness import roofline, stats
from portbench.harness.trace import Trace, kernel_of


def test_union_overlaps_and_gaps():
    spans = [(0.0, 1000.0), (500.0, 1500.0), (3000.0, 4000.0), (3500.0, 3600.0)]
    assert stats.union_ms(spans) == pytest.approx(2.5)
    assert stats.clipped_union_ms(spans, [(1000.0, 3500.0)]) == pytest.approx(1.0)
    assert stats.gaps(spans, 0.0, 5000.0) == [(1500.0, 3000.0), (4000.0, 5000.0)]


def test_trace_idle_share_and_labels():
    device = [("k", 0.0, 400.0), ("k", 600.0, 1000.0)]
    spans = [("chunk", 0.0, 700.0), ("sync", 700.0, 1000.0)]
    tr = Trace(device, spans, [(0.0, 1000.0)], steps=2)
    assert tr.busy_s == pytest.approx(800e-6)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.ops() == 2
    assert tr.idle_gaps() == [["chunk", pytest.approx(200e-6)]]


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)


def test_kernel_names():
    assert kernel_of("void gamma_rows_kernel<56>(float const*, float const*, float*, int)") == "gamma"
    assert kernel_of("fast_nms_kernel(float const*, float*, int, int, float)") == "fast"
    assert kernel_of("klt_staged_kernel(float const*)") == "klt"
    assert kernel_of("void (anonymous namespace)::gamma_rows_kernel<56>(float const*, int)") == "gamma"
    assert kernel_of("void at::native::vectorized_elementwise_kernel<4>()") is None


def test_gamma_bound():
    # R = 41, n = 8192 (the fleet's marginalize gate): bytes bound
    nbytes = 8192 * (41 * 42 // 2 + 41) * 4 + 8192 * 4
    flops = 8192 * (41 ** 3 / 3.0 + 41 ** 2)
    want = max(nbytes / 3.35e12, flops / 67e12)
    assert roofline.gamma_bound_s((1024, 8, 41, 41)) == pytest.approx(want)
    assert want == pytest.approx(8.83e-6, rel=2e-3)      # chip_smoke.py's 0.00883 ms


def test_fast_bound_counts_pretest_and_candidates():
    img = torch.full((1, 32, 32), 10.0)
    img[0, 16, 16] = 200.0                                 # one bright pixel: a candidate
    t = roofline.fast_bound_s(img, 20.0)
    interior = 26 * 26
    passing = 1
    ops = roofline.FAST_PRETEST_OPS * interior + roofline.FAST_CANDIDATE_OPS * passing
    assert t == pytest.approx(max(2 * 32 * 32 * 4 / 3.35e12, ops / 67e12))


def test_klt_bound_counts_live_iterations():
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0, 255, (1, 64, 64)), dtype=torch.float32)
    pts = torch.tensor([[[30.0, 30.0], [20.0, 40.0]]])
    valid = torch.tensor([[True, False]])
    kw = dict(window_size=7, max_iters=30, eps=1.0, min_eigen_threshold=1e-5)
    t = roofline.klt_bound_s((img, img, pts, pts, valid), kw)
    # the same image: the first step is 0, one live iteration for the valid feature
    samples = roofline.klt_samples(7, 1, 1)
    assert samples == (9 ** 2 - 4) + 49
    nbytes, pixels = roofline.klt_level_bytes((img, img, pts, pts, valid), 7, torch.tensor([[1, 0]]))
    assert pixels == 10 * 10 + 8 * 8
    assert t == pytest.approx(max(nbytes / 3.35e12, 20 * samples / 67e12))
    assert math.isfinite(t) and t > 0
