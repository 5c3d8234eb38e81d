"""The port's threefry2x32 PRNG (``utils/prng.py``) on the card against the CPU.

Every test carries the ``cuda`` marker and skips without a card. This file
imports neither JAX nor the JAX package (tests/test_torch_prng.py holds the
CPU draws against ``jax.random``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_prng_cuda.py -q

* ``split``, ``random_bits`` (32 and 64), ``randint`` at RANSAC's shapes with
  a device ``maxval`` (32- and 64-bit) and ``sample_pairs``: bit-equal to the
  CPU's;
* ``normal`` (1024, 3) f32: within 2·eps relative of the CPU's (the card's
  ``log1p`` and ``sqrt`` may round differently), f64 within 1e-12;
* a captured CUDA graph that splits a carried key and samples RANSAC's
  pairs gives, over 10 replays, the keys and pairs of the eager loop.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.frontend import ransac
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this file holds the card's draws against the CPU's")
    return "cuda"


def _valid(n_valid, F=128, seed=0):
    valid = np.zeros(F, bool)
    valid[np.random.default_rng(seed).permutation(F)[:n_valid]] = True
    return torch.as_tensor(valid)


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1])
def test_integer_draws_on_the_card_equal_the_cpu(card, seed):
    k = prng.PRNGKey(seed)
    kd = k.to(card)
    assert torch.equal(prng.split(kd, 5).cpu(), prng.split(k, 5))
    for width in (32, 64):
        for shape in ((300,), (1024, 3)):
            assert torch.equal(prng.random_bits(kd, width, shape).cpu(),
                               prng.random_bits(k, width, shape))
    for bits in (32, 64):
        for n in (2, 5, 37, 128):
            hi = torch.tensor(n)
            assert torch.equal(prng.randint(kd, (300,), 0, hi.to(card), bits).cpu(),
                               prng.randint(k, (300,), 0, hi, bits))
        for n_valid in (0, 3, 40, 128):
            valid = _valid(n_valid)
            got = ransac.sample_pairs(valid.to(card), kd, int_bits=bits)
            want = ransac.sample_pairs(valid, k, int_bits=bits)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_normal_on_the_card_within_2_eps(card):
    k = prng.PRNGKey(0)
    got = prng.normal(k.to(card), (1024, 3), torch.float32).cpu().double()
    want = prng.normal(k, (1024, 3), torch.float32).double()
    assert bool(torch.all((got - want).abs() <= 2 * F32_EPS * want.abs()))
    got = prng.normal(k.to(card), (1024, 3), torch.float64).cpu()
    torch.testing.assert_close(got, prng.normal(k, (1024, 3), torch.float64), rtol=1e-12, atol=0)


def _ransac_step(key, valid):
    key, sub = prng.split(key)
    return key, ransac.sample_pairs(valid, sub)


def test_captured_key_split_replays_the_eager_keys(card):
    valid = _valid(40).to(card)
    graph = cuda_graph.StepGraph(_ransac_step, prng.PRNGKey(0, card), (valid,))
    key, eager = prng.PRNGKey(0, card), prng.PRNGKey(0, card)
    for i in range(10):
        key, (i1, i2) = graph(key, valid)
        eager, (w1, w2) = _ransac_step(eager, valid)
        assert torch.equal(key, eager), i
        assert torch.equal(i1, w1) and torch.equal(i2, w2), i
    assert graph.replays == 10
