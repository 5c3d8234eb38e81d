"""The port's threefry2x32 PRNG (``utils/prng.py``) against ``jax.random`` on the CPU.

JAX runs with x64 on (tests/conftest.py) in its default partitionable
threefry mode. Tolerances:

* keys, ``split``, the ``threefry2x32`` hash, ``random_bits`` (32 and 64),
  ``uniform`` on [0, 1) and on normal's [nextafter(-1, 0), 1), ``randint``
  (32- and 64-bit, spans 1, 2, 37, 128 and 2^31 + 1, ``maxval <= minval``,
  a device ``maxval``, int32 clipping): bit-equal, for keys 0, 1 and
  2^32 - 1 at shapes (5,), (300,) and (1024, 3);
* ``normal``: f32 within 2·eps relative (about 2 ulp: the port's ``log1p``
  is torch's, not XLA's), f64 within 1e-12 relative;
* a batch of keys draws what each key draws alone (``jax.vmap``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from msckf_mono_tpu_torch.utils import prng

KEYS = [0, 1, 2**32 - 1]
SHAPES = [(5,), (300,), (1024, 3)]
# (minval, maxval): spans 1, 2, 37, 128, 2^31 + 1, then maxval <= minval
RANGES = [(0, 1), (0, 2), (-5, 32), (0, 128), (-2**30, 2**30 + 1), (4, 4), (9, 3)]
F32_EPS = float(np.finfo(np.float32).eps)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", KEYS)
def test_key_and_split_match_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    for num in (2, 5, 300):
        np.testing.assert_array_equal(prng.split(k, num).numpy(), _np(jax.random.split(jk, num)))
    # twice down the tree, as the track handler's carried key goes
    k2 = prng.split(prng.split(k)[0])[1]
    np.testing.assert_array_equal(k2.numpy(), _np(jax.random.split(jax.random.split(jk)[0])[1]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", KEYS)
def test_bits_and_uniform_match_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(k, 32, shape).numpy(),
                                  _np(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.random_bits(k, 64, shape).numpy().view(np.uint64),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint64)))
    # the hash itself on count pairs: JAX's flat form hashes the two halves
    half = (int(np.prod(shape)) + 1) // 2
    count = np.arange(2 * half, dtype=np.uint32)
    c = torch.as_tensor(count.astype(np.int64))
    got = torch.cat(prng.threefry2x32(k[0], k[1], c[:half], c[half:])).numpy()
    np.testing.assert_array_equal(got, _np(jprng.threefry_2x32(jk, jnp.asarray(count))))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        np.testing.assert_array_equal(prng.uniform(k, shape, tdt).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape, jdt)))
        lo = float(np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt)))
        np.testing.assert_array_equal(prng.uniform(k, shape, tdt, lo, 1.0).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape, jdt, lo, 1.0)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", KEYS)
def test_randint_matches_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in RANGES:
        for bits, jdt in ((32, jnp.int32), (64, jnp.int64)):
            want = _np(jax.random.randint(jk, shape, lo, hi, jdt))
            np.testing.assert_array_equal(prng.randint(k, shape, lo, hi, bits).numpy(), want,
                                          err_msg=f"[{lo}, {hi}) {bits}-bit")
            # maxval as a 0-d tensor, as RANSAC passes it
            got = prng.randint(k, shape, lo, torch.tensor(hi), bits).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"[{lo}, {hi}) {bits}-bit tensor")
    # int32 clipping: a maxval past the type's range widens the span by one
    for lo, hi in ((-2**31, 2**40), (3, 2**33)):
        np.testing.assert_array_equal(prng.randint(k, shape, lo, hi, 32).numpy(),
                                      _np(jax.random.randint(jk, shape, lo, hi, jnp.int32)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", KEYS)
def test_normal_matches_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32)).astype(np.float64)
    got = prng.normal(k, shape, torch.float32).numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= 2 * F32_EPS * np.abs(want))
    assert np.mean(got == want) > 0.9
    want = np.asarray(jax.random.normal(jk, shape, jnp.float64))
    got = prng.normal(k, shape, torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_erf_inv_edges_and_float64():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.5, 0.999999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = prng.erf_inv(x).numpy()
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    np.testing.assert_allclose(got[3:], want[3:], rtol=2 * F32_EPS)
    u = np.random.default_rng(0).uniform(-0.999999, 0.999999, 10000)
    np.testing.assert_allclose(prng.erf_inv(torch.as_tensor(u)).numpy(),
                               np.asarray(jax.lax.erf_inv(jnp.asarray(u))), rtol=1e-12, atol=0)


def test_batched_keys_draw_what_each_key_draws():
    keys = prng.split(prng.PRNGKey(3), 4)                          # (4, 2)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 4)
    lo = torch.tensor([0, 1, 2, 3])[:, None]
    hi = torch.tensor([7, 40, 2, 129])[:, None]
    for bits, jdt in ((32, jnp.int32), (64, jnp.int64)):
        got = prng.randint(keys, (300,), lo, hi, bits).numpy()
        want = jax.vmap(lambda kk, a, b: jax.random.randint(kk, (300,), a, b, jdt))(
            jkeys, jnp.asarray([0, 1, 2, 3]), jnp.asarray([7, 40, 2, 129]))
        np.testing.assert_array_equal(got, _np(want), err_msg=f"{bits}-bit")
    np.testing.assert_array_equal(prng.split(keys, 3).numpy(), _np(jax.vmap(
        lambda kk: jax.random.split(kk, 3))(jkeys)))
    for i in range(4):
        np.testing.assert_array_equal(prng.normal(keys, (7,), torch.float64)[i].numpy(),
                                      prng.normal(keys[i], (7,), torch.float64).numpy())
