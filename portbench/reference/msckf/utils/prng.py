"""JAX's counter-based threefry2x32 PRNG in plain torch integer arithmetic.

A copy of the parts of ``jax.random`` the JAX package draws from (the
Monte-Carlo fleet's normals, two-point RANSAC's hypothesis pairs), in the
partitionable mode JAX uses by default (``jax_threefry_partitionable``): the
bits of each element depend only on the key and the element's flat index, so
an element does not change with the size of the draw. The same key gives the
same integers as ``jax.random`` bit for bit, on any device; the one floating
step, ``erf_inv``, follows XLA's f32 polynomial; its ``log1p`` is torch's, not
XLA's own, so an f32 normal lies within 2·eps relative of JAX's (about 2 ulp).

A key is a ``(..., 2)`` int64 tensor holding two uint32 words (``uint32``
shifts and wrapping adds are not reliable in torch on CUDA): every add,
shift and multiply is masked back to 32 bits. Leading key axes batch the
draws, as ``jax.vmap`` over keys would. No function reads a tensor's value on
the host, so the draws run inside a captured CUDA graph.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key of a 64-bit ``seed`` (``threefry_seed``, jax/_src/prng.py:802):
    its high and low 32-bit words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of count pairs (x1, x2) under key words (k1, k2),
    all uint32 values in int64 tensors that broadcast together: the 20-round
    lowering of jax/_src/prng.py:883-900."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _counts(shape, device):
    """(hi, lo) words of the flat index of each element of ``shape``
    (``iota_2x32_shape``, jax/_src/prng.py:989)."""
    iota = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & MASK


def _hash(key, shape):
    """threefry2x32 of each element's index under each key: two uint32 words
    of shape ``key.shape[:-1] + shape``."""
    hi, lo = _counts(tuple(shape), key.device)
    pad = (...,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key, num: int = 2):
    """``num`` new keys, ``key.shape[:-1] + (num, 2)`` (the fold-like
    partitionable split, jax/_src/prng.py:1156)."""
    bits1, bits2 = _hash(key, (num,))
    return torch.stack([bits1, bits2], dim=-1)


def random_bits(key, width: int, shape):
    """Uniform bits (``_threefry_random_bits_partitionable``,
    jax/_src/prng.py:1184), shape ``key.shape[:-1] + shape``: width 32 gives
    uint32 values in int64, width 64 the uint64 words' two's-complement int64
    (``.numpy().view(np.uint64)`` is JAX's array)."""
    bits1, bits2 = _hash(key, shape)
    if width == 32:
        return bits1 ^ bits2
    if width == 64:
        # bits1 << 32 | bits2 without overflowing int64: the signed high word
        signed_hi = bits1 - ((bits1 >> 31) << 32)
        return signed_hi * (1 << 32) + bits2
    raise ValueError(f"width must be 32 or 64, got {width}")


def _scalar(v, dtype, device):
    """A 0-d tensor of ``v`` in ``dtype`` on ``device`` (a fill kernel, no
    host copy, for a Python number)."""
    if torch.is_tensor(v):
        return v.to(dtype=dtype, device=device)
    return torch.full((), v, dtype=dtype, device=device)


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """Floats in [minval, maxval) (jax/_src/random.py:435): the mantissa bits
    of a number in [1, 2), minus 1, scaled. The scale and shift round twice;
    XLA's CPU fuses them into one multiply-add, so a range whose product is
    inexact can differ from JAX's in the last bit ([0, 1) and normal's
    [nextafter(-1, 0), 1) are exact)."""
    shape = tuple(shape)
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        bits1, bits2 = _hash(key, shape)
        floats = ((bits1 << 20) | (bits2 >> 12) | 0x3FF0000000000000).view(torch.float64)
    else:
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    lo = _scalar(minval, dtype, key.device)
    hi = _scalar(maxval, dtype, key.device)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


# XLA's f32 ErfInv (Giles' single-precision approximation): Horner
# coefficients for w = -log1p(-x²) < 5 and >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """The inverse error function as XLA computes it: its f32 polynomial in
    float32, ``torch.erfinv`` in float64 (within 1e-12 of XLA's there)."""
    if x.dtype == torch.float64:
        return torch.erfinv(x)
    if x.dtype != torch.float32:
        raise TypeError(f"erf_inv takes float32 or float64, got {x.dtype}")
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # one rounding a step, as XLA's fused multiply-add: the f32 product
        # is exact in f64
        p = (torch.where(lt, a, b).to(torch.float32).double() + p.double() * w).float()
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key, shape, dtype=torch.float32):
    """Standard normals (``_normal_real``, jax/_src/random.py:867):
    √2 · erf_inv(uniform(nextafter(-1, 0), 1))."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))
    u = uniform(key, shape, dtype, float(lo), 1.0)
    return _scalar(math.sqrt(2.0), dtype, key.device) * erf_inv(u)


def _mul32(a, b):
    """a · b mod 2^32 of uint32 values, through 16-bit halves of a (no
    int64 overflow)."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK


def _mulmod(a, b, m):
    """a · b mod m for a, b < m <= 2^32, through 16-bit halves of b."""
    return ((((a * (b >> 16)) % m) << 16) + a * (b & 0xFFFF)) % m


def randint(key, shape, minval, maxval, int_bits: int = 32):
    """Integers in [minval, maxval) (``_randint``, jax/_src/random.py:581),
    shape ``key.shape[:-1] + shape``, as int64.

    ``int_bits`` is the width of JAX's integer type: 32 as JAX serves (its
    default int with x64 off), 64 under ``jax_enable_x64``. Each value comes
    from two words of that width, reduced with the
    ``multiplier = (2^(nbits/2) mod span)^2 mod span`` trick; ``span`` is 1
    where ``maxval <= minval``. ``minval``/``maxval`` are Python ints or
    tensors on the key's device (a device ``maxval`` stays there) that
    broadcast against the output. 64-bit spans must not exceed 2^32.
    """
    dev = key.device
    lo = _scalar(minval, torch.int64, dev)
    hi = _scalar(maxval, torch.int64, dev)
    shape = tuple(shape)
    keys = split(key)                                            # (..., 2, 2)
    bits = _hash(keys, shape)                                    # 2 x (..., 2, *shape)
    axis = keys.dim() - 2
    # the words of the two draws: (bits1, bits2) of the first key and the second
    first = [b.select(axis, 0) for b in bits]
    second = [b.select(axis, 1) for b in bits]

    if int_bits == 32:
        out_of_range = hi > 2**31 - 1
        lo = torch.clamp(lo, -2**31, 2**31 - 1)
        hi = torch.clamp(hi, -2**31, 2**31 - 1)
        span = torch.where(hi <= lo, 1, (hi - lo) & MASK)
        span = torch.where(out_of_range & (hi > lo), (span + 1) & MASK, span)
        # a span of 2^32 wraps to 0 in uint32, where JAX's remainders keep
        # their dividend: the same as dividing by 2^32
        span = torch.where(span == 0, 1 << 32, span)
        higher, lower = first[0] ^ first[1], second[0] ^ second[1]
        mult = (1 << 16) % span
        mult = _mul32(mult, mult) % span                         # 2^16·2^16 wraps to 0
        offset = ((_mul32(higher % span, mult) + lower % span) & MASK) % span
    elif int_bits == 64:
        span = torch.where(hi <= lo, 1, hi - lo)
        mult = (1 << 32) % span
        # each 64-bit word mod span from its halves: (hi·2^32 + lo) mod span
        higher, lower = ((_mulmod(w[0] % span, mult, span) + w[1] % span) % span
                         for w in (first, second))
        mult = _mulmod(mult, mult, span)
        offset = (_mulmod(higher, mult, span) + lower) % span
    else:
        raise ValueError(f"int_bits must be 32 or 64, got {int_bits}")
    return lo + offset
