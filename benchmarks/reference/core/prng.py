"""Counter-based random keys: a twin of the `jax.random` calls the env makes
(`PRNGKey`, `split`, `fold_in`, `uniform`, `randint` bit for bit; `normal`
within 1e-6).

The twin follows JAX's default configuration since 0.5 (checked against
jax 0.9.0): `jax_default_prng_impl=threefry2x32` and
`jax_threefry_partitionable=True`. Under the partitionable scheme every
draw hashes a counter with the key:

- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))``;
- 32 random bits at flat position ``i`` of a shape are ``b0 ^ b1`` of
  ``threefry2x32(key, (0, i))``.

A key is a tensor ``[..., 2]`` of int64 holding two uint32 words (torch has
no full uint32 arithmetic); every function takes a batch of keys and
broadcasts over its leading axes, so a batch of keys stands for JAX's
`vmap` over keys. Arithmetic is int64 masked to 32 bits, so results are
the same on any device.

`normal` is sqrt(2) * erfinv(u) of a uniform u in (-1, 1), as
`jax.random.normal` computes it in float32, with the erfinv polynomial
XLA uses (M. Giles, "Approximating the erfinv function", GPU Computing
Gems, 2010). `torch.erfinv` is another approximation: it differs from
XLA's by up to 5e-5. The polynomial here differs by under 1e-6, because
XLA's log1p rounds differently from torch's.
"""
import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles' single-precision erfinv coefficients, highest degree first, for
# w = -log1p(-x^2) < 5 (in w - 2.5) and w >= 5 (in sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counters (x0, x1) under key
    (k0, k1); all int64 tensors of 32-bit values, broadcast together."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device=None):
    """`jax.random.PRNGKey(seed)` for a seed in int32 range: [0, seed]."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _hash_counters(key, n, offset=0):
    """threefry2x32(key, (0, i)) for offset <= i < offset + n: two [..., n]
    tensors."""
    if offset < 0 or offset + n > 1 << 32:
        raise ValueError(f"counters [{offset}, {offset + n}) leave the 32-bit range")
    k0, k1 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k0, k1, torch.zeros((), dtype=torch.int64, device=key.device),
                        torch.arange(offset, offset + n, dtype=torch.int64, device=key.device))


def split(key, num=2):
    """`jax.random.split`: keys [..., 2] -> [..., num, 2]."""
    b0, b1 = _hash_counters(key, num)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key, data):
    """`jax.random.fold_in`: [..., 2] -> [..., 2]. ``data`` is a Python int
    or an integer tensor broadcast against the key batch (a traced value in
    JAX, read on the device here)."""
    k0, k1 = key[..., 0], key[..., 1]
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & _M32 if torch.is_tensor(data) else zero + (int(data) & _M32)
    b0, b1 = threefry2x32(k0, k1, zero, data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key, n, offset=0):
    """32 random bits at each of n flat positions from ``offset`` on:
    [..., 2] -> [..., n]. The bits at positions [offset, offset + n) of a
    larger draw are its slice: a shard of rows draws its part of the whole
    batch's draw."""
    b0, b1 = _hash_counters(key, n, offset)
    return b0 ^ b1


def uniform(key, shape, minval=0.0, maxval=1.0, offset=0):
    """`jax.random.uniform(key, shape, minval=minval, maxval=maxval)` in
    float32 over [minval, maxval): [..., 2] -> [..., *shape]; with
    ``offset`` the draw of flat positions [offset, offset + prod(shape))
    of a larger one (`random_bits`)."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    bits = random_bits(key, n, offset)
    # the 23 high bits become the mantissa of a float in [1, 2)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        out = torch.clamp(floats, min=0.0)
    else:
        # XLA fuses floats * (maxval - minval) + minval into one multiply-add
        # (one rounding); the product is exact in float64, so the sum there
        # rounds as the fused form does
        lo = np.float32(minval)
        scale = float(np.float32(maxval) - lo)
        out = torch.clamp((floats.double() * scale + float(lo)).float(), min=float(lo))
    return out.reshape(key.shape[:-1] + shape)


def _erfinv(x):
    """XLA's float32 erfinv (Giles' polynomial) of x in [-1, 1]."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key, shape, offset=0):
    """`jax.random.normal(key, shape)` in float32: [..., 2] -> [..., *shape],
    within 1e-6 of JAX (module docstring); ``offset`` as for `uniform`."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return float(np.float32(math.sqrt(2.0))) * _erfinv(uniform(key, shape, lo, 1.0, offset))


def randint(key, shape, minval, maxval):
    """`jax.random.randint(key, shape, minval, maxval)` (int32 result).

    ``minval``/``maxval`` are ints or int tensors broadcast against the key
    batch (one bound per key, as under `vmap`)."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], n)
    lo = random_bits(keys[..., 1, :], n)
    lead = key.shape[:-1]

    def as_bound(v):
        if torch.is_tensor(v):
            return v.to(torch.int64).expand(lead).reshape(lead + (1,))
        return torch.full(lead + (1,), int(v), dtype=torch.int64, device=key.device)

    minval, maxval = as_bound(minval), as_bound(maxval)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & _M32)
    # (hi * 2^32 + lo) mod span without 64-bit products, as JAX does
    mult = (65536 % span)
    mult = (mult * mult) % span
    offset = ((hi % span) * mult + lo % span) & _M32
    offset = offset % span
    return (minval + offset).to(torch.int32).reshape(lead + shape)
