"""core/prng.py is bit-exact against jax.random (threefry2x32,
jax_threefry_partitionable=True) for every call the env makes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadrive_ped_torch.core import prng

SEEDS = [0, 1, 5, 79, 123456, 2 ** 31 - 1]


def _keys(n, seed=3):
    """n JAX keys and their twins."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.as_tensor(np.asarray(keys).astype(np.int64))


def test_jax_uses_the_twinned_scheme():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(
        prng.prng_key(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    k = jax.random.PRNGKey(seed)
    for n in (2, 3, 17):
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), n).numpy(),
            np.asarray(jax.random.split(k, n)).astype(np.int64))


def test_split_batched():
    keys, tkeys = _keys(64)
    np.testing.assert_array_equal(
        prng.split(tkeys).numpy(), np.asarray(jax.vmap(jax.random.split)(keys)).astype(np.int64))


@pytest.mark.parametrize("data", [0, 77, 78, 79, 2 ** 32 - 1])
def test_fold_in(data):
    keys, tkeys = _keys(64)
    ref = jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)
    np.testing.assert_array_equal(prng.fold_in(tkeys, data).numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("shape", [(), (1,), (3,), (5,), (4, 6)])
def test_uniform(shape):
    keys, tkeys = _keys(64)
    ref = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)
    np.testing.assert_array_equal(prng.uniform(tkeys, shape).numpy(), np.asarray(ref))


@pytest.mark.parametrize("maxval", [1, 2, 5, 16, 1000])
def test_randint_scalar_bound(maxval):
    k = jax.random.PRNGKey(maxval)
    ref = jax.random.randint(k, (257,), 0, maxval)
    np.testing.assert_array_equal(prng.randint(prng.prng_key(maxval), (257,), 0, maxval).numpy(),
                                  np.asarray(ref))


def test_randint_per_row_bound():
    """The auto-reset draw: one key and one upper bound per env
    (envs/base.py:1178-1180)."""
    keys, tkeys = _keys(200)
    caps = jnp.asarray(np.arange(200) % 37 + 1, jnp.int32)
    ref = jax.vmap(lambda k, c: jax.random.randint(k, (), 0, c))(keys, caps)
    ours = prng.randint(tkeys, (), 0, torch.as_tensor(np.array(caps)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("minval, maxval", [(-2.5, 7.25), (0.3, 0.9), (-1e3, 1e-3)])
def test_uniform_range(minval, maxval):
    """Ranged draws: XLA fuses floats * (maxval - minval) + minval into one
    multiply-add; the twin rounds as it does, bit for bit."""
    keys, tkeys = _keys(64)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (4, 97), minval=minval, maxval=maxval))(keys)
    np.testing.assert_array_equal(prng.uniform(tkeys, (4, 97), minval, maxval).numpy(),
                                  np.asarray(ref))


# jax.random.normal against the twin: XLA's float32 erfinv and the twin's
# copy of its polynomial differ only through log1p's rounding (at most 3
# float32 ulps over 16M draws on the CPU, 7.2e-7 at |x| ~ 5)
NORMAL_TOL = 1e-6


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_normal(seed):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1 << 20,)))
    ours = prng.normal(prng.prng_key(seed), (1 << 20,)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=NORMAL_TOL)
    assert np.abs(ref).max() > 4.5, "the draws should reach the tails (w >= 5 branch)"


def test_normal_batched():
    keys, tkeys = _keys(64)
    ref = jax.vmap(lambda k: jax.random.normal(k, (3, 240)))(keys)
    np.testing.assert_allclose(prng.normal(tkeys, (3, 240)).numpy(), np.asarray(ref), rtol=0,
                               atol=NORMAL_TOL)


def test_torch_erfinv_is_not_the_twin():
    """Why the twin carries its own erfinv: torch's differs from XLA's by
    far more than NORMAL_TOL."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = jax.random.uniform(jax.random.PRNGKey(0), (1 << 20,), minval=lo, maxval=1.0)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1 << 20,)))
    via_torch = np.sqrt(2) * torch.erfinv(torch.as_tensor(np.array(u))).numpy()
    assert np.abs(via_torch - ref).max() > 10 * NORMAL_TOL


def test_fold_in_tensor_data():
    """The lidar-noise key: fold_in(PRNGKey(0), sum of step counts) with the
    sum a device tensor (envs/base.py:918-923)."""
    steps = np.arange(50, dtype=np.int32) * 7
    ref = jax.random.fold_in(jax.random.PRNGKey(0), jnp.sum(jnp.asarray(steps)))
    ours = prng.fold_in(prng.prng_key(0), torch.as_tensor(steps).sum())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).astype(np.int64))
