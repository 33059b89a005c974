"""The port's threefry2x32 against ``jax.random``: keys, splits, folds
and bit sweeps must be equal word for word (the random stream is the
simulated network, so whole-run parity rests on it)."""

import jax
import numpy as np
import pytest
import torch

from frankenpaxos_tpu_torch import prng


def _words(key) -> np.ndarray:
    """A jax key's two uint32 words (raw uint32 keys or typed keys)."""
    arr = np.asarray(jax.random.key_data(key)) if jax.dtypes.issubdtype(
        key.dtype, jax.dtypes.prng_key
    ) else np.asarray(key)
    return arr.astype(np.int64)


def _same(jax_key, port_key):
    np.testing.assert_array_equal(_words(jax_key), port_key.numpy())


SEEDS = [0, 1, 2**31 - 1, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _same(jax.random.PRNGKey(seed), prng.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    j = jax.random.split(jax.random.PRNGKey(seed), 5)
    p = prng.split(prng.PRNGKey(seed), 5)
    assert p.shape == (5, 2)
    _same(j, p)


@pytest.mark.parametrize("data", [0, 1, 10_000_000])
@pytest.mark.parametrize("seed", [0, 7])
def test_fold_in(seed, data):
    j = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    p = prng.fold_in(prng.PRNGKey(seed), data)
    _same(j, p)


@pytest.mark.parametrize("shape", [(3, 8, 16), (5, 6, 32), (8, 16), (5,)])
@pytest.mark.parametrize("seed", [0, 3])
def test_bits(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    pk = prng.fold_in(prng.PRNGKey(seed), 11)
    j = np.asarray(jax.random.bits(jk, shape))
    p = prng.bits(pk, shape, "cpu")
    assert j.dtype == np.uint32
    assert p.dtype == torch.int64 and tuple(p.shape) == shape
    np.testing.assert_array_equal(j.astype(np.int64), p.numpy())


@pytest.mark.parametrize("bounds", [(1, 4), (0, 1000), (-5, 3)])
def test_randint(bounds):
    lo, hi = bounds
    key = jax.random.PRNGKey(4)
    j = np.asarray(jax.random.randint(key, (3, 4, 16), lo, hi))
    p = prng.randint(prng.PRNGKey(4), (3, 4, 16), lo, hi)
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(j, p.numpy())


@pytest.mark.parametrize(
    "shape, bounds",
    [
        ((), (0.0, 1.0)),
        ((7,), (0.0, 1.0)),
        ((3, 5, 4), (0.0, 1.0)),
        ((3, 5, 4), (-2.5, 3.25)),
        ((2, 3, 11), (0.1, 0.2)),
        ((4096,), (-1000.0, 7.0)),
    ],
)
@pytest.mark.parametrize("seed", [0, 9])
def test_uniform(seed, shape, bounds):
    """float32 ``jax.random.uniform`` bit for bit (compared as int32
    bits), the scale-and-offset rounding included at non-default bounds."""
    lo, hi = bounds
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    pk = prng.fold_in(prng.PRNGKey(seed), 3)
    j = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
    p = prng.uniform(pk, shape, lo, hi, "cpu")
    assert j.dtype == np.float32
    assert p.dtype == torch.float32 and tuple(p.shape) == shape
    np.testing.assert_array_equal(j.view(np.int32), p.view(torch.int32).numpy())
    assert bool((p >= lo).all())
