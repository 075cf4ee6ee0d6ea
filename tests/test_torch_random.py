"""The port's sampling random stream (``tpu_dist_torch/random.py``)
against ``jax.random``, bit for bit: keys, ``fold_in``, ``split``, random
bits, ``uniform``, ``randint``, ``gumbel`` and ``categorical``, for several
seeds, steps and shapes, and per-row keys against ``jax.vmap``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_torch import random as trandom

SEEDS = [0, 1, 7, 12345, 2 ** 31 + 3, 2 ** 32 + 5]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (251,), (1, 251)]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    tk = trandom.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(k))
    for step in (0, 1, 5, 1000, 2 ** 32 - 1):
        np.testing.assert_array_equal(trandom.fold_in(tk, step).numpy(),
                                      _data(jax.random.fold_in(k, step)))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        trandom.fold_in(tk, -1)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_gumbel(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    tk = trandom.fold_in(trandom.key(seed), 3)
    np.testing.assert_array_equal(
        trandom.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(_bits(trandom.uniform(tk, shape)),
                                  _bits(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        _bits(trandom.uniform(tk, shape, -2.0, 3.0)),
        _bits(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0)))
    np.testing.assert_array_equal(_bits(trandom.gumbel(tk, shape)),
                                  _bits(jax.random.gumbel(k, shape)))


def test_gumbel_at_vocab_width():
    """Two million draws: the port's log must be XLA's in every last bit."""
    k = jax.random.key(3)
    np.testing.assert_array_equal(
        _bits(trandom.gumbel(trandom.key(3), (64, 32768))),
        _bits(jax.random.gumbel(k, (64, 32768))))


@pytest.mark.parametrize("seed", [0, 9])
def test_categorical_one_key_and_per_row_keys(seed):
    logits = np.random.default_rng(seed).standard_normal(
        (4, 1000)).astype(np.float32)
    k = jax.random.key(seed)
    np.testing.assert_array_equal(
        trandom.categorical(trandom.key(seed),
                            torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(k, jnp.asarray(logits))))
    steps = [1, 5, 9, 2 ** 20]
    keys = jnp.stack([jax.random.fold_in(jax.random.key(seed + r), s)
                      for r, s in enumerate(steps)])
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    tkeys = trandom.fold_in(
        torch.stack([trandom.key(seed + r) for r in range(4)]),
        torch.tensor(steps))
    np.testing.assert_array_equal(
        trandom.categorical(tkeys, torch.from_numpy(logits)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    k = jax.random.fold_in(jax.random.key(seed), 11)
    tk = trandom.fold_in(trandom.key(seed), 11)
    for num in (1, 2, 5, 9):
        np.testing.assert_array_equal(trandom.split(tk, num).numpy(),
                                      _data(jax.random.split(k, num)))
    # a batch of keys splits row by row, as jax.vmap(split) does
    keys = jnp.stack([jax.random.fold_in(k, s) for s in range(3)])
    tkeys = trandom.fold_in(tk.expand(3, 2), torch.arange(3))
    np.testing.assert_array_equal(
        trandom.split(tkeys, 4).numpy(),
        _data(jax.vmap(lambda kk: jax.random.split(kk, 4))(keys)))


SPANS = [(0, 9), (-5, 3), (0, 1 << 20), (-100000, 100000), (0, 65537 * 3),
         (-2 ** 31, 2 ** 31 - 1), (-2 ** 31, 0), (0, 2 ** 31 - 1),
         (5, 5), (8, 2)]


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (251,)])
def test_randint(seed, shape):
    """Every span class: small, above 2**16 (the multiplier wraps), the
    whole int32 range (span 2**32 - 1), negative bounds, and empty ranges
    (minval comes back)."""
    k = jax.random.fold_in(jax.random.key(seed), 3)
    tk = trandom.fold_in(trandom.key(seed), 3)
    for lo, hi in SPANS:
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = trandom.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=(lo, hi))


def test_randint_tensor_bounds_and_range_check():
    lo, hi = np.array([0, -3, 5, 7]), np.array([10, 3, 5, 1 << 30])
    k = jax.random.key(4)
    np.testing.assert_array_equal(
        trandom.randint(trandom.key(4), (2, 4), torch.tensor(lo),
                        torch.tensor(hi)).numpy(),
        np.asarray(jax.random.randint(k, (2, 4), lo, hi)))
    with pytest.raises(ValueError, match="int32"):
        trandom.randint(trandom.key(4), (2,), 0, 2 ** 31)
