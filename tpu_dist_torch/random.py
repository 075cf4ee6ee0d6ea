"""The JAX package's sampling random stream, in plain PyTorch integer ops.

A request's ``seed`` is part of the serving contract: the JAX engine takes
its key from ``jax.random.key(seed)``, folds it by decode step and draws
Gumbel noise from it.  Drawing from a ``torch.Generator`` would give other
tokens for the same seed, so this module computes JAX's stream itself, as
``jax_threefry_partitionable=True`` (the default) generates it:

- :func:`key` ``(seed)`` → ``[0, seed mod 2**32]``;
- :func:`fold_in` — one threefry2x32 block over the count pair
  ``(0, data)``;
- :func:`random_bits` — threefry2x32 over the 64-bit iota of the output
  shape, split into its high and low words, the two output words xor-ed;
- :func:`split` — threefry2x32 over the count pairs ``(0, i)``, ``i <
  num``, the two output words a key;
- :func:`uniform`, :func:`randint` (two sets of bits folded by the span,
  as ``jax.random.randint`` computes them for int32), :func:`gumbel` (the
  ``"low"`` mode) and :func:`categorical` (the Gumbel-max trick).

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words (torch
has no uint32 arithmetic on every device); every sum is masked back to 32
bits.  A key's leading dims index independent streams: ``(B, 2)`` keys
draw one stream a row, as ``jax.vmap`` over keys would.

:func:`gumbel` needs ``log``, whose last bit differs between libraries
(XLA's CPU backend, SLEEF on torch's CPU, CUDA's ``logf``).  :func:`_log`
is XLA's CPU algorithm (the Cephes polynomial with fused multiply-adds),
written as float32 operations with each fused multiply-add computed in
float64 (the product is exact there, so only the final rounding to float32
counts), so the noise equals the JAX package's on its CPU backend, and is
the same on the CPU and on the card."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "random_bits", "uniform", "randint",
           "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data with 64-bit types off: ``[0, seed
    mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words ``x1, x2``
    under the key words ``k1, k2``; all int64 uint32 words, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and ``data``,
    an int in [0, 2**32) or an int tensor of the key's leading shape whose
    values the caller keeps in that range (checking them would wait for the
    device)."""
    if not torch.is_tensor(data) and not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o1, o2 = _threefry2x32(key[..., 0], key[..., 1],
                           torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys from ``key`` (..., 2), shape
    ``key.shape[:-1] + (num, 2)``."""
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    o1, o2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, shape ``key.shape[:-1] + shape`` (int64
    holding uint32)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    if n >= 1 << 32:
        raise ValueError("random_bits covers fewer than 2**32 elements")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval) with one
    fused multiply-add, as XLA computes it.  ``minval``/``maxval`` may be
    tensors broadcast to the output: keys stacked in leading dims then draw
    each stream's own range in one pass."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` with its default int32: values in [minval,
    maxval), ``minval``/``maxval`` int32-range ints or int tensors broadcast
    to ``shape``.  As JAX computes it: the key split in two, 32 bits from
    each half, and ``((hi % span) * (2**32 % span) + lo % span) % span`` in
    wrapping uint32 arithmetic, with ``span = 1`` where ``maxval <=
    minval``."""
    for v in (minval, maxval):
        if not torch.is_tensor(v) and not _I32_MIN <= v <= _I32_MAX:
            raise ValueError(f"randint bounds must lie in the int32 range, "
                             f"got {v}")
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       maxval - minval)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((hi % span) * mult) & _MASK
    off = ((off + lo % span) & _MASK) % span
    return (minval + off).to(torch.int32)


def _f32(v: float) -> float:
    return float(np.float32(v))


_SQRTHF = _f32(0.707106781186547524)
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once to float32: the product of two
    float32 values is exact in float64 (the float64 sum's own rounding can
    differ from a true fused multiply-add only on a double-rounding tie)."""
    return (a.double() * b + c).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 ``x`` (subnormals taken as the least
    normal), as XLA's CPU backend computes it."""
    m, e = torch.frexp(torch.clamp_min(x, _TINY))
    e = e.to(torch.float32)
    small = m < _SQRTHF
    e = torch.where(small, e - 1.0, e)
    m = torch.where(small, (m - 1.0) + m, m - 1.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    m = m - x2 * 0.5
    m = m + y
    return m + e * _LOG_Q2


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``"low"``) in float32:
    ``-log(-log(u))`` with ``u`` uniform in [tiny, 1)."""
    return -_log(-_log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of
    ``logits + gumbel``.  ``key`` is (2,), one stream over the whole of
    ``logits``, or has leading dims that are a prefix of ``logits``'s batch
    dims, one stream per leading index."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits.float(), dim=-1)
