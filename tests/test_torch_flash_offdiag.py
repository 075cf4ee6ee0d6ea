"""The port's ``causal="offdiag"`` mode and ``split_diag`` variant of flash
attention against the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions; the
JAX package's Pallas kernels run in interpret mode, as its own tests run
them (tests/test_flash_attention.py:86-140).  Inputs are the same numpy
arrays, float32; the tolerances are that file's: 2e-5 for the forward and
the lse (line 42) and 5e-4 for the gradients (line 78)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import flash_attention_with_lse as jax_flash_lse
from tpu_dist_torch.ops import flash_attention_with_lse as torch_flash_lse

fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, tq, h)).astype(np.float32)
    return q, k, v, do, dlse


def _both(q, k, v, do, dlse, **kw):
    """(o, lse, (dq, dk, dv)) of the JAX package and of the port, with
    cotangents on both outputs."""
    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o_t, lse_t = torch_flash_lse(qt, kt, vt, **kw)
    grads_t = torch.autograd.grad((o_t, lse_t), (qt, kt, vt),
                                  (torch.from_numpy(do),
                                   torch.from_numpy(dlse)))
    return ((np.asarray(o_j), np.asarray(lse_j), grads_j),
            (o_t.detach().numpy(), lse_t.detach().numpy(), grads_t))


def _assert_match(jax_out, torch_out):
    (o_j, lse_j, g_j), (o_t, lse_t, g_t) = jax_out, torch_out
    np.testing.assert_allclose(o_t, o_j, FWD_TOL, FWD_TOL)
    np.testing.assert_allclose(lse_t, lse_j, FWD_TOL, FWD_TOL)
    for gt, gj, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), gj, GRAD_TOL, GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape,blocks", [
    ((1, 384, 384, 2, 16), (128, 128)),    # equal blocks, 3 query blocks
    ((1, 384, 384, 2, 16), (128, 256)),    # key blocks coarser
    ((1, 384, 384, 2, 16), (256, 128)),    # query blocks coarser
    ((2, 300, 300, 2, 16), (128, 128)),    # ragged T: a partial last block
    ((1, 200, 330, 2, 16), (128, 128)),    # Tq != Tk
])
def test_offdiag_matches_jax(shape, blocks):
    """o, lse and the q/k/v grads (cotangents on o and lse); the first
    query block sees no key: lse ≈ -1e30 and o = 0 on both sides."""
    b, tq, tk, h, d = shape
    args = _inputs(sum(shape) + sum(blocks), *shape)
    jax_out, torch_out = _both(*args, causal="offdiag", block_q=blocks[0],
                               block_k=blocks[1])
    _assert_match(jax_out, torch_out)
    first = min(blocks[0], tq)
    assert np.all(torch_out[1][:, :first] < -1e29)
    assert not np.any(torch_out[0][:, :first])


def test_offdiag_visibility_rule():
    """The plain version's mask is the JAX grid predicate ``k_lo + bk <=
    q_lo`` over the clamped blocks, element by element."""
    for dtype, blocks, t in ((torch.float32, (1024, 1024), 700),
                             (torch.bfloat16, (256, 384), 1000),
                             (torch.float32, (128, 384), 1000)):
        bq, bk = fa.clamp_blocks(dtype, t, t, *blocks)
        keep = fa._keep_mask(t, t, "offdiag", dtype, "cpu", *blocks)
        q = torch.arange(t)[:, None]
        k = torch.arange(t)[None, :]
        want = (k // bk) * bk + bk <= (q // bq) * bq
        assert torch.equal(keep, want), (dtype, blocks)
    # float32 clamps 1024 to 512 (4-byte dtypes), then to T rounded to 128
    assert fa.clamp_blocks(torch.float32, 2048, 2048, 1024, 1024) == (512, 512)
    assert fa.clamp_blocks(torch.bfloat16, 2048, 2048, 1024, 512) == (1024,
                                                                       512)
    assert fa.clamp_blocks(torch.bfloat16, 300, 200, 1024, 1024) == (384, 256)


@pytest.mark.parametrize("shape", [
    (2, 256, 2, 64),    # 2 bands of 128
    (1, 512, 2, 32),    # 4 bands
])
def test_split_diag_matches_jax(shape):
    """The split (offdiag + batched diagonal bands, lse-merged) against the
    JAX package's split: forward, lse and grads."""
    b, t, h, d = shape
    args = _inputs(t + h + d, b, t, t, h, d)
    jax_out, torch_out = _both(*args, causal=True, block_q=128,
                               block_k=128, split_diag=True)
    _assert_match(jax_out, torch_out)


def test_split_lse_and_cotangent_match_single():
    """``test_split_lse_and_cotangent_match_single``'s case: the split and
    the single call agree in o, lse and the grads of a loss on both
    (the lse cotangent enters both calls' shared delta), in the port and
    against the JAX package's split."""
    q, k, v, _, _ = _inputs(11, 1, 256, 256, 2, 32)

    def port(split):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o, lse = torch_flash_lse(qt, kt, vt, causal=True, block_q=128,
                                 block_k=128, split_diag=split)
        loss = (o ** 2).sum() + 0.01 * (lse ** 2).sum()
        return o.detach(), lse.detach(), torch.autograd.grad(loss,
                                                             (qt, kt, vt))

    def jax_split(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=True, block_q=128,
                               block_k=128, split_diag=True)
        return (o ** 2).sum() + 0.01 * (lse ** 2).sum()

    o_s, lse_s, g_s = port(True)
    o_1, lse_1, g_1 = port(False)
    np.testing.assert_allclose(o_s.numpy(), o_1.numpy(), FWD_TOL, FWD_TOL)
    np.testing.assert_allclose(lse_s.numpy(), lse_1.numpy(), FWD_TOL,
                               FWD_TOL)
    g_j = jax.grad(jax_split, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b_, gj, name in zip(g_s, g_1, g_j, "qkv"):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), GRAD_TOL,
                                   GRAD_TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy(), np.asarray(gj), GRAD_TOL,
                                   GRAD_TOL, err_msg=f"d{name} vs jax")


def test_split_takes_the_two_calls():
    """A split pass is one offdiag and one causal call of each kernel (the
    CPU takes their plain versions, so the counts stay: checked through the
    plain functions' arguments instead)."""
    calls = []
    real_fwd, real_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain

    def fwd(q, k, v, causal, *a):
        calls.append(("fwd", causal, tuple(q.shape)))
        return real_fwd(q, k, v, causal, *a)

    def bwd(q, k, v, do, lse, delta, causal, *a):
        calls.append(("bwd", causal, tuple(q.shape)))
        return real_bwd(q, k, v, do, lse, delta, causal, *a)

    q, k, v, _, _ = _inputs(3, 2, 256, 256, 2, 16)
    qt = torch.tensor(q, requires_grad=True)
    fa.flash_fwd_plain, fa.flash_bwd_plain = fwd, bwd
    try:
        o = fa.flash_attention(qt, torch.tensor(k), torch.tensor(v),
                               causal=True, block_q=128, split_diag=True)
        o.sum().backward()
    finally:
        fa.flash_fwd_plain, fa.flash_bwd_plain = real_fwd, real_bwd
    assert sorted(calls, key=str) == sorted([
        ("fwd", True, (4, 128, 2, 16)), ("fwd", "offdiag", (2, 256, 2, 16)),
        ("bwd", True, (4, 128, 2, 16)), ("bwd", "offdiag", (2, 256, 2, 16))],
        key=str)


@pytest.mark.parametrize("kw,t,tk", [
    (dict(causal=False, split_diag=True), 256, 256),      # not causal
    (dict(causal="offdiag", split_diag=True), 256, 256),  # not causal=True
    (dict(causal=True, split_diag=True), 256, 128),       # tq != tk
    (dict(causal=True, block_q=128, split_diag=True), 200, 200),  # 128 ∤ 200
])
def test_split_validation_raises_like_jax(kw, t, tk):
    q, k, v, _, _ = _inputs(0, 1, t, tk, 2, 16)
    with pytest.raises(ValueError, match="split_diag"):
        jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    with pytest.raises(ValueError, match="split_diag"):
        torch_flash_lse(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)


def test_unknown_mode_raises():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="causal"):
        torch_flash_lse(q, q, q, causal="diag")
