"""The port's flash attention against the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions; the
JAX package's Pallas kernels run in interpret mode, as its own tests run
them.  Inputs are the same numpy arrays, float32; the tolerances are those
of tests/test_flash_attention.py: 2e-5 for the forward (line 42) and 5e-4
for the gradients (line 78)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.nn.attention import (
    scaled_dot_product_attention as jax_sdpa)
from tpu_dist.ops import flash_attention_with_lse as jax_flash_lse
from tpu_dist_torch.nn import attention_impl
from tpu_dist_torch.nn.attention import (
    scaled_dot_product_attention as torch_sdpa)
from tpu_dist_torch.ops import flash_attention_with_lse as torch_flash_lse

# the module (the package re-exports the function over its name)
fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

torch.backends.cuda.matmul.allow_tf32 = False

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _qkv(rng, b, tq, tk, h, d):
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,sm_scale", [
    ((1, 100, 100, 2, 16), None),   # ragged T, D = 16
    ((2, 72, 72, 3, 32), None),     # ragged T, D = 32
    ((1, 40, 56, 2, 16), 0.3),      # Tq != Tk, explicit scale
    ((1, 130, 130, 2, 64), None),   # D = 64 (the wgmma design's on the card)
])
def test_forward_lse_and_grads_match_jax(shape, sm_scale, causal):
    """Output, lse and the gradients of (out, lse) with a cotangent on
    both — the lse cotangent folds into delta on both sides."""
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    do = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, tq, h)).astype(np.float32)

    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, causal=causal,
                                      sm_scale=sm_scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o_t, lse_t = torch_flash_lse(qt, kt, vt, causal=causal, sm_scale=sm_scale)
    grads_t = torch.autograd.grad((o_t, lse_t), (qt, kt, vt),
                                  (torch.from_numpy(do),
                                   torch.from_numpy(dlse)))

    np.testing.assert_allclose(o_t.detach().numpy(), o_j, FWD_TOL, FWD_TOL)
    np.testing.assert_allclose(lse_t.detach().numpy(), lse_j, FWD_TOL,
                               FWD_TOL)
    for gt, gj, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), gj, GRAD_TOL, GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_dense_dispatch_matches_jax_dense(causal):
    """The dense composition, with an arbitrary mask on top."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 24, 24, 2, 16)
    mask = rng.random((2, 1, 24, 24)) < 0.8
    mask[..., 0] = True  # every row keeps a key
    out_j = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, mask=jnp.asarray(mask))
    out_t = torch_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal,
                       mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.numpy(), out_j, FWD_TOL, FWD_TOL)


def test_dispatch_rules():
    """Auto picks dense off the card; the override routes to flash, which
    refuses a mask, as in the JAX package."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 16, 16, 2, 16))
    dense = torch_sdpa(q, k, v, causal=True, impl="dense")
    with attention_impl("flash"):
        flash = torch_sdpa(q, k, v, causal=True)
        with pytest.raises(ValueError, match="flash"):
            torch_sdpa(q, k, v, mask=torch.ones(16, 16, dtype=torch.bool))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), FWD_TOL, FWD_TOL)
    with pytest.raises(ValueError, match="causal"):
        torch_flash_lse(q, k, v, causal="bogus")


def _strides(b, t, h, d, layout, dtype=torch.bfloat16):
    """(B, T, H, D) element strides of q, k and v: split from a fused qkv
    projection (the training path), contiguous, or with a T stride of
    ``layout`` elements."""
    if layout == "fused":
        return [x.stride() for x in
                torch.empty(b, t, 3, h, d, dtype=dtype).unbind(2)]
    if layout == "contiguous":
        return [torch.empty(b, t, h, d, dtype=dtype).stride()] * 3
    st = layout
    return [(t * st, st, d, 1)] * 3


@pytest.mark.parametrize("dtype,t,d,layout,aligned,want", [
    # the path: (8, 2048, 12, 64) bf16, strided views of the fused qkv
    (torch.bfloat16, 2048, 64, "fused", True, "wgmma"),
    (torch.bfloat16, 1000, 64, "contiguous", True, "wgmma"),
    (torch.bfloat16, 1000, 40, "contiguous", True, "mma_sync"),
    (torch.bfloat16, 515, 128, "fused", True, "mma_sync"),
    (torch.float32, 2048, 64, "fused", True, "fma"),
    (torch.float32, 1000, 40, "contiguous", True, "fma"),
    # a T stride of 12 * 64 + 4 bf16 (1544 bytes): no design reads it
    (torch.bfloat16, 2048, 64, 12 * 64 + 4, True, ValueError),
    (torch.bfloat16, 2048, 64, "fused", False, ValueError),
    (torch.float32, 1000, 40, 12 * 40 + 2, True, ValueError),
])
def test_flash_design(dtype, t, d, layout, aligned, want):
    """The design a CUDA call takes, from dtype, shapes and strides alone."""
    strides = _strides(8, t, 12, d, layout, dtype)
    if want is ValueError:
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_design(dtype, t, t, d, strides, aligned)
    else:
        assert fa.flash_design(dtype, t, t, d, strides, aligned) == want


def test_older_design_only_on_a_wgmma_shape():
    """The private ``_older`` switch runs mma_sync where wgmma would run,
    and refuses a shape that does not take wgmma."""
    q, k, v = torch.empty(2, 64, 3, 2, 64, dtype=torch.bfloat16).unbind(2)
    assert fa._pick_design(False, q, k, v) == "wgmma"
    assert fa._pick_design(True, q, k, v) == "mma_sync"
    q, k, v = torch.empty(2, 64, 3, 2, 40, dtype=torch.bfloat16).unbind(2)
    assert fa._pick_design(False, q, k, v) == "mma_sync"
    with pytest.raises(ValueError, match="_older"):
        fa._pick_design(True, q, k, v)


def test_cpu_call_takes_plain_version_and_counts_nothing():
    """A CPU tensor goes to the plain versions, bit for bit, and moves
    neither the launch counts nor the counts by design."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 40, 3, 2, 64)).astype(np.float32))
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    do = torch.from_numpy(rng.standard_normal((2, 40, 2, 64)).astype(
        np.float32)).to(torch.bfloat16)
    before = [(w.launches, dict(w.launches_by_design))
              for w in (fa.flash_fwd, fa.flash_bwd)]
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_bwd(q, k, v, do, lse, delta, True, 0.125)
    grads_p = fa.flash_bwd_plain(q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_p))
    after = [(w.launches, dict(w.launches_by_design))
             for w in (fa.flash_fwd, fa.flash_bwd)]
    assert after == before
    assert set(fa.flash_fwd.launches_by_design) == set(fa.DESIGNS)
