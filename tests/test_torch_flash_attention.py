"""The port's flash attention against the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions; the
JAX package's Pallas kernels run in interpret mode, as its own tests run
them.  Inputs are the same numpy arrays, float32; the tolerances are those
of tests/test_flash_attention.py: 2e-5 for the forward (line 42) and 5e-4
for the gradients (line 78)."""

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
        torch_flash_lse(q, k, v, causal="offdiag")
