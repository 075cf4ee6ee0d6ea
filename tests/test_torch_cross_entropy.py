"""The port's cross-entropy against the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions, and
the JAX package's Pallas kernel runs in interpret mode; both see the same
numpy inputs.  Everything is float32, so the tolerances are float32 ones:
the two sides sum the same terms in another order (1e-5 relative, 1e-6
absolute on values of order 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist.ops import fused_cross_entropy as jax_fused_ce
from tpu_dist.ops.cross_entropy import _call_fwd as jax_call_fwd
from tpu_dist_torch import nn as tnn
from tpu_dist_torch.ops import cross_entropy as tce

torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6


def _inputs(n, v, label_dtype, seed=0, ignored=0.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, n).astype(label_dtype)
    labels[rng.random(n) < ignored] = -100
    cot = rng.standard_normal(n).astype(np.float32)
    return logits, labels, cot


@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,v", [(16, 128), (13, 1000), (7, 50)])
def test_fused_forward_lse_and_grad_match_jax(n, v, label_dtype):
    """Ragged V (not a lane multiple) and ragged N; nll, the saved lse and
    the gradient of a random cotangent."""
    logits, labels, cot = _inputs(n, v, label_dtype, seed=n * v)
    nll_j, vjp = jax.vjp(
        lambda x: jax_fused_ce(x, jnp.asarray(labels), "none"),
        jnp.asarray(logits))
    (g_j,) = vjp(jnp.asarray(cot))
    _, lse_j = jax_call_fwd(jnp.asarray(logits), jnp.asarray(labels))

    x = torch.tensor(logits, requires_grad=True)
    y = torch.from_numpy(labels)
    nll_t = tce.fused_cross_entropy(x, y, "none")
    (g_t,) = torch.autograd.grad(nll_t, x, torch.from_numpy(cot))
    _, lse_t = tce.cross_entropy_fwd(x.detach(), y)

    np.testing.assert_allclose(nll_t.detach().numpy(), nll_j, RTOL, ATOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, RTOL, ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, RTOL, ATOL)


def test_out_of_range_label_picks_nothing_like_jax():
    """A label outside [0, V) reaching the kernel gives nll = lse and no
    one-hot term, in both packages (the loss module masks such rows before
    the kernel; this pins the kernel-level convention)."""
    logits, labels, cot = _inputs(12, 33, np.int32, seed=3, ignored=0.3)
    assert (labels == -100).any()
    nll_j, vjp = jax.vjp(
        lambda x: jax_fused_ce(x, jnp.asarray(labels), "none"),
        jnp.asarray(logits))
    (g_j,) = vjp(jnp.asarray(cot))
    x = torch.tensor(logits, requires_grad=True)
    nll_t = tce.fused_cross_entropy(x, torch.from_numpy(labels), "none")
    (g_t,) = torch.autograd.grad(nll_t, x, torch.from_numpy(cot))
    np.testing.assert_allclose(nll_t.detach().numpy(), nll_j, RTOL, ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, RTOL, ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kwargs", [
    {"fused": True},
    {"fused": False},
    {"fused": False, "label_smoothing": 0.1},
    {"fused": False, "weight": "random"},
], ids=["fused", "plain", "smoothing", "weight"])
def test_loss_module_matches_jax(kwargs, reduction):
    """CrossEntropyLoss with ignore_index rows, (B, T, V) logits, value and
    gradient, against tpu_dist.nn.CrossEntropyLoss."""
    b, t, v = 3, 5, 41
    logits, labels, _ = _inputs(b * t, v, np.int64, seed=11, ignored=0.25)
    logits = logits.reshape(b, t, v)
    labels = labels.reshape(b, t)
    kw = dict(kwargs)
    if kw.get("weight") == "random":
        kw["weight"] = np.random.default_rng(5).uniform(0.5, 2.0, v).astype(
            np.float32)
    loss_j = jnn.CrossEntropyLoss(reduction=reduction, **kw)
    loss_t = tnn.CrossEntropyLoss(reduction=reduction, **kw)

    def f(x):
        out = loss_j(x, jnp.asarray(labels))
        return out.sum() if reduction == "none" else out

    val_j, g_j = jax.value_and_grad(f)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out_t = loss_t(x, torch.from_numpy(labels))
    val_t = out_t.sum() if reduction == "none" else out_t
    (g_t,) = torch.autograd.grad(val_t, x)
    if reduction == "none":
        np.testing.assert_allclose(out_t.detach().numpy().reshape(-1),
                                   np.asarray(loss_j(jnp.asarray(logits),
                                                     jnp.asarray(labels))
                                              ).reshape(-1), RTOL, ATOL)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), RTOL, 1e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, RTOL, ATOL)


def test_fused_refuses_smoothing_and_weight():
    with pytest.raises(ValueError, match="fused"):
        tnn.CrossEntropyLoss(fused=True, label_smoothing=0.1)
    with pytest.raises(ValueError, match="fused"):
        tnn.CrossEntropyLoss(fused=True, weight=np.ones(3, np.float32))


def test_cuda_check_refuses_a_cpu_tensor():
    """The kernel wrappers' device check refuses a CPU tensor rather than
    copying it to the card."""
    from tpu_dist_torch.ops import _build
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_tensor("logits", torch.zeros(2, 3),
                                 (torch.float32,), 2)
