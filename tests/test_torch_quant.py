"""The port's weight-only int8 quantization against the JAX package's
(``tpu_dist/nn/quant.py``): the converted int8 leaves and scales are
identical to the JAX converter's, ``load_jax_params`` loads its quantized
tree as int8, and the quantized model's logits agree with the JAX one's to
float32 rounding (``rtol=atol=1e-5``: the same int8 weights and scales,
float32 sums in another order), its greedy tokens token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn.quant import quantize_linear_weights as jax_quantize
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.nn import quantize_linear_weights

CFG = dict(vocab_size=251, dim=64, depth=2, num_heads=2, max_seq_len=64)
OPTS = [dict(), dict(attention=True), dict(attention=True, embedding=True)]


def _tree(params):
    return {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}


@pytest.fixture(scope="module", params=range(len(OPTS)),
                ids=["linear", "attention", "attention+embedding"])
def quantized(request):
    opts = OPTS[request.param]
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.key(0))
    tm = load_jax_params(TorchLM(**CFG, device="cpu"), _tree(params))
    jm, qparams = jax_quantize(jm, params, **opts)
    return jm, qparams, quantize_linear_weights(tm, **opts), opts


def test_leaves_identical_to_the_jax_converter(quantized):
    _, qparams, tm, opts = quantized
    ours = dict(tm.named_parameters())
    theirs = {f"{p}.{k}": np.asarray(v) for p, leaves in qparams.items()
              for k, v in leaves.items()}
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = ours[key].detach().numpy()
        # every 2-D leaf but the embedding tables is (out, in) in the port
        if got.ndim == 2 and not key.startswith(("tok.", "pos.")):
            got = got.T
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_load_jax_params_keeps_int8(quantized):
    """A quantized port topology takes the JAX package's quantized tree."""
    _, qparams, _, opts = quantized
    fresh = quantize_linear_weights(TorchLM(**CFG, device="cpu"), **opts)
    load_jax_params(fresh, _tree(qparams))
    head = fresh.head.q_weight
    assert head.dtype == torch.int8
    np.testing.assert_array_equal(head.numpy().T,
                                  np.asarray(qparams["head"]["q_weight"]))


def test_logits_and_tokens_match_jax(quantized):
    jm, qparams, tm, _ = quantized
    x = np.random.default_rng(0).integers(0, 251, (2, 9))
    want = np.asarray(jm.apply(qparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tm.generate(torch.from_numpy(x), 6).numpy(),
        np.asarray(jm.generate(qparams, jnp.asarray(x), 6)))


def test_load_refuses_a_float_leaf_for_int8():
    jm = JaxLM(**CFG)
    _, qparams = jax_quantize(jm, jm.init(jax.random.key(0)))
    tree = _tree(qparams)
    tree["head"]["q_weight"] = tree["head"]["q_weight"].astype(np.float32)
    fresh = quantize_linear_weights(TorchLM(**CFG, device="cpu"))
    with pytest.raises(ValueError, match="head.q_weight: an int8"):
        load_jax_params(fresh, tree)
