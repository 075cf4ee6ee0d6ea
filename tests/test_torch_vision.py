"""The port's vision layers, models and weight interop against the JAX
package's.

The same numpy inputs, made from a seed, go through the JAX layer (NHWC,
HWIO) and the port's (NCHW, OIHW); weights move with
``tpu_dist_torch.interop.load_jax_params`` and BatchNorm state with
``load_jax_state``.

Tolerances (float32): each layer's output within 1e-5 of the largest
reference magnitude (the same sums in another order); BatchNorm's new
running statistics within 1e-6 absolute plus 1e-5 relative; the ConvNet,
ResNet-18 and ResNet-50 logits within 1e-5 relative to the largest logit.
In training mode ResNet-18's logits are held to 5e-5: every BatchNorm
divides by its batch's standard deviation, and layer4's reduce one value an
image (1x1 maps), which amplifies the rounding of the layers below (about
1e-5 measured at batches 8 to 64).
Dropout's mask and kept values are held bit for bit.  Each check is also
shown to reject a planted fault: a biased running variance, and a ConvNet
``fc1`` loaded with a plain transpose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist.nn import functional as JF
from tpu_dist_torch import models as tmodels
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import random as trandom
from tpu_dist_torch.interop import (flatten_linear_from_torch,
                                    flatten_linear_to_torch, jax_state,
                                    load_jax_params, load_jax_state)
from tpu_dist_torch.nn import functional as TF
from tpu_dist_torch.nn import layers as tlayers

RTOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return err <= rtol * max(np.abs(want).max(), 1e-30)


def _jax_layer(layer, x, training=False, state=None, rng=None):
    params = layer.init(jax.random.key(0))
    kw = {"training": training}
    if state is not None:
        kw["state"] = state
    if rng is not None:
        kw["rng"] = rng
    return params, layer.apply(params, jnp.asarray(x), **kw)


@pytest.mark.parametrize("cfg", [
    dict(cin=3, cout=8, k=3, stride=1, padding=1, dilation=1, groups=1),
    dict(cin=4, cout=6, k=5, stride=2, padding=2, dilation=1, groups=1),
    dict(cin=4, cout=8, k=3, stride=1, padding=2, dilation=2, groups=1),
    dict(cin=6, cout=9, k=3, stride=2, padding=0, dilation=1, groups=3),
    dict(cin=3, cout=5, k=(3, 1), stride=(1, 2), padding=(1, 0), dilation=1,
         groups=1),
], ids=["3x3", "5x5_s2", "dilated", "grouped", "rect"])
def test_conv2d_matches_jax(cfg):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 9, cfg["cin"])).astype(np.float32)
    kw = dict(kernel_size=cfg["k"], stride=cfg["stride"],
              padding=cfg["padding"], dilation=cfg["dilation"],
              groups=cfg["groups"])
    layer = jnn.Conv2d(cfg["cin"], cfg["cout"], **kw)
    kh, kw_ = layer.kernel_size
    params = {"": {"weight": rng.normal(size=(
        kh, kw_, cfg["cin"] // cfg["groups"], cfg["cout"])).astype(np.float32),
        "bias": rng.normal(size=cfg["cout"]).astype(np.float32)}}
    want = layer.apply(params, jnp.asarray(x))
    conv = tnn.Conv2d(cfg["cin"], cfg["cout"], device="cpu", **kw)
    load_jax_params(conv, params)
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == want.shape
    assert _close(got, want)


@pytest.mark.parametrize("k,stride,padding,shape", [
    (2, 2, 0, (2, 10, 10, 3)), (2, 1, 0, (2, 11, 11, 3)),
    (3, 2, 1, (2, 16, 16, 4)), (3, 2, 1, (2, 7, 9, 2)),
    ((2, 3), (1, 2), (1, 1), (1, 6, 7, 2)),
], ids=["2x2s2", "2x2s1", "resnet_stem", "stem_odd", "rect_padded"])
def test_max_pool_matches_jax(k, stride, padding, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    _, want = _jax_layer(jnn.MaxPool2d(k, stride, padding), x)
    got = _nhwc(tnn.MaxPool2d(k, stride, padding)(_nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("k,stride,padding", [
    (2, None, 0), (3, 2, 1), ((2, 3), 1, 0)], ids=["2x2", "3x3s2p1", "rect"])
def test_avg_pool_matches_jax(k, stride, padding):
    x = np.random.default_rng(2).normal(size=(2, 9, 8, 3)).astype(np.float32)
    _, want = _jax_layer(jnn.AvgPool2d(k, stride, padding), x)
    got = _nhwc(tnn.AvgPool2d(k, stride, padding)(_nchw(x)))
    assert got.shape == want.shape
    assert _close(got, want)


@pytest.mark.parametrize("out,shape", [
    (1, (2, 4, 4, 5)), ((3, 2), (2, 7, 5, 3)), ((4, 3), (1, 5, 7, 2))],
    ids=["global", "not_dividing", "not_dividing_2"])
def test_adaptive_avg_pool_matches_jax(out, shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    _, want = _jax_layer(jnn.AdaptiveAvgPool2d(out), x)
    got = _nhwc(tnn.AdaptiveAvgPool2d(out)(_nchw(x)))
    assert got.shape == want.shape
    assert _close(got, want)


def _bn_case(training, momentum=0.1, shape=(4, 5, 3, 6)):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=shape) * 2.0 + 0.7).astype(np.float32)
    c = shape[-1]
    state = {"": {"mean": rng.normal(size=c).astype(np.float32),
                  "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    layer = jnn.BatchNorm2d(c, momentum=momentum)
    params = {"": {"weight": rng.normal(size=c).astype(np.float32),
                   "bias": rng.normal(size=c).astype(np.float32)}}
    want, new_state = layer.apply(params, jnp.asarray(x), state=state,
                                  training=training)
    bn = tnn.BatchNorm2d(c, momentum=momentum, device="cpu")
    load_jax_params(bn, params)
    load_jax_state(bn, state)
    bn.train(training)
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    return got, want, jax_state(bn)[""], _np_tree(new_state)[""]


def _bn_matches(got, want, st, new_st):
    return _close(got, want) and all(
        np.allclose(st[k], new_st[k], rtol=1e-5, atol=1e-6)
        for k in ("mean", "var"))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(training):
    got, want, st, new_st = _bn_case(training)
    assert _bn_matches(got, want, st, new_st)
    if not training:  # eval mode leaves the running statistics alone
        rng = np.random.default_rng(4)
        rng.normal(size=(4, 5, 3, 6))
        np.testing.assert_array_equal(st["mean"],
                                      rng.normal(size=6).astype(np.float32))


def test_batch_norm_rejects_biased_running_variance(monkeypatch):
    """The planted fault: a running variance updated with the biased batch
    variance must fail the same check."""
    monkeypatch.setattr(tlayers, "unbiased_var", lambda var, n: var)
    got, want, st, new_st = _bn_case(True)
    assert _close(got, want)  # the output does not see it
    assert not _bn_matches(got, want, st, new_st)


def test_batch_norm_of_rows():
    """(N, C) input, the JAX package's BatchNorm over a Linear's output."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 4)).astype(np.float32)
    layer = jnn.BatchNorm2d(4)
    params = layer.init(jax.random.key(0))
    want, new_state = layer.apply(params, jnp.asarray(x),
                                  state=layer.init_state(), training=True)
    bn = tnn.BatchNorm2d(4, device="cpu")
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).numpy()
    assert _close(got, want)
    st = _np_tree(new_state)[""]
    np.testing.assert_allclose(bn.running_var.numpy(), st["var"], rtol=1e-5)


def test_dropout_mask_matches_jax_bit_for_bit():
    x = np.random.default_rng(6).normal(size=(3, 4, 5, 6)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(JF.dropout(jnp.asarray(x), 0.3, key, training=True))
    key_data = torch.from_numpy(np.asarray(jax.random.key_data(key))
                                .astype(np.int64))
    got = TF.dropout(torch.from_numpy(x), 0.3, key_data).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.2 < (got == 0).mean() < 0.4
    # the layer draws fold_in(key, 0) from its scope, as apply(rng=) does
    _, want = _jax_layer(jnn.Dropout(0.5), x, training=True, rng=key)
    drop = tnn.Dropout(0.5)
    with tnn.rng_scope(key_data):
        got = drop(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    drop.eval()
    np.testing.assert_array_equal(drop(torch.from_numpy(x)).numpy(), x)
    with pytest.raises(ValueError, match="rng_scope"):
        tnn.Dropout(0.5)(torch.from_numpy(x))


def test_kaiming_normal_fan_out_std():
    conv = tmodels.resnet._KaimingConv2d(16, 64, 3, bias=False, device="cpu")
    conv.reset_parameters(torch.Generator().manual_seed(0))
    want = np.sqrt(2.0 / (64 * 9))
    assert abs(float(conv.weight.detach().std()) / want - 1.0) < 0.05
    jw = jnn.init.kaiming_normal(jax.random.key(0), (3, 3, 16, 64),
                                 mode="fan_out", nonlinearity="relu")
    assert abs(float(jnp.std(jw)) / want - 1.0) < 0.05


def test_flatten_linear_permutations_are_inverse():
    rng = np.random.default_rng(7)
    t = rng.normal(size=(10, 8 * 3 * 2)).astype(np.float32)
    a = flatten_linear_from_torch(8, 3, 2)(t)
    assert a.shape == (3 * 2 * 8, 10)
    np.testing.assert_array_equal(flatten_linear_to_torch(8, 3, 2)(a), t)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _jax_model(name):
    return {"convnet": jmodels.ConvNet, "resnet18":
            lambda: jmodels.resnet18(num_classes=10), "resnet50":
            lambda: jmodels.resnet50(num_classes=10)}[name]()


def _port_model(name):
    return {"convnet": tmodels.ConvNet, "resnet18":
            lambda device: tmodels.resnet18(num_classes=10, device=device),
            "resnet50": lambda device: tmodels.resnet50(num_classes=10,
                                                        device=device)
            }[name](device="cpu")


def _random_state(state, rng):
    return {p: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, v["var"].shape)
                .astype(np.float32)} for p, v in state.items()}


def _logits(name, training, batch, load=load_jax_params):
    rng = np.random.default_rng(8)
    jm = _jax_model(name)
    # one compiled program each for init and apply, not one an op
    params = _np_tree(jax.jit(jm.init)(jax.random.key(1)))
    apply = jax.jit(jm.apply, static_argnames="training")
    hw, c = ((28, 28), 1) if name == "convnet" else ((32, 32), 3)
    x = rng.normal(size=(batch, *hw, c)).astype(np.float32)
    tm = _port_model(name)
    load(tm, params)
    tm.train(training)
    if jm.has_state():
        state = _random_state(_np_tree(jm.init_state()), rng)
        want, new_state = apply(params, jnp.asarray(x), state=state,
                                training=training)
        load_jax_state(tm, state)
    else:
        want, new_state = apply(params, jnp.asarray(x)), None
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
    return got, np.asarray(want), tm, new_state


@pytest.mark.parametrize("name,training,batch", [
    ("convnet", False, 4), ("resnet18", False, 4), ("resnet18", True, 16),
    ("resnet50", False, 2)],
    ids=["convnet", "resnet18_eval", "resnet18_train", "resnet50_eval"])
def test_model_logits_match_jax(name, training, batch):
    got, want, tm, new_state = _logits(name, training, batch)
    assert got.shape == want.shape == (batch, 10)
    assert _close(got, want, 5e-5 if training else RTOL), \
        np.abs(got - want).max()
    if training:  # and every BatchNorm's new running statistics
        new_state = _np_tree(new_state)
        ours = jax_state(tm)
        assert set(ours) == set(new_state)
        for p in ours:
            for k in ("mean", "var"):
                np.testing.assert_allclose(ours[p][k], new_state[p][k],
                                           rtol=1e-5, atol=1e-6, err_msg=p)


def test_convnet_rejects_plain_transposed_fc1():
    """The planted fault: ``fc1`` loaded with a plain transpose (right
    shape, NHWC column order) must fail the logits check."""
    def plain(model, params):
        params = dict(params)
        w = params["fc1"]["weight"]
        params["fc1"] = dict(params["fc1"])
        # undo the permutation the loader will apply, so the net effect is
        # the plain transpose
        params["fc1"]["weight"] = flatten_linear_from_torch(128, 4, 4)(w.T)
        return load_jax_params(model, params)

    got, want, _, _ = _logits("convnet", False, 4, load=plain)
    assert got.shape == want.shape
    assert not _close(got, want)


def test_model_paths_and_sizes_match_jax():
    for name, n_params in (("convnet", 113_674), ("resnet18", 11_181_642)):
        jm = _jax_model(name)
        params = _np_tree(jax.eval_shape(jm.init, jax.random.key(0)))
        tm = _port_model(name)
        keys = {f"{p}.{leaf}" for p, leaves in params.items()
                for leaf in leaves}
        assert keys == set(dict(tm.named_parameters()))
        assert sum(p.numel() for p in tm.parameters()) == n_params
    tm = _port_model("resnet18")
    assert "layer1.0.downsample.0.weight" not in dict(tm.named_parameters())
    assert "layer2.0.downsample.0.weight" in dict(tm.named_parameters())
    assert len(jax_state(tm)) == 20


def test_interop_state_raises_on_mismatch():
    tm = _port_model("resnet18")
    st = jax_state(tm)
    extra = dict(st, **{"nope": st["bn1"]})
    with pytest.raises(KeyError, match="nope"):
        load_jax_state(tm, extra)
    missing = {k: v for k, v in st.items() if k != "bn1"}
    with pytest.raises(KeyError, match="bn1"):
        load_jax_state(tm, missing)
    bad = dict(st, bn1={"mean": np.zeros(3), "var": np.ones(3)})
    with pytest.raises(ValueError, match="bn1"):
        load_jax_state(tm, bad)


def test_reset_parameters_resets_running_stats():
    tm = _port_model("resnet18")
    with torch.no_grad():
        tm.bn1.running_mean.fill_(3.0)
        tm.bn1.running_var.fill_(5.0)
    tnn.reset_parameters(tm, torch.Generator().manual_seed(0))
    assert torch.equal(tm.bn1.running_mean, torch.zeros(64))
    assert torch.equal(tm.bn1.running_var, torch.ones(64))


def test_random_key_matches_jax():
    for seed in (0, 7):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.key(seed), 0x5EED)))
        got = trandom.fold_in(trandom.key(seed), 0x5EED).numpy()
        np.testing.assert_array_equal(got, want)
