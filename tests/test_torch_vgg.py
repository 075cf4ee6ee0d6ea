"""The port's VGG family against the JAX package's ``tpu_dist.models.vgg``.

The same numpy inputs, made from a seed, go through the JAX model (NHWC)
and the port's (NCHW); weights move with
``tpu_dist_torch.interop.load_jax_params`` (the first classifier Linear's
columns permuted from the JAX (h, w, c) flatten order to torch's (c, h, w))
and BatchNorm state with ``load_jax_state``.

Tolerances (float32): the logits within 1e-5 of the largest logit (the same
sums in another order), in eval for ``vgg11`` and in training (batch 8,
ROADMAP C7: at 32x32 the last BatchNorms see one value an image) for
``vgg11_bn``; the new running statistics within 1e-6 absolute plus 1e-5
relative.  Dropout's masks are the JAX package's for the same key, so the
training logits of ``vgg11`` (both dropouts live) hold to the same 1e-5.
Planted faults the checks must reject: the first classifier Linear loaded
with a plain transpose, and a second dropout key."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist_torch import models as tmodels
from tpu_dist_torch import nn as tnn
from tpu_dist_torch.interop import (flatten_linear_from_torch, jax_state,
                                    load_jax_params, load_jax_state)

RTOL = 1e-5
NAMES = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
         "vgg16_bn", "vgg19_bn")
# torchvision's published counts (tests/test_models.py holds the JAX ones)
COUNTS = {"vgg11": 132_863_336, "vgg13": 133_047_848, "vgg16": 138_357_544,
          "vgg19": 143_667_240, "vgg11_bn": 132_868_840,
          "vgg13_bn": 133_053_736, "vgg16_bn": 138_365_992,
          "vgg19_bn": 143_678_248}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return err <= rtol * max(np.abs(want).max(), 1e-30)


def _key_data(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key))
                            .astype(np.int64))

@pytest.fixture(autouse=True)
def _two_threads():
    """torch's intra-op threads held to two for each test: the suite runs
    several files at once, and a small model's ops on every core of a
    shared host spend their time contending, not computing."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    try:
        yield
    finally:
        torch.set_num_threads(saved)



@pytest.mark.parametrize("name", NAMES)
def test_parameter_counts_match_torchvision(name):
    model = getattr(tmodels, name)(device="meta")
    assert sum(p.numel() for p in model.parameters()) == COUNTS[name]


@pytest.mark.parametrize("name", ["vgg11", "vgg16_bn"])
def test_paths_and_shapes_match_jax(name):
    jm = getattr(jmodels, name)(num_classes=10)
    params = jax.eval_shape(jm.init, jax.random.key(0))
    tm = getattr(tmodels, name)(num_classes=10, device="meta")
    theirs = {f"{p}.{leaf}": tuple(a.shape) for p, leaves in params.items()
              for leaf, a in leaves.items()}
    ours = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert set(theirs) == set(ours)
    for k, shape in ours.items():
        # Linear (out, in) against (in, out); a convolution OIHW against HWIO
        want = theirs[k]
        if len(shape) == 2:
            want = want[::-1]
        elif len(shape) == 4:
            want = (want[3], want[2], want[0], want[1])
        assert shape == want, k
    if name.endswith("_bn"):
        bns = {p for p, m in tm.named_modules()
               if isinstance(m, tnn.BatchNorm2d)}
        assert bns == set(jm.init_state())


def test_init_follows_torchvision():
    tm = tmodels.vgg11_bn(num_classes=10, device="cpu")
    tnn.reset_parameters(tm, torch.Generator().manual_seed(0))
    for i in (0, 3, 6):
        w, b = tm.classifier[i].weight.detach(), tm.classifier[i].bias
        assert abs(float(w.std()) - 0.01) < 5e-4 and not b.any()
    conv = tm.features[0]
    std = float(conv.weight.detach().std())
    assert abs(std - (2 / (64 * 9)) ** 0.5) < 5e-3
    assert not conv.bias.any()
    bn = tm.features[1]
    assert bool((bn.weight == 1).all()) and not bn.bias.any()


@functools.lru_cache(maxsize=None)
def _pair(name):
    """A JAX VGG with seeded weights (10 classes) and the port's with the
    same weights; a batch of 8 32x32 images."""
    jm = getattr(jmodels, name)(num_classes=10)
    params = _np_tree(jax.jit(jm.init)(jax.random.key(1)))
    tm = getattr(tmodels, name)(num_classes=10, device="cpu")
    load_jax_params(tm, params)
    x = np.random.default_rng(8).normal(size=(8, 32, 32, 3)) \
        .astype(np.float32)
    return name, jm, params, tm, x


def _apply(jm, params, x, training, state=None, rng=None):
    kw = {"training": training}
    if state is not None:
        kw["state"] = state
    if rng is not None:
        kw["rng"] = rng
    return jm.apply(params, jnp.asarray(x), **kw)


@pytest.mark.parametrize("name", ["vgg11", "vgg11_bn"])
def test_logits_match_jax(name):
    """``vgg11`` in eval; ``vgg11_bn`` in training (batch statistics, the
    running statistics updated, dropout live) from random running
    statistics."""
    _, jm, params, tm, x = _pair(name)
    key = jax.random.key(5)
    if name == "vgg11":
        want = np.asarray(_apply(jm, params, x, False))
        tm.eval()
        with torch.no_grad():
            got = tm(_nchw(x)).numpy()
        assert got.shape == want.shape == (8, 10)
        assert _close(got, want), np.abs(got - want).max()
        return
    rng = np.random.default_rng(9)
    state = {p: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape)
                 .astype(np.float32)}
             for p, v in _np_tree(jm.init_state()).items()}
    want, new_state = _apply(jm, params, x, True, state=state, rng=key)
    load_jax_state(tm, state)
    tm.train()
    with torch.no_grad(), tnn.rng_scope(_key_data(key)):
        got = tm(_nchw(x)).numpy()
    assert _close(got, np.asarray(want)), np.abs(got - np.asarray(want)).max()
    new_state = _np_tree(new_state)
    ours = jax_state(tm)
    assert set(ours) == set(new_state) and len(ours) == 8
    for p in ours:
        for k in ("mean", "var"):
            np.testing.assert_allclose(ours[p][k], new_state[p][k],
                                       rtol=1e-5, atol=1e-6, err_msg=p)


def test_dropout_masks_match_jax():
    """Training mode with both dropouts live: the port under
    ``rng_scope(key)`` equals the JAX model under ``rng=key``; another key
    changes the logits past the tolerance (the masks matter)."""
    _, jm, params, tm, x = _pair("vgg11")
    key = jax.random.key(7)
    want = np.asarray(_apply(jm, params, x, True, rng=key))
    tm.train()
    with torch.no_grad():
        with tnn.rng_scope(_key_data(key)):
            got = tm(_nchw(x)).numpy()
        with tnn.rng_scope(_key_data(jax.random.key(8))):
            other = tm(_nchw(x)).numpy()
    assert _close(got, want), np.abs(got - want).max()
    assert not _close(other, want)


def test_rejects_plain_transposed_classifier():
    """The planted fault: ``classifier.0`` loaded with a plain transpose
    (right shape, the JAX (h, w, c) column order) must fail the logits
    check, though the 7x7 map repeats one value a channel: column ``j``
    multiplies channel ``j % 512`` in the JAX order and ``j // 49`` in
    torch's."""
    _, jm, params, tm, x = _pair("vgg11")
    want = np.asarray(_apply(jm, params, x, False))
    bad = dict(params)
    w = params["classifier.0"]["weight"]
    # undo the permutation the loader applies: the net effect is the plain
    # transpose
    bad["classifier.0"] = dict(params["classifier.0"],
                               weight=flatten_linear_from_torch(512, 7, 7)(
                                   np.ascontiguousarray(w.T)))
    plain = tmodels.vgg11(num_classes=10, device="cpu")
    load_jax_params(plain, bad)
    plain.eval()
    with torch.no_grad():
        got = plain(_nchw(x)).numpy()
    assert got.shape == want.shape
    assert not _close(got, want)


def test_adaptive_pool_upsamples_1x1_like_jax():
    """At 32x32 the features end at 1x1 and ``AdaptiveAvgPool2d((7, 7))``
    repeats each value over 7x7, as the JAX layer does."""
    x = np.random.default_rng(4).normal(size=(3, 1, 1, 512)) \
        .astype(np.float32)
    layer = jnn.AdaptiveAvgPool2d((7, 7))
    want = np.asarray(layer.apply(layer.init(jax.random.key(0)),
                                  jnp.asarray(x)))
    got = tnn.AdaptiveAvgPool2d((7, 7))(_nchw(x)).numpy() \
        .transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (3, 7, 7, 512)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.broadcast_to(x, got.shape))
