"""The port's rule table (``tpu_dist_torch/parallel/rules.py``) against the
JAX package's (``tpu_dist/parallel/rules.py``) — the twin of
``tests/test_rules.py``'s host half.

Spans and shards are held bit for bit to the JAX package's for every
``TRANSFORMER_LAYOUTS`` leaf at shard worlds 1-4, on the GPT-2-small shapes
the serve cell runs and on the tests' tiny model, under both rule tables;
the golden legacy serving helpers pin them as in the JAX test; the named
``ShardLayoutError``s are the same; the flat chunk contract is one
implementation (the ring's) in ZeRO, the bucketer and reshard."""

import re

import numpy as np
import pytest
import torch

from tpu_dist.collectives.ring import _bounds as jax_ring_bounds
from tpu_dist.parallel import rules as JR
from tpu_dist_torch import interop
from tpu_dist_torch.models import TransformerLM
from tpu_dist_torch.parallel import rules as R

# GPT-2-small (the serve cell) and the JAX rules test's tiny model
GPT2 = dict(vocab=32768, dim=768, depth=12, heads=12, seq=2048)
TINY = dict(vocab=64, dim=32, depth=2, heads=4, seq=16)


def _shapes(vocab, dim, depth, heads, seq):
    """``{path: {name: shape}}`` of a TransformerLM in the JAX layout."""
    out = {"tok": {"weight": (vocab, dim)}, "pos": {"weight": (seq, dim)},
           "ln_f": {"weight": (dim,), "bias": (dim,)},
           "head": {"weight": (dim, vocab), "bias": (vocab,)}}
    for i in range(depth):
        b = f"block{i}"
        out[f"{b}.ln1"] = out[f"{b}.ln2"] = {"weight": (dim,),
                                              "bias": (dim,)}
        out[f"{b}.attn"] = {"qkv_weight": (dim, 3 * dim),
                            "qkv_bias": (3 * dim,),
                            "out_weight": (dim, dim), "out_bias": (dim,)}
        out[f"{b}.mlp.0"] = {"weight": (dim, 4 * dim), "bias": (4 * dim,)}
        out[f"{b}.mlp.2"] = {"weight": (4 * dim, dim), "bias": (dim,)}
    return out


def _axes(vocab, dim, depth, heads, seq):
    return {"qkv3": 3, "embed": dim, "heads": heads, "head_dim": dim // heads,
            "mlp": 4 * dim, "vocab": vocab, "seq": seq}


def _port_lm(**cfg):
    model = TransformerLM(cfg["vocab"], dim=cfg["dim"], depth=cfg["depth"],
                          num_heads=cfg["heads"], max_seq_len=cfg["seq"],
                          device="cpu")
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    return model


def test_tables_equal_the_jax_package():
    assert R.DEFAULT_RULES == JR.DEFAULT_RULES
    assert R.SERVING_RULES == JR.SERVING_RULES
    assert len(R.TRANSFORMER_LAYOUTS) == len(JR.TRANSFORMER_LAYOUTS)
    for (p, n, lay), (jp, jn, jlay) in zip(R.TRANSFORMER_LAYOUTS,
                                           JR.TRANSFORMER_LAYOUTS):
        assert (p, n, lay.dims, lay.partial_axis) == \
            (jp, jn, jlay.dims, jlay.partial_axis)


@pytest.mark.parametrize("cfg", [GPT2, TINY], ids=["gpt2_small", "tiny"])
@pytest.mark.parametrize("binding", ["serving", "training"])
def test_spans_equal_jax_worlds_1_to_4(cfg, binding):
    """Every leaf of every layout row, every rank of worlds 1-4: the same
    spans and local shape as the JAX package's ``spans_for``."""
    rules, jrules, mesh, partial = (
        (R.SERVING_RULES, JR.SERVING_RULES, "shard", "first")
        if binding == "serving" else
        (R.DEFAULT_RULES, JR.DEFAULT_RULES, "model", "replicate"))
    shapes, axes = _shapes(**cfg), _axes(**cfg)
    for world in (1, 2, 3, 4):
        for rank in range(world):
            for path, leaves in shapes.items():
                for name, shape in leaves.items():
                    key = (world, rank, path, name)
                    try:
                        want = JR.spans_for(path, name, shape, axes, rank,
                                            world, rules=jrules,
                                            mesh_axis=mesh, partial=partial)
                    except JR.ShardLayoutError as e:
                        # world 3 does not divide 4 heads (tiny): the same
                        # named refusal
                        with pytest.raises(R.ShardLayoutError,
                                           match=re.escape(str(e))):
                            R.spans_for(path, name, shape, axes, rank,
                                        world, rules=rules, mesh_axis=mesh,
                                        partial=partial)
                        continue
                    got = R.spans_for(path, name, shape, axes, rank, world,
                                      rules=rules, mesh_axis=mesh,
                                      partial=partial)
                    if want is None:
                        assert got is None, key
                        continue
                    assert [tuple(s) for s in got[0]] == \
                        [tuple(s) for s in want[0]], key
                    assert tuple(got[1]) == tuple(want[1]), key


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_leaf_equals_jax_on_the_tiny_model(world):
    """The materialized shards of a port model's tree (``interop.
    jax_params``) equal the JAX package's ``shard_leaf`` bit for bit."""
    cfg = dict(TINY, heads=12, dim=24)
    tree = interop.jax_params(_port_lm(**cfg))
    axes = R.model_axes(_port_lm(**cfg))
    for rank in range(world):
        for path, leaves in tree.items():
            for name, arr in leaves.items():
                plan = R.spans_for(path, name, arr.shape, axes, rank, world,
                                   rules=R.SERVING_RULES, mesh_axis="shard")
                jplan = JR.spans_for(path, name, arr.shape, axes, rank,
                                     world, rules=JR.SERVING_RULES,
                                     mesh_axis="shard")
                got, want = R.shard_leaf(arr, plan), JR.shard_leaf(arr, jplan)
                if want is None:
                    assert got is None
                else:
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)


def _legacy_leaf_spans(path, name, shape, dims, rank, world):
    """serve/sharded.py's span math before the rule table (the JAX test's
    golden reference), for the attention and MLP leaves."""
    H, hd = dims["num_heads"], dims["head_dim"]
    nl, hl = H // world, dims["hidden"] // world
    h0, c0 = rank * nl, rank * hl
    if name in ("out_bias",) or (path.endswith("mlp.2") and name == "bias"):
        return None if rank else ([(0, shape[0])], shape)
    if name == "qkv_weight":
        dim, three = shape
        return ([(i * three + (c * H + h0) * hd,
                  i * three + (c * H + h0) * hd + nl * hd)
                 for i in range(dim) for c in range(3)], (dim, 3 * nl * hd))
    if name == "qkv_bias":
        return ([((c * H + h0) * hd, (c * H + h0) * hd + nl * hd)
                 for c in range(3)], (3 * nl * hd,))
    if name == "out_weight":
        return [(h0 * hd * shape[1], (h0 + nl) * hd * shape[1])], \
            (nl * hd, shape[1])
    if path.endswith("mlp.2"):
        return [(c0 * shape[1], (c0 + hl) * shape[1])], (hl, shape[1])
    if path.endswith("mlp.0") and name == "weight":
        return ([(i * shape[1] + c0, i * shape[1] + c0 + hl)
                 for i in range(shape[0])], (shape[0], hl))
    return [(c0, c0 + hl)], (hl,)


def _merge(spans):
    out = []
    for lo, hi in spans:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_serving_spans_match_legacy(world):
    shapes, axes = _shapes(**TINY), _axes(**TINY)
    dims = {"num_heads": 4, "head_dim": 8, "hidden": 128}
    for rank in range(world):
        for path in ("block0.attn", "block1.mlp.0", "block1.mlp.2"):
            for name, shape in shapes[path].items():
                plan = R.spans_for(path, name, shape, axes, rank, world,
                                   rules=R.SERVING_RULES, mesh_axis="shard")
                legacy = _legacy_leaf_spans(path, name, shape, dims, rank,
                                            world)
                if legacy is None:
                    assert plan is None, (world, rank, path, name)
                    continue
                assert _merge(plan[0]) == _merge(legacy[0]), \
                    (world, rank, path, name)
                assert tuple(plan[1]) == tuple(legacy[1])


def test_training_spans_replicate_partial_biases():
    axes = _axes(**TINY)
    for rank in range(2):
        for path, name in (("block0.attn", "out_bias"),
                           ("block0.mlp.2", "bias")):
            assert R.spans_for(path, name, (32,), axes, rank, 2,
                               rules=R.DEFAULT_RULES, mesh_axis="model",
                               partial="replicate") == ([(0, 32)], (32,))


@pytest.mark.parametrize("case", ["indivisible", "conflict", "missing_axis",
                                  "bad_factors"])
def test_named_layout_errors_match_jax(case):
    axes = _axes(**TINY)
    rules = R.DEFAULT_RULES
    args = ("block0.attn", "qkv_weight", (32, 96), axes, 0, 3)
    if case == "conflict":
        rules = dict(R.DEFAULT_RULES, qkv3="model", heads="model")
        args = ("block0.attn", "qkv_weight", (32, 96),
                {"embed": 32, "qkv3": 3, "heads": 4, "head_dim": 8}, 0, 2)
    elif case == "missing_axis":
        args = ("block0.attn", "qkv_weight", (32, 96), {"embed": 32}, 0, 2)
    elif case == "bad_factors":
        args = ("block0.attn", "qkv_weight", (32, 90), axes, 0, 2)
    with pytest.raises(JR.ShardLayoutError) as want:
        JR.spans_for(*args, rules=rules, mesh_axis="model")
    with pytest.raises(R.ShardLayoutError) as got:
        R.spans_for(*args, rules=rules, mesh_axis="model")
    assert str(got.value) == str(want.value)
    assert issubclass(R.ShardLayoutError, ValueError)


@pytest.mark.parametrize("n,world", [(0, 4), (1, 4), (7, 3), (16, 4),
                                     (1000, 7), (4096, 8)])
def test_chunk_bounds_are_one_contract(n, world):
    from tpu_dist_torch.collectives import bucketer, ring
    from tpu_dist_torch.collectives.ring import ring_chunk_span
    from tpu_dist_torch.parallel import zero
    from tpu_dist_torch.resilience import reshard

    want = jax_ring_bounds(n, world)
    assert R.chunk_bounds(n, world) == want
    # one implementation under one name: every user holds the ring's
    for mod in (bucketer, reshard, zero):
        assert mod.chunk_bounds is R.chunk_bounds is ring._bounds
    assert R.chunk_bounds(np.int64(n), np.int64(world)) == want
    assert all(type(x) is int for lh in R.chunk_bounds(np.int64(n), world)
               for x in lh)
    for r in range(world):
        assert R.chunk_span(n, world, r) == ring_chunk_span(n, world, r) \
            == JR.chunk_span(n, world, r)


def test_mapped_axes_and_model_axes():
    assert set(R.mapped_axes(R.DEFAULT_RULES, "model")) == \
        {"heads", "mlp", "vocab"}
    assert R.mapped_axes(R.DEFAULT_RULES, "data") == ("batch",)
    assert set(R.mapped_axes(R.SERVING_RULES, "shard")) == {"heads", "mlp"}
    from tpu_dist.models import TransformerLM as JaxLM
    axes = R.model_axes(_port_lm(**TINY))
    assert axes == JR.model_axes(JaxLM(vocab_size=64, dim=32, depth=2,
                                       num_heads=4, max_seq_len=16))
    assert axes == {"qkv3": 3, "embed": 32, "heads": 4, "head_dim": 8,
                    "mlp": 128, "vocab": 64, "seq": 16}


def test_jax_params_inverts_load_jax_params():
    """The JAX-layout tree the rules slice comes out of ``interop`` and goes
    back in bit for bit."""
    model = _port_lm(**TINY)
    tree = interop.jax_params(model)
    assert tree["block0.attn"]["qkv_weight"].shape == (32, 96)
    assert tree["block0.mlp.0"]["weight"].shape == (32, 128)
    other = _port_lm(**dict(TINY))
    for p in other.parameters():
        torch.nn.init.zeros_(p)
    interop.load_jax_params(other, tree)
    for (k, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), k
