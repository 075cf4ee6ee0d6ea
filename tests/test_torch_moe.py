"""The port's dropless MoE (``tpu_dist_torch.nn.MoELayer``, the MoE
``TransformerLM`` and its DDP step) against the JAX package.

Same numpy inputs and weights on both sides; the JAX grouped matmuls run in
interpret mode on the CPU, the port's wrappers take their plain versions.
The JAX DDP cannot run the dropless layer under ``shard_map`` in interpret
mode (ROADMAP C2), so the model-level reference is the single-device step
it equals at world 1: ``jax.value_and_grad`` over ``model.apply(params, x,
state=model.init_state(), training=True)``, then ``tpu_dist.optim.SGD``.

Tolerances: float32, the same terms summed in another order — layer outputs,
aux losses and gradients 1e-5 relative plus 1e-5 absolute; logits and losses
1e-5 relative; parameters after SGD with momentum 1e-5 relative plus 2e-6
absolute (lr × the gradient differences, compounded over the steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn import MoELayer as JaxMoE
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

RTOL, ATOL = 1e-5, 1e-5
LEAVES = ("router", "w1", "b1", "w2", "b2")

# layer cases: (top_k, normalize_gates, routing); "one" sends every token's
# first choice to expert 0 (top-2: the second choice is a four-way tie)
LAYER_CASES = {"top1": (1, True, "random"), "top2": (2, True, "random"),
               "top2_raw": (2, False, "random"), "top1_one": (1, True, "one"),
               "top2_one": (2, True, "one")}
LB, LT, LD, LE, LH = 2, 12, 16, 5, 24     # batch, T, dim, experts, hidden

VOCAB, DIM, DEPTH, HEADS, T, BATCH, EXPERTS = 61, 32, 2, 2, 16, 8, 4
STEPS = 3
OPT = dict(lr=0.1, momentum=0.9)


def _layer_inputs(routing, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((LB, LT, LD)).astype(np.float32)
    cot = rng.standard_normal((LB, LT, LD)).astype(np.float32)
    p = {"router": rng.standard_normal((LD, LE)) * 0.5,
         "w1": rng.standard_normal((LE, LD, LH)) * 0.3,
         "b1": rng.standard_normal((LE, LH)) * 0.1,
         "w2": rng.standard_normal((LE, LH, LD)) * 0.3,
         "b2": rng.standard_normal((LE, LD)) * 0.1}
    if routing == "one":
        x = np.abs(x)                       # router column 0 wins everywhere
        p["router"] = np.where(np.arange(LE) == 0, 1.0, -1.0) * np.ones(
            (LD, LE))
    return x, cot, {k: v.astype(np.float32) for k, v in p.items()}


def _torch_layer(top_k, normalize, params):
    layer = tnn.MoELayer(LD, LE, hidden=LH, top_k=top_k,
                         normalize_gates=normalize, dispatch="dropless",
                         device="cpu")
    with torch.no_grad():
        for k in LEAVES:
            getattr(layer, k).copy_(torch.from_numpy(params[k]))
    return layer


@pytest.fixture(scope="module")
def jax_layers():
    """Per case: the JAX layer's output, aux loss and the gradients of
    ``sum(y * cot) + aux`` in x and every parameter."""
    out = {}
    for name, (top_k, normalize, routing) in LAYER_CASES.items():
        x, cot, p = _layer_inputs(routing)
        layer = JaxMoE(LD, LE, hidden=LH, top_k=top_k,
                       normalize_gates=normalize, dispatch="dropless")
        state = layer.init_state()

        def objective(params, x):
            y, new_state = layer.apply(params, x, state=state, training=True)
            aux = new_state[""]["aux_loss"]
            return jnp.sum(y * cot) + aux, (y, aux)

        params = {"": {k: jnp.asarray(v) for k, v in p.items()}}
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        out[name] = (np.asarray(y), float(aux), np.asarray(gx),
                     {k: np.asarray(v) for k, v in gp[""].items()})
    return out


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(jax_layers, case):
    top_k, normalize, routing = LAYER_CASES[case]
    x, cot, p = _layer_inputs(routing)
    y_j, aux_j, gx_j, gp_j = jax_layers[case]
    layer = _torch_layer(top_k, normalize, p)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    ((y * torch.from_numpy(cot)).sum() + layer.aux_loss).backward()
    np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(layer.aux_loss.detach()), aux_j,
                               rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=RTOL, atol=ATOL)
    for k in LEAVES:
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(), gp_j[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    counts = layer.routing["counts"]
    assert int(counts.sum()) == top_k * LB * LT          # nothing dropped
    if routing == "one":
        assert int(counts[0]) == LB * LT
        if top_k == 1:                  # every other expert is absent
            for k in ("w1", "b1", "w2", "b2"):
                assert not getattr(layer, k).grad[1:].any(), k
        else:                           # the tie goes to the lower index
            assert int(counts[1]) == LB * LT


def test_routing_is_integer_past_256_rows_under_bf16():
    """600 tokens to one expert in bf16: the counts, the live blocks and the
    block map are exact integers, the same as the float32 layer's."""
    layer = tnn.MoELayer(8, 2, hidden=8, top_k=1, dispatch="dropless",
                         device="cpu").to(torch.bfloat16)
    with torch.no_grad():
        layer.router.copy_(torch.tensor([[1.0, -1.0]] * 8))
    x = torch.rand(600, 8).to(torch.bfloat16) + 0.1
    y = layer(x)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    r = layer.routing
    assert r["counts"].tolist() == [600, 0]
    b = 8 * -(-600 // 2 // 8)                          # ceil_to(kN / E, 8)
    assert int(r["n_live_blocks"]) == -(-600 // b)
    # the float32 layer on the same (rounded) inputs routes identically
    f32 = tnn.MoELayer(8, 2, hidden=8, top_k=1, dispatch="dropless",
                       device="cpu")
    f32.load_state_dict({k: v.float() for k, v in layer.state_dict().items()})
    f32(x.float())
    for k in ("counts", "block_groups", "n_live_blocks"):
        assert torch.equal(f32.routing[k], r[k]), k


def test_moe_layer_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="dispatch"):
        tnn.MoELayer(8, 4, dispatch="sparse", device="cpu")
    with pytest.raises(ValueError, match="num_experts"):
        tnn.MoELayer(8, 1, dispatch="dropless", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tnn.MoELayer(8, 4, top_k=5, dispatch="dropless", device="cpu")
    # K3's in-kernel activation (B2) is ported, though the layer passes none
    # (its GELU stays outside, as in the JAX package): on the CPU it applies
    # to the plain product
    import importlib
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")
    out = gm.gmm(torch.ones(8, 4), torch.full((2, 4, 4), 0.25),
                 torch.zeros(1, dtype=torch.int32), 1, block_rows=8,
                 activation=torch.tanh)
    torch.testing.assert_close(out, torch.tanh(torch.ones(8, 4)))
    # the JAX package's default dispatch, "einsum", is the port's default
    model = TorchLM(vocab_size=11, dim=8, depth=1, num_heads=2,
                    num_experts=4, device="cpu")
    assert model.block0.mlp.dispatch == "einsum"


def test_moe_init_distributions():
    """The JAX package's bounds: router kaiming_uniform over fan_in = dim,
    experts U(±sqrt(6 / fan_in)) per expert, zero biases."""
    layer = tnn.MoELayer(64, 4, hidden=256, dispatch="dropless",
                         device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    for name, bound in (("router", (6 / 64) ** 0.5), ("w1", (6 / 64) ** 0.5),
                        ("w2", (6 / 256) ** 0.5)):
        w = getattr(layer, name).detach()
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.95 * bound, name
    assert not layer.b1.any() and not layer.b2.any()


def test_moe_every_picks_the_jax_blocks():
    model = TorchLM(vocab_size=11, dim=8, depth=4, num_heads=2,
                    num_experts=4, moe_every=2, moe_dispatch="dropless",
                    device="cpu")
    kinds = [type(getattr(model, f"block{i}").mlp).__name__
             for i in range(4)]
    assert kinds == ["Sequential", "MoELayer", "Sequential", "MoELayer"]
    assert "block1.mlp.w1" in dict(model.named_parameters())
    with pytest.raises(ValueError, match="moe_every"):
        TorchLM(vocab_size=11, dim=8, depth=2, num_heads=2, num_experts=4,
                moe_every=0, moe_dispatch="dropless", device="cpu")


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    return {path: {k: np.array(a) for k, a in leaves.items()}
            for path, leaves in tree.items()}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32)
    y = rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32)
    return x, y


def _torch_model(params):
    model = TorchLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                    max_seq_len=T, num_experts=EXPERTS,
                    moe_dispatch="dropless", device="cpu")
    return load_jax_params(model, params)


@pytest.fixture(scope="module")
def jax_run():
    """Initial params, logits and aux losses, then each single-device
    step's loss, params and aux losses, from the JAX package."""
    x, y = map(jnp.asarray, _batch())
    model = JaxLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                  max_seq_len=T, num_experts=EXPERTS,
                  moe_dispatch="dropless")
    params = model.init(jax.random.key(0))
    state0 = model.init_state()
    loss_fn = jnn.CrossEntropyLoss()
    opt = joptim.SGD(**OPT)

    def objective(p):
        out, new_state = model.apply(p, x, state=state0, training=True)
        return loss_fn(out, y), (out, new_state)

    @jax.jit
    def step(p, opt_state):
        (loss, (out, new_state)), g = jax.value_and_grad(
            objective, has_aux=True)(p)
        p, opt_state = opt.update(g, opt_state, p)
        return p, opt_state, loss, out, new_state

    params0 = _numpy_tree(params)
    opt_state = opt.init(params)
    steps, logits, aux0 = [], None, None
    for _ in range(STEPS):
        params, opt_state, loss, out, new_state = step(params, opt_state)
        if logits is None:
            logits, aux0 = np.asarray(out), _numpy_tree(new_state)
        steps.append((float(loss), _numpy_tree(params),
                      _numpy_tree(new_state)))
    return params0, logits, aux0, steps


def test_load_jax_params_maps_moe_leaves(jax_run):
    params0 = jax_run[0]
    model = _torch_model(params0)
    ours = {k: p.detach().numpy() for k, p in model.named_parameters()}
    for leaf in LEAVES:  # the JAX layout, no transpose
        np.testing.assert_array_equal(ours[f"block1.mlp.{leaf}"],
                                      params0["block1.mlp"][leaf])
    with_state = {p: dict(leaves) for p, leaves in params0.items()}
    with_state["block0.mlp"]["aux_loss"] = np.zeros((), np.float32)
    _torch_model(with_state)                 # module state is skipped
    broken = {p: dict(leaves) for p, leaves in params0.items()}
    del broken["block0.mlp"]["w2"]
    with pytest.raises(KeyError, match="block0.mlp.w2"):
        _torch_model(broken)
    broken = {p: dict(leaves) for p, leaves in params0.items()}
    broken["block0.mlp"]["gate_bias"] = np.zeros(EXPERTS, np.float32)
    with pytest.raises(KeyError, match="block0.mlp.gate_bias"):
        _torch_model(broken)
    broken = {p: dict(leaves) for p, leaves in params0.items()}
    broken["block1.mlp"]["w1"] = np.swapaxes(params0["block1.mlp"]["w1"],
                                             1, 2)
    with pytest.raises(ValueError, match="block1.mlp.w1"):
        _torch_model(broken)


def test_logits_and_aux_match_jax(jax_run):
    params0, logits_j, aux_j, _ = jax_run
    x, _ = _batch()
    model = _torch_model(params0)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=1e-5,
                               atol=1e-5)
    for i in range(DEPTH):
        np.testing.assert_allclose(
            float(getattr(model, f"block{i}").mlp.aux_loss.detach()),
            aux_j[f"block{i}.mlp"]["aux_loss"], rtol=RTOL)


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_ddp_train_steps_match_jax(jax_run, n_steps):
    params0, _, _, steps = jax_run
    x, y = _batch()
    model = _torch_model(params0)
    ddp = TorchDDP(model, optimizer=toptim.SGD(**OPT),
                   loss_fn=tnn.CrossEntropyLoss(fused=True))
    state = ddp.init(seed=0)
    assert set(state.model_state) == {"block0.mlp", "block1.mlp"}
    load_jax_params(model, params0)  # the state holds the module's tensors
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(n_steps):
        state, m = ddp.train_step(state, xt, yt)
    loss_j, params_j, mstate_j = steps[n_steps - 1]
    np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-5)
    for path, leaves in state.model_state.items():
        assert leaves["aux_loss"].dtype == torch.float32
        np.testing.assert_allclose(float(leaves["aux_loss"]),
                                   mstate_j[path]["aux_loss"], rtol=RTOL,
                                   err_msg=path)
    want = dict(_torch_model(params_j).named_parameters())
    for key, got in state.params.items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[key].detach().numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=key)


def test_dense_model_state_stays_empty():
    model = TorchLM(vocab_size=11, dim=8, depth=1, num_heads=2,
                    max_seq_len=4, device="cpu")
    ddp = TorchDDP(model, optimizer=toptim.SGD(lr=0.1),
                   loss_fn=tnn.CrossEntropyLoss())
    state = ddp.init(seed=0)
    x = torch.zeros(2, 4, dtype=torch.long)
    state, _ = ddp.train_step(state, x, x)
    assert state.model_state == {}


def test_moe_entry_points_raise_without_cuda(monkeypatch):
    """With no device argument and no CUDA device, the MoE entry points
    raise instead of running on the CPU."""
    from tpu_dist_torch.benchmarks import moe_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe_lm.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.MoELayer(8, 4, dispatch="dropless")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe_lm.build(batch=1, seq_len=4, dim=8, depth=1, heads=2, vocab=11)
    with pytest.raises(RuntimeError, match="CUDA events"):
        moe_lm.run(device="cpu")


def test_moe_benchmark_builds_and_steps_on_cpu():
    """The benchmark's model, batch and DDP step at a tiny size: the MoE
    blocks, the parameter accounting and the aux losses in model_state."""
    from tpu_dist_torch.benchmarks import moe_lm

    ddp, x, y = moe_lm.build(batch=2, seq_len=8, dim=16, depth=2, heads=2,
                             vocab=31, experts=4, dispatch="dropless",
                             device="cpu")
    state = ddp.init(seed=0)
    state, m = ddp.train_step(state, x, y)
    assert np.isfinite(float(m["loss"]))
    assert set(state.model_state) == {"block0.mlp", "block1.mlp"}
    n = sum(p.numel() for p in state.params.values())
    # each token skips 2 of 4 experts' w1 and w2 in each of the 2 blocks
    assert moe_lm.active_params(n, 16, 2, 4) == n - 2 * 2 * 2 * 16 * 64
