"""The port's capacity dispatches of ``MoELayer`` (``"einsum"``, the default,
and ``"gather"``) and the MoE ``TransformerLM`` that uses them, against the
JAX package.

Same numpy inputs and weights on both sides.  The layer cases run with a
``capacity_factor`` that makes drops occur (asserted) and with one that
gives a capacity of every token (none drop).  The model: the default
arguments (einsum) held to a single-device JAX step, and the world-2 DDP
step over gloo held to the JAX DDP over two virtual devices (its
``shard_map`` runs both capacity dispatches on the CPU; ROADMAP C2), where
each rank's capacity comes from its own tokens.

Tolerances: float32, the same terms summed in another order — layer outputs,
aux losses and gradients 1e-5 relative plus 1e-5 absolute; logits 1e-5;
parameters after SGD with momentum 1e-5 relative plus 2e-6 absolute, as in
``tests/test_torch_moe.py``."""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn import MoELayer as JaxMoE
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-5
LEAVES = ("router", "w1", "b1", "w2", "b2")
LB, LT, LD, LE, LH = 2, 12, 16, 5, 24     # batch, T, dim, experts, hidden
N = LB * LT
# (dispatch, top_k, normalize_gates, capacity_factor): 0.5 drops; 2.5 (top-2)
# and 5.0 (top-1) give C = N, so nothing drops
LAYER_CASES = {
    f"{d}_{name}": (d, k, norm, cf)
    for d in ("einsum", "gather")
    for name, (k, norm, cf) in {"top2_drop": (2, True, 0.5),
                                "top2_full": (2, True, 2.5),
                                "top1_drop": (1, True, 0.5),
                                "top1_full": (1, True, 5.0),
                                "top2_raw_drop": (2, False, 0.5)}.items()}

VOCAB, DIM, DEPTH, HEADS, T, BATCH, EXPERTS = 61, 32, 2, 2, 16, 8, 4
STEPS = 3
OPT = dict(lr=0.1, momentum=0.9)


def _tree(params):
    return {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}


def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((LB, LT, LD)).astype(np.float32)
    cot = rng.standard_normal((LB, LT, LD)).astype(np.float32)
    p = {"router": rng.standard_normal((LD, LE)) * 0.5,
         "w1": rng.standard_normal((LE, LD, LH)) * 0.3,
         "b1": rng.standard_normal((LE, LH)) * 0.1,
         "w2": rng.standard_normal((LE, LH, LD)) * 0.3,
         "b2": rng.standard_normal((LE, LD)) * 0.1}
    return x, cot, {k: v.astype(np.float32) for k, v in p.items()}


def _torch_layer(dispatch, top_k, normalize, cf, params):
    layer = tnn.MoELayer(LD, LE, hidden=LH, top_k=top_k,
                         normalize_gates=normalize, capacity_factor=cf,
                         dispatch=dispatch, device="cpu")
    load_jax_params(layer, {"": params})
    return layer


@pytest.fixture(scope="module")
def jax_layers():
    """Per case: the JAX layer's output, aux loss and the gradients of
    ``sum(y * cot) + aux`` in x and every parameter."""
    out = {}
    x, cot, p = _layer_inputs()
    for name, (dispatch, top_k, normalize, cf) in LAYER_CASES.items():
        layer = JaxMoE(LD, LE, hidden=LH, top_k=top_k,
                       normalize_gates=normalize, capacity_factor=cf,
                       dispatch=dispatch)
        state = layer.init_state()

        def objective(params, x):
            y, new_state = layer.apply(params, x, state=state, training=True)
            aux = new_state[""]["aux_loss"]
            return jnp.sum(y * cot) + aux, (y, aux)

        params = {"": {k: jnp.asarray(v) for k, v in p.items()}}
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        out[name] = (np.asarray(y), float(aux), np.asarray(gx),
                     {k: np.asarray(v) for k, v in gp[""].items()},
                     layer._capacity(N))
    return out


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_capacity_layer_matches_jax(jax_layers, case):
    dispatch, top_k, normalize, cf = LAYER_CASES[case]
    x, cot, p = _layer_inputs()
    y_j, aux_j, gx_j, gp_j, cap_j = jax_layers[case]
    layer = _torch_layer(dispatch, top_k, normalize, cf, p)
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
    r = layer.routing
    assert r["capacity"] == cap_j
    assert int(r["counts"].sum()) == top_k * N
    # the drop count is what the capacity leaves of each expert's arrivals
    want_dropped = int(np.maximum(r["counts"].numpy() - cap_j, 0).sum())
    assert int(r["dropped"]) == want_dropped
    if case.endswith("_drop"):
        assert want_dropped > 0
    else:
        assert cap_j == N and want_dropped == 0


@pytest.mark.parametrize("n_tokens,cf", [(24, 0.5), (24, 1.25), (24, 100.0),
                                         (7, 1.25), (1, 0.01), (600, 1.0)])
def test_capacity_formula_is_the_jax_one(n_tokens, cf):
    for k in (1, 2):
        ours = tnn.MoELayer(8, 4, top_k=k, capacity_factor=cf, device="cpu")
        theirs = JaxMoE(8, 4, top_k=k, capacity_factor=cf)
        assert ours._capacity(n_tokens) == theirs._capacity(n_tokens)


@pytest.mark.parametrize("top_k", [1, 2])
def test_einsum_and_gather_agree(top_k):
    """The two realizations of one routing: equal outputs and gradients
    but for the rounding of the combine."""
    x, cot, p = _layer_inputs(seed=1)
    got = {}
    for dispatch in ("einsum", "gather"):
        layer = _torch_layer(dispatch, top_k, True, 0.75, p)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = layer(xt)
        (y * torch.from_numpy(cot)).sum().backward()
        got[dispatch] = (y.detach(), xt.grad, layer.router.grad,
                         layer.w1.grad, layer.routing)
    e, g = got["einsum"], got["gather"]
    for a, b in zip(e[:4], g[:4]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for key in ("gate_idx", "counts", "dropped"):
        assert torch.equal(e[4][key], g[4][key]), key
    assert int(e[4]["dropped"]) > 0


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_ranks_are_integer_past_256_rows_under_bf16(dispatch):
    """600 tokens to one expert in bf16: the arrival ranks, and so the
    kept and dropped choices, are exact integers, the float32 layer's."""
    layer = tnn.MoELayer(8, 2, hidden=8, top_k=1, capacity_factor=1.0,
                         dispatch=dispatch, device="cpu")
    with torch.no_grad():
        layer.router.copy_(torch.tensor([[1.0, -1.0]] * 8))
    x = torch.rand(600, 8) + 0.1
    f32 = layer(x)
    r32 = layer.routing
    layer.to(torch.bfloat16)
    y = layer(x.to(torch.bfloat16)).detach()
    r = layer.routing
    assert r["capacity"] == 300 and int(r["dropped"]) == 300
    for k in ("gate_idx", "counts", "dropped"):
        assert torch.equal(r32[k], r[k]), k
    # choices past the capacity give zero rows; the kept ones do not
    assert not y[300:].any() and y[:300].abs().sum(-1).gt(0).all()
    assert not f32[300:].any()


def test_moe_layer_refuses_bad_arguments():
    with pytest.raises(ValueError, match="dispatch"):
        tnn.MoELayer(8, 4, dispatch="sparse", device="cpu")
    with pytest.raises(ValueError, match="num_experts"):
        tnn.MoELayer(8, 1, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tnn.MoELayer(8, 4, top_k=5, device="cpu")
    assert tnn.MoELayer(8, 4, device="cpu").dispatch == "einsum"


# ---------------------------------------------------------------------------
# the model: the default dispatch, single device
# ---------------------------------------------------------------------------

def _batch(rows=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (rows, T)).astype(np.int32)
    y = rng.integers(0, VOCAB, (rows, T)).astype(np.int32)
    return x, y


def _model_kw(**kw):
    return dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                max_seq_len=T, num_experts=EXPERTS, **kw)


@pytest.fixture(scope="module")
def jax_default_run():
    """``TransformerLM(num_experts=4)`` with default arguments (einsum,
    capacity factor 1.25): initial params, logits and aux losses, then each
    single-device step's loss, params and aux losses."""
    x, y = map(jnp.asarray, _batch())
    model = JaxLM(**_model_kw())
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

    params0 = _tree(params)
    opt_state = opt.init(params)
    steps, logits, aux0 = [], None, None
    for _ in range(STEPS):
        params, opt_state, loss, out, new_state = step(params, opt_state)
        if logits is None:
            logits, aux0 = np.asarray(out), _tree(new_state)
        steps.append((float(loss), _tree(params), _tree(new_state)))
    return params0, logits, aux0, steps


def test_default_model_logits_and_aux_match_jax(jax_default_run):
    params0, logits_j, aux_j, _ = jax_default_run
    model = load_jax_params(TorchLM(**_model_kw(), device="cpu"), params0)
    assert all(getattr(model, f"block{i}").mlp.dispatch == "einsum"
               for i in range(DEPTH))
    x, _ = _batch()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=1e-5,
                               atol=1e-5)
    for i in range(DEPTH):
        mlp = getattr(model, f"block{i}").mlp
        np.testing.assert_allclose(float(mlp.aux_loss),
                                   aux_j[f"block{i}.mlp"]["aux_loss"],
                                   rtol=RTOL)
        r = mlp.routing
        assert r["capacity"] == 80                  # ceil(2·128/4 · 1.25)
        assert int(r["dropped"]) == int(
            (r["counts"] - r["capacity"]).clamp_min(0).sum())


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_default_model_steps_match_jax(jax_default_run, n_steps):
    params0, _, _, steps = jax_default_run
    x, y = _batch()
    model = load_jax_params(TorchLM(**_model_kw(), device="cpu"), params0)
    ddp = TorchDDP(model, optimizer=toptim.SGD(**OPT),
                   loss_fn=tnn.CrossEntropyLoss(fused=True))
    state = ddp.init(seed=0)
    load_jax_params(model, params0)
    for _ in range(n_steps):
        state, m = ddp.train_step(state, torch.from_numpy(x),
                                  torch.from_numpy(y))
    loss_j, params_j, mstate_j = steps[n_steps - 1]
    np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-5)
    for path, leaves in state.model_state.items():
        np.testing.assert_allclose(float(leaves["aux_loss"]),
                                   mstate_j[path]["aux_loss"], rtol=RTOL,
                                   err_msg=path)
    want = dict(load_jax_params(TorchLM(**_model_kw(), device="cpu"),
                                params_j).named_parameters())
    for key, got in state.params.items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[key].detach().numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=key)


# ---------------------------------------------------------------------------
# world 2: the port's gloo ranks against the JAX DDP over two devices
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import load_jax_params
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import DistributedDataParallel

    rank, port, inp, out, kw = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4], json.loads(sys.argv[5]))
    torch.set_num_threads(1)
    d = dict(np.load(inp))
    res = {}
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank, device="cpu",
                                 timeout=120)
    for dispatch in ("gather", "einsum"):
        tree = {}
        for k, v in d.items():
            if k.startswith(dispatch + "|"):
                _, path, leaf = k.split("|")
                tree.setdefault(path, {})[leaf] = v
        model = TransformerLM(**kw, moe_dispatch=dispatch, device="cpu")
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=0.1, momentum=0.9),
            loss_fn=nn.CrossEntropyLoss(), group=pg)
        state = ddp.init(seed=0)
        load_jax_params(model, tree)
        rows = slice(rank * 4, (rank + 1) * 4)
        x = torch.from_numpy(d["x"][rows])
        y = torch.from_numpy(d["y"][rows]).long()
        for step in range(3):
            state, m = ddp.train_step(state, x, y)
            res[f"{dispatch}:{step}:loss"] = float(m["loss"])
        for path, v in state.model_state.items():
            res[f"{dispatch}:aux:{path}"] = float(v["aux_loss"])
        res[f"{dispatch}:dropped"] = sum(
            int(m.routing["dropped"]) for m in model.modules()
            if isinstance(m, nn.MoELayer))
        for k, v in state.params.items():
            res[f"{dispatch}:p:{k}"] = v.detach().numpy().copy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Three steps of each capacity dispatch on two gloo ranks (4 rows a
    rank), and the JAX DDP's over two virtual devices."""
    import json
    tmp = tmp_path_factory.mktemp("moe_w2")
    x, y = _batch(rows=8, seed=3)
    feed = {"x": x, "y": y}
    want = {}
    for dispatch in ("gather", "einsum"):
        model = JaxLM(**_model_kw(moe_dispatch=dispatch))
        ddp = JaxDDP(model, optimizer=joptim.SGD(**OPT),
                     loss_fn=jnn.CrossEntropyLoss(),
                     group=JaxGroup(jax.devices()[:2]), donate=False)
        state = ddp.init(seed=0)
        feed.update({f"{dispatch}|{p}|{k}": v
                     for p, lv in _tree(state.params).items()
                     for k, v in lv.items()})
        losses = []
        for _ in range(STEPS):
            state, m = ddp.train_step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(m["loss"]))
        want[dispatch] = (losses, _tree(state.params),
                          _tree(state.model_state))
    np.savez(tmp / "in.npz", **feed)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port),
         str(tmp / "in.npz"), str(tmp / f"r{r}.npz"),
         json.dumps(_model_kw())],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err
    return want, [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_world2_ddp_steps_match_jax_ddp(world2, dispatch):
    want, ranks = world2
    losses, params_j, mstate_j = want[dispatch]
    scratch = load_jax_params(
        TorchLM(**_model_kw(moe_dispatch=dispatch), device="cpu"), params_j)
    expected = dict(scratch.named_parameters())
    for res in ranks:
        assert res[f"{dispatch}:dropped"] > 0   # each rank's own capacity
        for step, loss in enumerate(losses):
            np.testing.assert_allclose(res[f"{dispatch}:{step}:loss"], loss,
                                       rtol=1e-5)
        for path, leaves in mstate_j.items():
            np.testing.assert_allclose(res[f"{dispatch}:aux:{path}"],
                                       leaves["aux_loss"], rtol=RTOL,
                                       err_msg=path)
        for k, v in expected.items():
            np.testing.assert_allclose(res[f"{dispatch}:p:{k}"],
                                       v.detach().numpy(), rtol=1e-5,
                                       atol=2e-6, err_msg=k)
