"""The port's expert-parallel slice against the JAX package's.

- ``MoELayer`` under a ``("data", "expert")`` mesh of gloo ranks, at
  ``data 1 × expert 2`` (world 2) and ``data 2 × expert 2`` (world 4),
  against the JAX ``MoELayer`` on the global batch: forward, input gradient
  and every parameter gradient, both capacity dispatches, top-1 and top-2,
  capacity factor 1.25 and 1e9, and a routing skewed so that tokens of data
  shard 1 drop because shard 0 filled their expert (``dropped`` > 0 and the
  JAX routing's count).  Each rank's objective is ``dp · Σ(y · cot)`` over
  its rows plus the aux loss (a mean loss over its rows, as the step's
  is), so its input gradient is dp times the global one's rows, and its
  parameter gradients averaged as the step averages them (the router over
  the world, a bank over its data line) are the global ones.  1e-5
  relative plus 1e-5 absolute, float32 (``test_torch_moe_dispatch.py``'s).
- The bare layer (no name the rules match) through
  ``make_gspmd_train_step`` at both meshes, two steps, against the JAX
  layer through the JAX package's step: losses, aux loss and every rank's
  parameters, the same tolerances.
- ``train_lm --parallel ep --device cpu`` at world 4 (data 2 × expert 2):
  three steps equal the JAX example's ep step (examples/train_lm.py:
  255-292) over four virtual devices from the same initial parameters, in
  loss (1e-5 relative), parameters (1e-5 relative + 2e-6 absolute, the sp
  slice's) and the aux losses in the model state (1e-5 relative).
- ``partition_pairs``, ``spec_for_key``, ``MOE_EP_RULES.tree_specs`` and
  ``TRANSFORMER_TP_RULES.tree_specs`` equal the JAX package's
  (``tuple(PartitionSpec)``); ``shard_pytree`` and ``load_jax_params`` give
  each rank its expert slice, and ``jax_params`` gathers the banks back.
- The refusals: ``dispatch="dropless"`` and an expert count the axis does
  not divide raise ``ExpertAxisError``; the step trains a ``model`` axis,
  and a BatchNorm model at data 1 as the plain step does.

One module-scoped launch a world size (the port's launcher, gloo ranks)
runs every port case."""

import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn import MoELayer as JaxMoE
from tpu_dist.parallel import gspmd as jgspmd
from tpu_dist.parallel import rules as jrules
from tpu_dist_torch import dist as tdist
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.examples import train_lm
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import gspmd, rules

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-5
LEAVES = ("router", "w1", "b1", "w2", "b2")
BANKS = ("w1", "b1", "w2", "b2")
LB, LT, LD, LE, LH = 4, 8, 16, 4, 24      # global batch, T, dim, E, hidden
MESHES = {2: (1, 2), 4: (2, 2)}           # world: (data, expert)
# name: (dispatch, top_k, capacity_factor, inputs)
LAYER_CASES = {
    f"{d}_top{k}_{name}": (d, k, cf, inputs)
    for d in ("einsum", "gather") for k in (1, 2)
    for name, (cf, inputs) in {"cap": (1.25, "random"),
                               "full": (1e9, "random"),
                               "skew": (1.25, "skew")}.items()}
TRAIN = dict(vocab=32, dim=32, depth=2, heads=4, seq_len=16, batch=4,
             steps=3, lr=0.5, experts=4)
TRAIN_ARGV = ["--parallel", "ep", "--device", "cpu",
              "--steps", str(TRAIN["steps"]), "--seq-len",
              str(TRAIN["seq_len"]), "--batch-size", str(TRAIN["batch"]),
              "--dim", str(TRAIN["dim"]), "--depth", str(TRAIN["depth"]),
              "--heads", str(TRAIN["heads"]), "--vocab", str(TRAIN["vocab"]),
              "--lr", str(TRAIN["lr"]), "--experts", str(TRAIN["experts"]),
              "--log-every", "1"]
TINY_LM = dict(vocab_size=16, dim=16, depth=2, num_heads=2, max_seq_len=8,
               num_experts=4)
# the bare layer through the step: top-2, capacity 1.25, the random inputs
# with labels over the LD output features, SGD
STEP = dict(lr=0.5, steps=2)

WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn
    from tpu_dist_torch.interop import jax_params, load_jax_params

    inp, out = sys.argv[1], sys.argv[2]
    cases, mesh, train_argv, step_cfg = json.loads(sys.argv[3])
    torch.set_num_threads(1)
    d = dict(np.load(inp))
    res = {}

    def tree(prefix):
        t = {}
        for k, v in d.items():
            if k.startswith(prefix + "|"):
                _, path, leaf = k.split("|")
                t.setdefault(path, {})[leaf] = v
        return t

    pg = dist.init_process_group(
        init_method="env://", device="cpu", timeout=120,
        axis_names=("data", "expert"), mesh_shape=mesh)
    rank = pg.rank
    dp = pg.axis_group("data").size
    di = pg.axis_group("data").index
    res["coords"] = np.array([di, pg.axis_group("expert").index])
    for name, (dispatch, k, cf, inputs) in cases.items():
        layer = nn.MoELayer(d[inputs + "|x"].shape[-1], 4, hidden=24,
                            top_k=k, capacity_factor=cf, dispatch=dispatch,
                            device="cpu", expert_axis="expert")
        e0, el = layer.first_expert, layer.local_experts
        with torch.no_grad():
            for leaf in ("router", "w1", "b1", "w2", "b2"):
                full = torch.from_numpy(d[inputs + "|" + leaf])
                getattr(layer, leaf).copy_(
                    full if leaf == "router" else full[e0:e0 + el])
        rows = slice(di * (d[inputs + "|x"].shape[0] // dp),
                     (di + 1) * (d[inputs + "|x"].shape[0] // dp))
        x = torch.from_numpy(d[inputs + "|x"][rows]).requires_grad_(True)
        cot = torch.from_numpy(d[inputs + "|cot"][rows])
        y = layer(x)
        obj = dp * (y * cot).sum() + layer.aux_loss
        grads = torch.autograd.grad(
            obj, [x] + [getattr(layer, n) for n in
                        ("router", "w1", "b1", "w2", "b2")])
        res[f"{name}:y"] = y.detach().numpy()
        res[f"{name}:aux"] = layer.aux_loss.detach().numpy()
        res[f"{name}:dropped"] = layer.routing["dropped"].numpy()
        res[f"{name}:capacity"] = np.array(layer.routing["capacity"])
        for n, g in zip(("x", "router", "w1", "b1", "w2", "b2"), grads):
            res[f"{name}:g:{n}"] = g.numpy()

    # a bare layer (no model path the JAX rules name) through the step:
    # its banks' gradients averaged over its data line because the layer
    # holds a slice of its experts
    from tpu_dist_torch import optim
    from tpu_dist_torch.parallel import make_gspmd_train_step
    for dispatch in ("einsum", "gather"):
        layer = nn.MoELayer(d["random|x"].shape[-1], 4, hidden=24,
                            dispatch=dispatch, device="cpu",
                            expert_axis="expert")
        e0, el = layer.first_expert, layer.local_experts
        with torch.no_grad():
            for leaf in ("router", "w1", "b1", "w2", "b2"):
                full = torch.from_numpy(d["random|" + leaf])
                getattr(layer, leaf).copy_(
                    full if leaf == "router" else full[e0:e0 + el])
        ce = nn.CrossEntropyLoss()
        opt = optim.SGD(lr=step_cfg["lr"])
        step = make_gspmd_train_step(
            layer, lambda o, t: ce(o.reshape(-1, o.shape[-1]),
                                   t.reshape(-1)), opt,
            aux_loss_coeff=0.01)
        params = dict(layer.named_parameters())
        opt_state, mstate = opt.init(params), {}
        n = d["random|x"].shape[0] // dp
        x = torch.from_numpy(d["random|x"][di * n:(di + 1) * n])
        t = torch.from_numpy(d["step|labels"][di * n:(di + 1) * n])
        losses = []
        for _ in range(step_cfg["steps"]):
            params, opt_state, mstate, m = step(params, opt_state, mstate,
                                                x, t)
            losses.append(float(m["loss"]))
        res[f"step:{dispatch}:losses"] = np.array(losses)
        res[f"step:{dispatch}:aux"] = mstate[""]["aux_loss"].numpy()
        for leaf, v in params.items():
            res[f"step:{dispatch}:p:{leaf}"] = v.detach().numpy()

    # the refusals under an expert axis of 2
    for kw in ({"dispatch": "dropless"}, {"num_experts": 3}):
        args = {"dim": 8, "num_experts": 4, "device": "cpu",
                "expert_axis": "expert", **kw}
        try:
            nn.MoELayer(**args)
        except nn.ExpertAxisError as e:
            res["refused:" + next(iter(kw))] = np.array(str(e))

    # shard_pytree, load_jax_params and jax_params on a tiny MoE model
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import MOE_EP_RULES, shard_pytree
    full = tree("tiny")
    for path, leaves in shard_pytree(full, pg, MOE_EP_RULES).items():
        for leaf, v in leaves.items():
            res[f"slice|{path}|{leaf}"] = v
    model = TransformerLM(**json.loads(sys.argv[4]), device="cpu",
                          expert_axis="expert")
    load_jax_params(model, full)
    for k, v in model.named_parameters():
        res[f"local|{k}"] = v.detach().numpy()
    for path, leaves in jax_params(model).items():
        for leaf, v in leaves.items():
            res[f"back|{path}|{leaf}"] = v
    dist.destroy_process_group()

    if train_argv:
        from tpu_dist_torch.examples import train_lm
        start = tree("train")
        r = train_lm.train(train_lm.parse_args(train_argv),
                           init_params=lambda m: load_jax_params(m, start))
        res["train:losses"] = np.array(r["losses"])
        res["train:shape"] = np.array([r["batch"], r["seq_len"]])
        for k, v in r["state"]["params"].items():
            res[f"train:p:{k}"] = v.detach().numpy()
        for k, v in r["state"]["mstate"].items():
            res[f"train:aux:{k}"] = v["aux_loss"].numpy()
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
""")


def _flat(prefix, tree):
    return {f"{prefix}|{p}|{k}": np.asarray(v) for p, lv in tree.items()
            for k, v in lv.items()}


def _spawn(world, tmp, feed, extra):
    """The worker on ``world`` gloo ranks under the port's launcher (its
    store publishes the rendezvous port rank 0 binds); each rank's
    results."""
    np.savez(tmp / "in.npz", **feed)
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         f"--nproc_per_node={world}", str(tmp / "worker.py"),
         str(tmp / "in.npz"), str(tmp), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------

def _random_inputs():
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((LD, LE)),
         "w1": rng.standard_normal((LE, LD, LH)) * 0.3,
         "b1": rng.standard_normal((LE, LH)) * 0.1,
         "w2": rng.standard_normal((LE, LH, LD)) * 0.3,
         "b2": rng.standard_normal((LE, LD)) * 0.1,
         "x": rng.standard_normal((LB, LT, LD)),
         "cot": rng.standard_normal((LB, LT, LD))}
    return {k: v.astype(np.float32) for k, v in p.items()}


# first choices of the skewed routing: data shard 0 (rows 0-1) sends 12 of
# its 16 tokens to expert 0, shard 1 (rows 2-3) 4 of its 16, so alone each
# shard fits a capacity of 5 an expert, while globally expert 0 gets 16
# against a capacity of 10 and every token of shard 1 routed there drops
SKEW_TARGETS = np.array([0] * 12 + [1, 1, 2, 3] + [0] * 4 + [1, 2, 3] * 4)


def _skew_inputs():
    rng = np.random.default_rng(1)
    p = _random_inputs()
    # a token's first choice is its target (logit 6); a constant feature
    # makes expert 1 every other token's second choice (logit 1.5)
    x = 0.05 * rng.standard_normal((LB * LT, LD))
    x[np.arange(LB * LT), SKEW_TARGETS] += 3.0
    x[:, -1] = 1.0
    router = 0.05 * rng.standard_normal((LD, LE))
    router[np.arange(LE), np.arange(LE)] = 2.0
    router[-1] = [0.0, 1.5, 0.0, 0.0]
    p.update(x=x.reshape(LB, LT, LD), router=router)
    return {k: v.astype(np.float32) for k, v in p.items()}


INPUTS = {"random": _random_inputs, "skew": _skew_inputs}


def _jax_layer(dispatch, k, cf, p, x=None):
    """The JAX layer on the global batch: y, aux, the gradients of
    ``sum(y * cot) + aux`` in x and every parameter, and the dropped
    count of its routing (each expert keeps its first C choices)."""
    layer = JaxMoE(LD, LE, hidden=LH, top_k=k, capacity_factor=cf,
                   dispatch=dispatch)
    state = layer.init_state()
    x = p["x"] if x is None else x
    cot = p["cot"][:x.shape[0]]

    def objective(params, x):
        y, new_state = layer.apply(params, x, state=state, training=True)
        aux = new_state[""]["aux_loss"]
        return jnp.sum(y * cot) + aux, (y, aux)

    params = {"": {n: jnp.asarray(p[n]) for n in LEAVES}}
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = jnp.asarray(x).reshape(-1, LD)
    probs = jax.nn.softmax(xt @ params[""]["router"], axis=-1)
    _, idx = lax.top_k(probs, k)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=LE)
    cap = layer._capacity(xt.shape[0])
    return {"y": np.asarray(y), "aux": float(aux), "g:x": np.asarray(gx),
            **{f"g:{n}": np.asarray(v) for n, v in gp[""].items()},
            "dropped": int(np.maximum(counts - cap, 0).sum()),
            "capacity": cap}


def _tiny_jax_params():
    return jax.tree.map(np.asarray, JaxLM(**TINY_LM).init(jax.random.key(3)))


def _labels():
    return np.random.default_rng(2).integers(0, LD, (LB, LT))


def _feed():
    feed = {f"{name}|{k}": v for name, make in INPUTS.items()
            for k, v in make().items()}
    feed["step|labels"] = _labels()
    feed.update(_flat("tiny", _tiny_jax_params()))
    return feed


def _jax_ep_train():
    """The JAX example's ``--parallel ep`` loop (examples/train_lm.py:
    255-292) over a (2, 2) mesh of four virtual devices: initial params,
    each step's loss, final params and model state."""
    v, sl, bs = TRAIN["vocab"], TRAIN["seq_len"], TRAIN["batch"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "expert"))
    rng = np.random.default_rng(0)
    perm = rng.permutation(v)
    model = JaxLM(v, dim=TRAIN["dim"], depth=TRAIN["depth"],
                  num_heads=TRAIN["heads"], max_seq_len=sl,
                  num_experts=TRAIN["experts"])
    ce = jnn.CrossEntropyLoss()
    opt = joptim.SGD(lr=TRAIN["lr"])
    params0 = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    params = jgspmd.shard_pytree(jax.tree.map(jnp.asarray, params0), mesh,
                                 jgspmd.MOE_EP_RULES)
    mstate = jgspmd.shard_pytree(model.init_state(), mesh)
    opt_state = opt.init(params)
    step = jgspmd.make_gspmd_train_step(
        model, lambda lg, y: ce(lg.reshape(-1, v), y.reshape(-1)), opt,
        aux_loss_coeff=0.01)
    bsh = NamedSharding(mesh, P("data", None))
    losses = []
    for _ in range(TRAIN["steps"]):
        x = rng.integers(0, v, (bs, sl))
        params, opt_state, mstate, m = step(
            params, opt_state, mstate, jax.device_put(x, bsh),
            jax.device_put(perm[x], bsh))
        losses.append(float(m["loss"]))
    return (params0, losses, jax.tree.map(np.asarray, params),
            {p: float(s["aux_loss"]) for p, s in mstate.items()})


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The layer cases at data 1 × expert 2 on two gloo ranks."""
    ranks = _spawn(2, tmp_path_factory.mktemp("ep2"), _feed(),
                   [json.dumps([LAYER_CASES, MESHES[2], [], STEP]),
                    json.dumps(TINY_LM)])
    return ranks


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The layer cases at data 2 × expert 2, and three ``train_lm
    --parallel ep`` steps, on four gloo ranks; the JAX run's."""
    want = _jax_ep_train()
    feed = {**_feed(), **_flat("train", want[0])}
    ranks = _spawn(4, tmp_path_factory.mktemp("ep4"), feed,
                   [json.dumps([LAYER_CASES, MESHES[4], TRAIN_ARGV, STEP]),
                    json.dumps(TINY_LM)])
    return want, ranks


def _ranks(world, world2, world4):
    return world2 if world == 2 else world4[1]


# ---------------------------------------------------------------------------
# (a) the layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """The JAX layer's results for ``case`` (both meshes hold the same
    global batch to it)."""
    dispatch, k, cf, inputs = LAYER_CASES[case]
    return _jax_layer(dispatch, k, cf, INPUTS[inputs]())


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("world", sorted(MESHES))
def test_layer_matches_jax_on_the_global_batch(world, case, world2, world4):
    dispatch, k, cf, inputs = LAYER_CASES[case]
    want = _jax_case(case)
    ranks = _ranks(world, world2, world4)
    dp, ep = MESHES[world]
    per = LB // dp
    banks = {n: np.zeros_like(want[f"g:{n}"]) for n in BANKS}
    router = np.zeros_like(want["g:router"])
    for r in ranks:
        di, ei = (int(c) for c in r["coords"])
        rows = slice(di * per, (di + 1) * per)
        np.testing.assert_allclose(r[f"{case}:y"], want["y"][rows],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r[f"{case}:g:x"],
                                   dp * want["g:x"][rows],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(r[f"{case}:aux"]), want["aux"],
                                   rtol=RTOL)
        assert int(r[f"{case}:dropped"]) == want["dropped"]
        assert int(r[f"{case}:capacity"]) == want["capacity"]
        # the step's averages: the router over the world, a bank over its
        # data line
        router += r[f"{case}:g:router"] / world
        el = LE // ep
        for n in BANKS:
            banks[n][ei * el:(ei + 1) * el] += r[f"{case}:g:{n}"] / dp
    np.testing.assert_allclose(router, want["g:router"], rtol=RTOL,
                               atol=ATOL)
    for n in BANKS:
        np.testing.assert_allclose(banks[n], want[f"g:{n}"], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    if inputs == "skew":
        assert want["dropped"] > 0
    if cf == 1e9:
        assert want["dropped"] == 0


def test_skewed_drops_come_from_the_other_shard(world4):
    """Top-1 on the skewed routing: routed alone, data shard 1 drops
    nothing; in the global batch its four tokens of expert 0 drop (output
    0) because shard 0's twelve filled the capacity of 10 first."""
    _, ranks = world4
    p = _skew_inputs()
    shard1 = p["x"][LB // 2:]
    alone = _jax_layer("gather", 1, 1.25, p, x=shard1)
    assert alone["dropped"] == 0
    for case in ("einsum_top1_skew", "gather_top1_skew"):
        for r in ranks:
            if int(r["coords"][0]) != 1:
                continue
            y = r[f"{case}:y"].reshape(-1, LD)
            zero = np.flatnonzero(np.abs(y).max(-1) == 0)
            assert (SKEW_TARGETS[LB * LT // 2:][zero] == 0).all()
            assert len(zero) == 4
            assert int(r[f"{case}:dropped"]) == 6


@functools.lru_cache(maxsize=None)
def _jax_bare_step(dispatch):
    """The JAX layer alone through the JAX package's GSPMD step on one
    device (the global step): initial params, each step's loss, final
    params and aux loss."""
    p = _random_inputs()
    layer = JaxMoE(LD, LE, hidden=LH, dispatch=dispatch)
    ce = jnn.CrossEntropyLoss()
    opt = joptim.SGD(lr=STEP["lr"])
    step = jgspmd.make_gspmd_train_step(
        layer, lambda o, t: ce(o.reshape(-1, LD), t.reshape(-1)), opt,
        aux_loss_coeff=0.01)
    params = {"": {n: jnp.asarray(p[n]) for n in LEAVES}}
    opt_state, mstate = opt.init(params), layer.init_state()
    x, t = jnp.asarray(p["x"]), jnp.asarray(_labels())
    losses = []
    for _ in range(STEP["steps"]):
        params, opt_state, mstate, m = step(params, opt_state, mstate, x, t)
        losses.append(float(m["loss"]))
    return (p, losses, {n: np.asarray(v) for n, v in params[""].items()},
            float(mstate[""]["aux_loss"]))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("world", sorted(MESHES))
def test_bare_layer_through_the_step_matches_jax(world, dispatch, world2,
                                                 world4):
    """A MoELayer that is the whole model (its leaves are ``router``,
    ``w1`` ..., which no rule of MOE_EP_RULES names) through
    ``make_gspmd_train_step``: every rank's losses, parameters (its expert
    slice of each bank) and aux loss against the JAX layer through the
    JAX package's step on the global batch.  The step averages the banks
    over their data line because the layer holds a slice of its
    experts."""
    start, losses, want, aux = _jax_bare_step(dispatch)
    el = LE // MESHES[world][1]
    for r in _ranks(world, world2, world4):
        ei = int(r["coords"][1])
        np.testing.assert_allclose(r[f"step:{dispatch}:losses"], losses,
                                   rtol=RTOL)
        np.testing.assert_allclose(float(r[f"step:{dispatch}:aux"]), aux,
                                   rtol=RTOL)
        for n in LEAVES:
            w = want[n] if n == "router" else want[n][ei * el:(ei + 1) * el]
            np.testing.assert_allclose(r[f"step:{dispatch}:p:{n}"], w,
                                       rtol=RTOL, atol=ATOL, err_msg=n)
    # the steps moved every leaf: the check above is not vacuous
    assert all(np.abs(want[n] - start[n]).max() > 1e-3 for n in LEAVES)


# ---------------------------------------------------------------------------
# (b) train_lm --parallel ep against the JAX example's step
# ---------------------------------------------------------------------------

def _port_layout(tree):
    model = TorchLM(TRAIN["vocab"], dim=TRAIN["dim"], depth=TRAIN["depth"],
                    num_heads=TRAIN["heads"], max_seq_len=TRAIN["seq_len"],
                    num_experts=TRAIN["experts"], device="cpu")
    return {k: p.detach().numpy() for k, p in
            load_jax_params(model, tree).named_parameters()}


def test_train_lm_ep_world4_matches_jax(world4):
    """Three ``--parallel ep`` steps on a (data 2 × expert 2) mesh: every
    rank's losses, parameters (its expert slice of each bank) and aux
    losses against the JAX example's GSPMD step."""
    (params0, losses_j, params_j, aux_j), ranks = world4
    ref, start = _port_layout(params_j), _port_layout(params0)
    el = TRAIN["experts"] // 2
    for r in ranks:
        ei = int(r["coords"][1])
        assert tuple(r["train:shape"]) == (TRAIN["batch"], TRAIN["seq_len"])
        np.testing.assert_allclose(r["train:losses"], losses_j, rtol=1e-5)
        for k, want in ref.items():
            if k.rpartition(".")[2] in BANKS:
                want = want[ei * el:(ei + 1) * el]
            np.testing.assert_allclose(r[f"train:p:{k}"], want, rtol=1e-5,
                                       atol=2e-6, err_msg=k)
        for path, a in aux_j.items():
            np.testing.assert_allclose(float(r[f"train:aux:{path}"]), a,
                                       rtol=1e-5)
    # the steps moved the parameters: the check above is not vacuous
    assert max(float(np.abs(ref[k] - start[k]).max()) for k in ref) > 1e-3


def test_train_lm_ep_at_world1_trains(capsys):
    """``train_lm --parallel ep --device cpu`` in this process: the loss
    falls and the log line carries the aux sum."""
    args = train_lm.parse_args(
        ["--parallel", "ep", "--device", "cpu", "--steps", "30",
         "--seq-len", "32", "--dim", "32", "--depth", "2", "--heads", "4",
         "--vocab", "32", "--log-every", "10"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the suite's workers share the cores
    try:
        res = train_lm.train(args)
    finally:
        torch.set_num_threads(threads)
    assert res["losses"][-1] < 0.5 * res["losses"][0], res["losses"]
    assert res["losses"][1] != res["losses"][0]
    assert "(E=4 over 1 ranks, aux " in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (c) specs, slices and the interop round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binding", [None, {"expert": "expert"}])
def test_partition_pairs_are_the_jax_packages(binding):
    got = rules.partition_pairs(binding)
    want = jrules.partition_pairs(binding)
    assert [pat for pat, _ in got] == [pat for pat, _ in want]
    assert [spec for _, spec in got] == [tuple(s) for _, s in want]


def _spec_tree(specs):
    return {p: {k: tuple(v) for k, v in lv.items()}
            for p, lv in specs.items()}


@pytest.mark.parametrize("num_experts", [0, 4])
def test_rule_specs_are_the_jax_packages(num_experts):
    params = jax.tree.map(np.asarray, JaxLM(
        **{**TINY_LM, "num_experts": num_experts}).init(jax.random.key(0)))
    for port, ref in ((gspmd.MOE_EP_RULES, jgspmd.MOE_EP_RULES),
                      (gspmd.TRANSFORMER_TP_RULES,
                       jgspmd.TRANSFORMER_TP_RULES)):
        assert port.tree_specs(params) == _spec_tree(ref.tree_specs(params))
    for path, leaves in params.items():
        for leaf in leaves:
            key = f"['{path}']['{leaf}']"
            assert rules.spec_for_key(key) == tuple(jrules.spec_for_key(key))
            assert rules.spec_for_key(key, {"expert": "expert"}) == tuple(
                jrules.spec_for_key(key, {"expert": "expert"}))
    assert rules.spec_for_key("not-a-keystr") == ()
    # a port parameter name reads as its module path and leaf
    flat = {"block0.mlp.w1": 0, "block0.mlp.router": 0, "head.weight": 0}
    assert gspmd.MOE_EP_RULES.tree_specs(flat) == {
        "block0.mlp.w1": ("expert",), "block0.mlp.router": (),
        "head.weight": ()}


@pytest.mark.parametrize("world", sorted(MESHES))
def test_each_rank_holds_its_expert_slice(world, world2, world4):
    full = _tiny_jax_params()
    el = TINY_LM["num_experts"] // MESHES[world][1]
    local_want = _port_layout_tiny(full)
    for r in _ranks(world, world2, world4):
        ei = int(r["coords"][1])
        for path, leaves in full.items():
            for leaf, a in leaves.items():
                bank = leaf in BANKS and path.endswith(".mlp")
                want = a[ei * el:(ei + 1) * el] if bank else a
                np.testing.assert_array_equal(r[f"slice|{path}|{leaf}"],
                                              want)
                # jax_params gathers the whole bank back
                np.testing.assert_array_equal(r[f"back|{path}|{leaf}"], a)
        for k, want in local_want.items():
            if k.rpartition(".")[2] in BANKS:
                want = want[ei * el:(ei + 1) * el]
            np.testing.assert_array_equal(r[f"local|{k}"], want)


def _port_layout_tiny(tree):
    model = TorchLM(**TINY_LM, device="cpu")
    return {k: p.detach().numpy() for k, p in
            load_jax_params(model, tree).named_parameters()}


def test_a_seeded_layer_holds_the_unsplit_layers_experts():
    """Under a (1, 1) mesh the layer is the unsplit layer, and its seeded
    initialization draws the same banks as a layer built with no mesh."""
    g = torch.Generator().manual_seed(5)
    plain = tnn.MoELayer(8, 4, device="cpu")
    plain.reset_parameters(g)
    tdist.init_process_group(device="cpu", axis_names=("data", "expert"),
                             mesh_shape=(1, 1))
    try:
        layer = tnn.MoELayer(8, 4, device="cpu", expert_axis="expert")
        assert (layer.local_experts, layer.first_expert) == (4, 0)
        layer.reset_parameters(torch.Generator().manual_seed(5))
    finally:
        tdist.destroy_process_group()
    for (name, a), b in zip(plain.named_parameters(), layer.parameters()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# (d) the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
def test_dropless_and_an_uneven_split_raise(world, world2, world4):
    for r in _ranks(world, world2, world4):
        assert "dropless" in str(r["refused:dispatch"])
        assert "do not split" in str(r["refused:num_experts"])


def test_the_step_trains_a_model_axis_and_a_batchnorm():
    """A ``model`` axis trains (ROADMAP A9.6a: the MoE model under a data 1
    × model 1 mesh, three steps, the loss falls); a BatchNorm model takes
    the stateful step, and at data 1 it is the plain step: the loss, the
    updated parameters and the running statistics of a torch autograd step
    on the same batch within float32 tolerance."""
    tdist.init_process_group(device="cpu", axis_names=("data", "model"),
                             mesh_shape=(1, 1))
    try:
        model = TorchLM(**TINY_LM, device="cpu", model_axis="model")
        ce = tnn.CrossEntropyLoss()
        opt = toptim.SGD(lr=0.5)
        step = gspmd.make_gspmd_train_step(
            model, lambda lg, y: ce(lg.reshape(-1, TINY_LM["vocab_size"]),
                                    y.reshape(-1)), opt)
        params = dict(model.named_parameters())
        opt_state, mstate = opt.init(params), {}
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, TINY_LM["vocab_size"], (4, TINY_LM["max_seq_len"])))
        losses = []
        for _ in range(3):
            params, opt_state, mstate, m = step(params, opt_state, mstate,
                                                x, (x + 1) % 16)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0], losses
        def bn_net():
            torch.manual_seed(0)
            return torch.nn.Sequential(
                tnn.Conv2d(3, 4, 3, device="cpu"),
                tnn.BatchNorm2d(4, device="cpu"), torch.nn.Flatten(),
                tnn.Linear(4 * 4 * 4, 5, device="cpu"))
        bn, ref = bn_net(), bn_net()
        g = np.random.default_rng(1)
        xb = torch.from_numpy(g.standard_normal((8, 3, 6, 6)).astype(
            np.float32))
        yb = torch.from_numpy(g.integers(0, 5, 8))
        ce_bn = tnn.CrossEntropyLoss()
        step = gspmd.make_gspmd_train_step(bn, ce_bn, opt)
        bparams = dict(bn.named_parameters())
        bparams, _, bstate, m = step(bparams, opt.init(bparams), {}, xb, yb)
        loss = ce_bn(ref(xb), yb)
        loss.backward()
        np.testing.assert_allclose(float(m["loss"]), float(loss.detach()),
                                   rtol=1e-6)
        with torch.no_grad():
            for k, p in ref.named_parameters():
                np.testing.assert_allclose(
                    bparams[k].numpy(), (p - 0.5 * p.grad).numpy(),
                    rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(bstate["1"]["mean"].numpy(),
                                   ref[1].running_mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(bstate["1"]["var"].numpy(),
                                   ref[1].running_var.numpy(), atol=1e-6)
    finally:
        tdist.destroy_process_group()
