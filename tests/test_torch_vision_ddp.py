"""The port's DDP training and evaluation of the ConvNet and ResNet-18
against the JAX package's ``DistributedDataParallel``.

The JAX DDP runs over a group of the port's world's size,
``ProcessGroup(jax.devices()[:W])``: W = 1 in process, and W = 2 against the
port's gloo world of two processes (each holding its half of the batch, as
each JAX device does), since BatchNorm's batch statistics are per replica.

Each step is held from the same state: before every step the port's
parameters, momentum buffers and BatchNorm statistics are set to the JAX
run's (a ReLU or max-pool that one rounding flips would otherwise send the
two runs apart, which says nothing about the step).

Tolerances:

- float32: what the forward computes is held tightly: the loss within
  1e-5 relative, the correct count equal, the BatchNorm statistics within
  1e-5 relative plus 1e-6 absolute.  The step (each parameter's update) is
  held to 4e-2 of the update's norm over all parameters and 8e-2 for any
  one (about three times one flip's effect, below): the backward takes
  each ReLU's branch from the sign of its input, and an input within
  rounding of 0 can take the other branch in one of the two runs.  Measured on ResNet-18 at batch 16: most steps agree within
  1e-5 of the update; one such flip at layer4, whose maps are 1x1, moved
  1.4% of a whole step and 1.9% of one leaf's (a float64 run of the port
  sided with the JAX step that time).
- bf16 compute: the JAX package's bf16 step is itself far from its float32
  step (its BatchNorm and bias gradients are reductions accumulated in
  bf16), so the port's bf16 step is held to the JAX float32 step at no more
  than 1.5 times the JAX bf16 step's own error, over all parameters and
  over the BatchNorm statistics, with the loss within 2^-6 relative of the
  JAX bf16 loss (two bf16 steps) and the counts within one image.
- evaluation: the loss within 1e-5 relative, the accuracy and the count
  exact, on a test set that is a multiple of neither the batch nor the
  world size.  Dropout's masks, through the step's per-step, per-rank key,
  are bit for bit the JAX package's.

Planted faults the checks must reject: rank 0's BatchNorm statistics kept
instead of the average (torch DDP's buffer broadcast) at world 2."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import models as tmodels
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import jax_state, load_jax_params, load_jax_state
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
STEP_TOL, LEAF_TOL = 4e-2, 8e-2
RECIPES = {
    # the ResNet example's recipe; the ConvNet at its convergent rate
    "convnet": dict(lr=0.05),
    "resnet18": dict(lr=0.02, momentum=0.9, weight_decay=1e-4,
                     nesterov=True),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_model(name):
    return (jmodels.ConvNet() if name == "convnet"
            else jmodels.resnet18(num_classes=10))


def _port_model(name):
    return (tmodels.ConvNet(device="cpu") if name == "convnet"
            else tmodels.resnet18(num_classes=10, device="cpu"))


def _batches(name, n_steps, batch, seed=0):
    rng = np.random.default_rng(seed)
    hw, c = ((28, 28), 1) if name == "convnet" else ((32, 32), 3)
    return [(rng.normal(size=(batch, *hw, c)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32))
            for _ in range(n_steps)]


def _jax_ddp(name, world=1, compute_dtype=None, sync=False):
    return JaxDDP(_jax_model(name), optimizer=joptim.SGD(**RECIPES[name]),
                  loss_fn=jnn.CrossEntropyLoss(),
                  group=JaxGroup(jax.devices()[:world]), donate=False,
                  compute_dtype=compute_dtype, sync_batchnorm=sync)


def _torch_ddp(name, compute_dtype=None):
    model = _port_model(name)
    ddp = TorchDDP(model, optimizer=toptim.SGD(**RECIPES[name]),
                   loss_fn=tnn.CrossEntropyLoss(),
                   compute_dtype=compute_dtype)
    return ddp, ddp.init(seed=0)


def _set_state(name, ddp, state, jstate):
    """The port's parameters, momentum buffers and BatchNorm statistics set
    to the JAX state's, in place."""
    load_jax_params(ddp.module, _np(jstate.params))
    if jstate.model_state:
        load_jax_state(ddp.module, _np(jstate.model_state))
    if "momentum" in jstate.opt_state:
        scratch = _port_model(name)
        load_jax_params(scratch, _np(jstate.opt_state["momentum"]))
        for k, v in scratch.named_parameters():
            state.opt_state["momentum"][k].copy_(v)


def _port_params(name, jparams):
    scratch = _port_model(name)
    load_jax_params(scratch, _np(jparams))
    return {k: v.detach() for k, v in scratch.named_parameters()}


def _update_errors(got, want, before):
    """Per leaf ``|got - want| / |want - before|`` and over all leaves."""
    leaf, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        e = float((got[k].detach().float() - w).norm())
        u = float((w - before[k]).norm())
        leaf[k] = e / max(u, 1e-30)
        num += e * e
        den += u * u
    return leaf, (num / den) ** 0.5


def _stat_error(got, want):
    """Largest error of the BatchNorm statistics over ``1e-6 + 1e-5|want|``
    (within tolerance when <= 1)."""
    worst = 0.0
    for p in want:
        for k in ("mean", "var"):
            g, w = np.asarray(got[p][k]), np.asarray(want[p][k])
            worst = max(worst, float((np.abs(g - w) /
                                      (1e-6 + 1e-5 * np.abs(w))).max()))
    return worst


def _stats_rel(got, want):
    num = sum(float(((np.asarray(got[p][k]) - want[p][k]) ** 2).sum())
              for p in want for k in ("mean", "var"))
    den = sum(float((np.asarray(want[p][k]) ** 2).sum())
              for p in want for k in ("mean", "var"))
    return (num / den) ** 0.5


@pytest.fixture(scope="module", params=["convnet", "resnet18"])
def float32_run(request):
    """Three JAX float32 steps, each with the port's step from the same
    state (the JAX state before each step is kept for the bf16 test)."""
    name = request.param
    jd = _jax_ddp(name)
    js = jd.init(seed=0)
    td, ts = _torch_ddp(name)
    out = []
    for x, y in _batches(name, STEPS, 16):
        _set_state(name, td, ts, js)
        before = {k: v.detach().clone() for k, v in ts.params.items()}
        start = js
        js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        ts, tm = td.train_step(ts, _nchw(x), torch.from_numpy(y).long())
        out.append(dict(x=x, y=y, start=start, before=before, jm=_np(jm),
                        tm=tm, want=_port_params(name, js.params),
                        got={k: v.detach().clone()
                             for k, v in ts.params.items()},
                        want_stats=_np(js.model_state),
                        got_stats=jax_state(td.module)))
    return name, out


def test_float32_steps_match_jax(float32_run):
    name, steps = float32_run
    for i, s in enumerate(steps):
        loss_j, loss_t = float(s["jm"]["loss"]), float(s["tm"]["loss"])
        assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j), (i, loss_t, loss_j)
        assert int(s["tm"]["correct"]) == int(s["jm"]["correct"])
        leaf, total = _update_errors(s["got"], s["want"], s["before"])
        worst = max(leaf, key=leaf.get)
        assert leaf[worst] <= LEAF_TOL, (i, worst, leaf[worst])
        assert total <= STEP_TOL, (i, total)
        if name == "resnet18":
            assert len(s["want_stats"]) == 20
            assert _stat_error(s["got_stats"], s["want_stats"]) <= 1.0


def test_bf16_steps_match_jax_at_its_own_accuracy(float32_run):
    """bf16 compute over float32 masters, each step from the JAX float32
    run's state: the port's step against the JAX float32 step, no further
    from it than the JAX bf16 step is."""
    name, steps = float32_run
    jd16 = _jax_ddp(name, compute_dtype=jnp.bfloat16)
    td, ts = _torch_ddp(name, compute_dtype=torch.bfloat16)
    for i, s in enumerate(steps):
        _set_state(name, td, ts, s["start"])
        js16, jm16 = jd16.train_step(s["start"], jnp.asarray(s["x"]),
                                     jnp.asarray(s["y"]))
        ts, tm = td.train_step(ts, _nchw(s["x"]),
                               torch.from_numpy(s["y"]).long())
        _, e_jax = _update_errors(_port_params(name, js16.params), s["want"],
                                  s["before"])
        _, e_port = _update_errors(dict(ts.params), s["want"], s["before"])
        assert e_port <= 1.5 * e_jax, (i, e_port, e_jax)
        loss16, loss_t = float(jm16["loss"]), float(tm["loss"])
        assert abs(loss_t - loss16) <= 2 ** -6 * abs(loss16), \
            (i, loss_t, loss16)
        assert abs(int(tm["correct"]) - int(jm16["correct"])) <= 1
        if name == "resnet18":
            s_port = _stats_rel(jax_state(td.module), s["want_stats"])
            s_jax = _stats_rel(_np(js16.model_state), s["want_stats"])
            assert s_port <= 1.5 * s_jax, (i, s_port, s_jax)
            # the statistics stay float32 masters under bf16 compute
            assert all(t.dtype == torch.float32
                       for lv in ts.model_state.values()
                       for t in lv.values())


def test_train_chunk_equals_steps():
    for name in ("convnet", "resnet18"):
        batches = _batches(name, 3, 8, seed=2)
        xs = torch.stack([_nchw(x) for x, _ in batches])
        ys = torch.stack([torch.from_numpy(y).long() for _, y in batches])
        td, ts = _torch_ddp(name)
        ts, m = td.train_chunk(ts, xs, ys)
        chunk_params = {k: v.detach().clone() for k, v in ts.params.items()}
        chunk_stats = jax_state(td.module)
        td2, ts2 = _torch_ddp(name)
        losses = []
        for x, y in zip(xs, ys):
            ts2, m2 = td2.train_step(ts2, x, y)
            losses.append(m2["loss"])
        assert m["loss"].shape == m["correct"].shape == (3,)
        assert torch.equal(m["loss"], torch.stack(losses))
        assert ts.step == ts2.step == 3
        for k, v in ts2.params.items():
            assert torch.equal(chunk_params[k], v), k
        for p, lv in jax_state(td2.module).items():
            for k in lv:
                assert np.array_equal(chunk_stats[p][k], lv[k])


def _ragged_test_set(n=37, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def trained_resnet():
    """A JAX ResNet-18 state with running statistics away from their
    initial values."""
    jd = _jax_ddp("resnet18")
    js = jd.init(seed=0)
    rng = np.random.default_rng(9)
    moved = {p: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape)
                 .astype(np.float32)}
             for p, v in _np(js.model_state).items()}
    return jd.module, js._replace(model_state=jax.tree.map(jnp.asarray,
                                                           moved))


@pytest.mark.parametrize("loss", ["cross_entropy", "plain_function"])
def test_evaluate_eval_step_and_forward_match_jax(trained_resnet, loss):
    """ResNet-18 in eval mode on a test set of 37 rows in batches of 16
    (the last has 5, padded to 16); with the loss module (padding carries ignore_index) and with a
    plain function (padding masked by position, each row's own loss)."""
    from tpu_dist.nn import functional as JF
    from tpu_dist_torch.nn import functional as TF
    module, js = trained_resnet
    plain = loss == "plain_function"
    jd = JaxDDP(module, loss_fn=(lambda o, t: JF.cross_entropy(o, t))
                if plain else jnn.CrossEntropyLoss(),
                group=JaxGroup(jax.devices()[:1]))
    td, ts = _torch_ddp("resnet18")
    _set_state("resnet18", td, ts, js)
    if plain:
        td.loss_fn = lambda o, t: TF.cross_entropy(o, t)
    x, y = _ragged_test_set()
    jloader = [(jnp.asarray(x[i:i + 16]), jnp.asarray(y[i:i + 16]))
               for i in range(0, 37, 16)]
    tloader = [(_nchw(x[i:i + 16]), torch.from_numpy(y[i:i + 16]).long())
               for i in range(0, 37, 16)]
    stats_before = jax_state(td.module)
    want = jd.evaluate(js, jloader)
    got = td.evaluate(ts, tloader)
    assert got["count"] == want["count"] == 37
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    # eval_step on a padded batch: 5 real rows of 8
    xp = np.concatenate([x[32:], np.zeros((3, 32, 32, 3), np.float32)])
    yp = np.concatenate([y[32:], np.full(3, -100, np.int32)])
    if loss == "plain_function":
        yp[5:] = 0
    we = _np(jd.eval_step(js, jnp.asarray(xp), jnp.asarray(yp), n_valid=5))
    ge = td.eval_step(ts, _nchw(xp), torch.from_numpy(yp).long(), n_valid=5)
    assert int(ge["scored"]) == int(we["scored"]) == 5
    assert int(ge["correct"]) == int(we["correct"])
    assert abs(float(ge["loss_sum"]) - float(we["loss_sum"])) <= \
        1e-5 * abs(float(we["loss_sum"]))
    wf = np.asarray(jd.forward(js, jnp.asarray(x[:8])))
    gf = td.forward(ts, _nchw(x[:8])).numpy()
    assert np.abs(gf - wf).max() <= 1e-5 * np.abs(wf).max()
    # evaluation leaves the running statistics as they were
    after = jax_state(td.module)
    assert all(np.array_equal(after[p][k], stats_before[p][k])
               for p in after for k in ("mean", "var"))
    assert td.evaluate(ts, []) == {"loss": 0.0, "accuracy": 0.0, "count": 0}


class _JaxMLP(jnn.Module):
    def __init__(self):
        super().__init__()
        self.net = jnn.Sequential(jnn.Linear(12, 32), jnn.ReLU(),
                                  jnn.Dropout(0.4), jnn.Linear(32, 5))

    def forward(self, x):
        return self.net(x)


class _TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = tnn.Sequential(tnn.Linear(12, 32, device="cpu"),
                                  tnn.ReLU(), tnn.Dropout(0.4),
                                  tnn.Linear(32, 5, device="cpu"))

    def forward(self, x):
        return self.net(x)


def test_dropout_keys_follow_jax_per_step():
    """A model that calls Dropout: the port's steps draw the JAX package's
    masks from ``fold_in(fold_in(rng, step), rank)``, so the losses and
    parameters agree step by step (float32, 1e-6)."""
    jd = JaxDDP(_JaxMLP(), optimizer=joptim.SGD(lr=0.5),
                loss_fn=jnn.CrossEntropyLoss(),
                group=JaxGroup(jax.devices()[:1]), donate=False)
    js = jd.init(seed=4)
    model = _TorchMLP()
    td = TorchDDP(model, optimizer=toptim.SGD(lr=0.5),
                  loss_fn=tnn.CrossEntropyLoss())
    ts = td.init(seed=4)
    np.testing.assert_array_equal(ts.rng.numpy(), np.asarray(js.rng))
    load_jax_params(model, _np(js.params))
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.normal(size=(6, 12)).astype(np.float32)
        y = rng.integers(0, 5, 6).astype(np.int32)
        js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        ts, tm = td.train_step(ts, torch.from_numpy(x),
                               torch.from_numpy(y).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
    want = _np(js.params)
    for k, v in ts.params.items():
        path, leaf = k.rsplit(".", 1)
        w = want[path][leaf]
        np.testing.assert_allclose(v.detach().numpy(),
                                   w.T if leaf == "weight" else w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sync_batchnorm_at_world1_is_per_replica_batchnorm():
    td, ts = _torch_ddp("resnet18")
    sync = TorchDDP(_port_model("resnet18"),
                    optimizer=toptim.SGD(**RECIPES["resnet18"]),
                    loss_fn=tnn.CrossEntropyLoss(), sync_batchnorm=True)
    ss = sync.init(seed=0)
    sync.module.load_state_dict(td.module.state_dict())
    x, y = _batches("resnet18", 1, 8)[0]
    ts, m1 = td.train_step(ts, _nchw(x), torch.from_numpy(y).long())
    ss, m2 = sync.train_step(ss, _nchw(x), torch.from_numpy(y).long())
    assert torch.equal(m1["loss"], m2["loss"])
    for k in ts.params:
        assert torch.equal(ts.params[k], ss.params[k]), k


# ---------------------------------------------------------------------------
# world 2: the port's gloo ranks against the JAX DDP over 2 devices
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import jax_state, load_jax_params, \\
        load_jax_state
    from tpu_dist_torch.models import resnet18
    from tpu_dist_torch.parallel import DistributedDataParallel

    rank, port, inp, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(2)
    d = dict(np.load(inp))

    def tree(prefix):
        t = {}
        for k, v in d.items():
            if k.startswith(prefix + "|"):
                _, path, leaf = k.split("|")
                t.setdefault(path, {})[leaf] = v
        return t

    def rank0_stats(self, model_state):
        # the planted fault: torch DDP's buffer broadcast keeps rank 0's
        for leaves in model_state.values():
            for t in leaves.values():
                torch.distributed.broadcast(t, 0)

    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank, device="cpu",
                                 timeout=120)
    res = {}
    rows = slice(rank * 4, (rank + 1) * 4)
    for variant in ("replica", "sync", "rank0"):
        src = "sync" if variant == "sync" else "replica"
        model = resnet18(num_classes=10, device="cpu")
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=0.02, momentum=0.9,
                                       weight_decay=1e-4, nesterov=True),
            loss_fn=nn.CrossEntropyLoss(), group=pg,
            sync_batchnorm=variant == "sync")
        if variant == "rank0":
            ddp._average_state = rank0_stats.__get__(ddp)
        state = ddp.init(seed=0)
        for step in range(3):
            load_jax_params(model, tree(f"{src}{step}p"))
            load_jax_state(model, tree(f"{src}{step}s"))
            mom = resnet18(num_classes=10, device="cpu")
            load_jax_params(mom, tree(f"{src}{step}m"))
            for k, v in mom.named_parameters():
                state.opt_state["momentum"][k].copy_(v)
            x = torch.from_numpy(d[f"x{step}"][rows])
            y = torch.from_numpy(d[f"y{step}"][rows]).long()
            state, m = ddp.train_step(state, x, y)
            tag = f"{variant}{step}"
            res[f"{tag}:loss"] = float(m["loss"])
            res[f"{tag}:correct"] = int(m["correct"])
            for k, v in state.params.items():
                res[f"{tag}:p:{k}"] = v.detach().numpy().copy()
            for p, lv in jax_state(model).items():
                for k, v in lv.items():
                    res[f"{tag}:s:{p}:{k}"] = v
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _flat(prefix, tree):
    return {f"{prefix}|{p}|{k}": np.asarray(v) for p, lv in tree.items()
            for k, v in lv.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2_run(tmp_path_factory):
    """Three JAX steps over a 2-device group per variant (per-replica and
    synced BatchNorm), global batch 8; then the port's two gloo ranks take
    the same steps from the same states, 4 rows each."""
    tmp = tmp_path_factory.mktemp("world2")
    batches = _batches("resnet18", STEPS, 8, seed=6)
    feed, want = {}, {}
    for i, (x, y) in enumerate(batches):
        feed[f"x{i}"] = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        feed[f"y{i}"] = y
    for variant in ("replica", "sync"):
        jd = _jax_ddp("resnet18", world=2, sync=variant == "sync")
        js = jd.init(seed=0)
        for i, (x, y) in enumerate(batches):
            feed.update(_flat(f"{variant}{i}p", _np(js.params)))
            feed.update(_flat(f"{variant}{i}s", _np(js.model_state)))
            feed.update(_flat(f"{variant}{i}m",
                              _np(js.opt_state["momentum"])))
            before = _port_params("resnet18", js.params)
            js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
            want[f"{variant}{i}"] = dict(
                loss=float(jm["loss"]), correct=int(jm["correct"]),
                before=before, params=_port_params("resnet18", js.params),
                stats=_np(js.model_state))
    np.savez(tmp / "in.npz", **feed)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), str(tmp / "in.npz"),
         str(tmp / f"r{r}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err
    return want, [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)]


def _rank_result(res, tag):
    params = {k.split(":", 2)[2]: torch.from_numpy(v)
              for k, v in res.items() if k.startswith(f"{tag}:p:")}
    stats = {}
    for k, v in res.items():
        if k.startswith(f"{tag}:s:"):
            _, _, p, leaf = k.split(":")
            stats.setdefault(p, {})[leaf] = v
    return params, stats


def _world2_ok(want, res, tag, src):
    """Whether the rank's step ``tag`` matches the JAX step ``src`` at the
    float32 tolerances."""
    w = want[src]
    params, stats = _rank_result(res, tag)
    leaf, total = _update_errors(params, w["params"], w["before"])
    return (abs(res[f"{tag}:loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
            and int(res[f"{tag}:correct"]) == w["correct"]
            and max(leaf.values()) <= LEAF_TOL and total <= STEP_TOL
            and _stat_error(stats, w["stats"]) <= 1.0)


@pytest.mark.parametrize("variant", ["replica", "sync"])
def test_world2_steps_match_jax(world2_run, variant):
    """Per-replica BatchNorm with the running statistics averaged over the
    ranks; and SyncBatchNorm, whose batch statistics and their gradients
    span both ranks."""
    want, ranks = world2_run
    for res in ranks:
        for step in range(STEPS):
            tag = f"{variant}{step}"
            assert _world2_ok(want, res, tag, tag), (tag, res[f"{tag}:loss"],
                                                     want[tag]["loss"])
    # both ranks hold the same state
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_world2_sync_differs_from_per_replica(world2_run):
    """The two BatchNorm modes take different steps here, so each check
    above tells them apart."""
    want, ranks = world2_run
    assert not _world2_ok(want, ranks[0], "replica0", "sync0")
    assert not _world2_ok(want, ranks[0], "sync0", "replica0")


def test_world2_rejects_rank0_statistics(world2_run):
    """The planted fault: keeping rank 0's running statistics (torch DDP's
    buffer broadcast) instead of their average must fail the check; the
    parameters, which do not depend on them, still match."""
    want, ranks = world2_run
    for res in ranks:
        assert not _world2_ok(want, res, "rank00", "replica0")
        params, stats = _rank_result(res, "rank00")
        w = want["replica0"]
        leaf, total = _update_errors(params, w["params"], w["before"])
        assert total <= STEP_TOL
        assert _stat_error(stats, w["stats"]) > 1.0


# ---------------------------------------------------------------------------
# the example twins, on the CPU
# ---------------------------------------------------------------------------

def _run_example(module, *argv, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    return subprocess.run(
        [sys.executable, "-m", f"tpu_dist_torch.examples.{module}", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


SPAWN_ARGS = ("--device", "cpu", "--spawn", "-g", "2", "--synthetic",
              "--max-steps", "3", "--evaluate")


def test_mpspawn_dist_twin_runs_two_ranks_on_cpu():
    r = _run_example("mpspawn_dist", *SPAWN_ARGS)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "My rank is 0 of 2 processes; 2 device replicas" in out
    assert "Load data....done!" in out and "Training complete in:" in out
    assert "(10000 samples)" in out and out.count("Test: loss") == 1


def test_example_mp_twin_runs_two_ranks_on_cpu(tmp_path):
    """Two ranks train, evaluate and checkpoint (rank 0 writes); then two
    ranks resume: rank 0 finds the newest step and broadcasts it."""
    r = _run_example("example_mp", *SPAWN_ARGS, "--checkpoint-dir",
                     str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "[init] == process rank 0, 2 device replicas ==" in out
    assert "[init] == process rank 1, 2 device replicas ==" in out
    assert "Training complete in:" in out and "(10000 samples)" in out
    assert os.listdir(tmp_path) == ["step_00000003"]
    r = _run_example("example_mp", "--device", "cpu", "--spawn", "-g", "2",
                     "--synthetic", "--max-steps", "1", "--resume",
                     "--checkpoint-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("resumed from step 3") == 1
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
