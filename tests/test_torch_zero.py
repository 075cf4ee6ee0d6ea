"""ZeRO in the port against the JAX package: ``ZeroOptimizer`` (its
parameters and its state pytree), the state bytes ÷ world, ``ZeroStateError``,
sharded clipping, the DDP's ``shard_optimizer`` and ``comm_dtype`` with and
without ``accum_steps``, ``train_repeat`` and ``state_shardings``, and the
``bench_zero`` twin's smoke run.

The JAX ``ZeroOptimizer`` runs pinned to DataPlanes over fake ranks in
threads (``tests/test_zero.py``'s rig); the JAX DDP runs over one or two of
conftest's virtual devices.  The port runs world 1 in this process and
worlds 2 and 3 as spawned gloo ranks (one spawn each).  Tolerances:
``ZeroOptimizer``'s parameters and state are held to rtol 1e-6, atol 1e-7 —
the wrapped AdamW's own tolerance against JAX's (``tests/test_torch_
optim.py``: the port's multi-tensor kernels round a multiply-add once where
JAX's eager ops round twice); its layout metadata and counters exactly,
and its reduce-scatter shards bit for bit at worlds 1 and 2
(``tests/test_torch_bucketer.py``); the DDP steps to the port's usual
matmul tolerance against JAX (SGD with momentum, as the other DDP parity
tests: an adaptive optimizer steps on rounding noise where a gradient is 0
in exact arithmetic; rtol 1e-5, atol 2e-6; with ``comm_dtype``
bfloat16 a gradient may round to the other side of a bf16 step, so rtol
1e-2, atol 1e-4 on the parameters); inside the port, ZeRO against
replicated is bit for bit at every world.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import checkpoint as tckpt
from tpu_dist_torch import dist as tdist
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM

REPO = str(pathlib.Path(__file__).resolve().parents[1])
WORLDS = (2, 3)
MODEL = dict(vocab_size=32, dim=16, depth=2, num_heads=2, max_seq_len=8)
ROWS, T = 8, 8
DDP_CASES = {   # name: (shard_optimizer, comm_dtype, accum_steps)
    "dense": (False, None, 1), "zero1": (True, None, 1),
    "comm_bf16": (False, "bfloat16", 1), "zero1_bf16": (True, "bfloat16", 1),
    "zero1_accum": (True, None, 2), "comm_bf16_accum": (False, "bfloat16", 2),
}

PORT_SRC = textwrap.dedent("""
    import numpy as np
    import torch
    from tpu_dist_torch import collectives as C, nn, optim
    from tpu_dist_torch.interop import load_jax_params
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import (DistributedDataParallel,
                                         ZeroOptimizer)

    def grad_tree(seed):
        g = np.random.default_rng(seed)
        return {"w1": torch.from_numpy(g.standard_normal(1001).astype(np.float32)),
                "w2": torch.from_numpy(g.standard_normal((7, 13)).astype(np.float32)),
                "w3": torch.from_numpy(g.standard_normal(3).astype(np.float32)),
                "b": torch.tensor(np.float32(g.standard_normal()))}

    def params0():
        return {k: v * 0.5 for k, v in grad_tree(77).items()}

    def zero_run(pg, rank, steps=3, clip=None):
        zopt = ZeroOptimizer(optim.AdamW(lr=1e-2), group=pg,
                             max_grad_norm=clip, bucket_bytes=4096)
        params = params0()
        zstate = zopt.init(params)
        for s in range(steps):
            g = grad_tree(1000 * (rank + 1) + s)
            handle, zstate = zopt.update(zopt.reduce_scatter(g, group=pg),
                                         zstate, group=pg)
            params = handle.wait(timeout=60)
        return params, zstate

    def replicated_run(pg, rank, steps=3):
        opt = optim.AdamW(lr=1e-2)
        params = params0()
        state = opt.init(params)
        b = C.Bucketer(bucket_bytes=4096)
        for s in range(steps):
            g = b.all_reduce(grad_tree(1000 * (rank + 1) + s), op="avg",
                             group=pg).wait_all(timeout=60)
            params, state = opt.update(g, state, params)
        return params

    def ddp_run(pg, rank, world, case, feed, model_kw, steps=3):
        shard, cd, accum = case
        model = TransformerLM(**model_kw, device="cpu")
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=0.1, momentum=0.9),
            loss_fn=nn.CrossEntropyLoss(), group=pg,
            shard_optimizer=shard, accum_steps=accum,
            comm_dtype=getattr(torch, cd) if cd else None)
        state = ddp.init(seed=0)
        tree = {}
        for k, v in feed.items():
            if k.startswith("p|"):
                _, path, leaf = k.split("|")
                tree.setdefault(path, {})[leaf] = v
        load_jax_params(model, tree)
        rows = feed["x"].shape[0] // world
        sl = slice(rank * rows, (rank + 1) * rows)
        x = torch.from_numpy(feed["x"][sl]).long()
        y = torch.from_numpy(feed["y"][sl]).long()
        losses = []
        for _ in range(steps):
            state, m = ddp.train_step(state, x, y)
            losses.append(float(m["loss"]))
        return losses, {k: v.detach().clone() for k, v in state.params.items()}
""")

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist
    n, rank, port, inp, out, src, cases, model_kw = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6], json.loads(sys.argv[7]),
        json.loads(sys.argv[8]))
    torch.set_num_threads(1)
    ns = {}
    exec(src, ns)
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=n, rank=rank, device="cpu",
                                 timeout=120)
    res = {}
    params, zstate = ns["zero_run"](pg, rank)
    for k, v in params.items():
        res[f"zp|{k}"] = v.numpy()
    for k, v in zstate["shards"].items():
        res[f"zs|{k}"] = v.numpy()
    for k in ("m", "v"):
        for d, v in zstate["opt"][k].items():
            res[f"zo|{k}|{d}"] = v.numpy()
    res["zo|step"] = zstate["opt"]["step"].numpy()
    for k, v in zstate["meta"].items():
        res[f"zm|{k}"] = np.asarray(v)
    for k, v in ns["replicated_run"](pg, rank).items():
        res[f"rp|{k}"] = v.numpy()
    for k, v in ns["zero_run"](pg, rank, steps=2, clip=0.5)[0].items():
        res[f"zc|{k}"] = v.numpy()
    if n == 2:
        feed = dict(np.load(inp))
        for name, case in cases.items():
            losses, params = ns["ddp_run"](pg, rank, n, case, feed, model_kw)
            res[f"{name}|loss"] = np.asarray(losses)
            for k, v in params.items():
                res[f"{name}|p|{k}"] = v.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _ns():
    ns = {}
    exec(PORT_SRC, ns)
    return ns


def _grad_tree(seed):
    g = np.random.default_rng(seed)
    return {"w1": g.standard_normal(1001).astype(np.float32),
            "w2": g.standard_normal((7, 13)).astype(np.float32),
            "w3": g.standard_normal(3).astype(np.float32),
            "b": np.float32(g.standard_normal())}


def _jax_zero(n, steps=3, clip=None):
    """The JAX ZeroOptimizer over n fake ranks (pinned DataPlanes)."""
    from tpu_dist.collectives.transport import DataPlane
    from tpu_dist.dist.store import TCPStore
    from tpu_dist.parallel import ZeroOptimizer as JZ
    store = TCPStore(is_master=True)
    dps = [DataPlane(store, r, n) for r in range(n)]
    out, errs = [None] * n, []

    def run(r):
        try:
            z = JZ(joptim.AdamW(lr=1e-2), dp=dps[r], max_grad_norm=clip,
                   bucket_bytes=4096)
            params = {k: v * np.float32(0.5)
                      for k, v in _grad_tree(77).items()}
            zs = z.init(params)
            for s in range(steps):
                h, zs = z.update(_grad_tree(1000 * (r + 1) + s), zs)
                params = h.wait(timeout=60)
            out[r] = (params, zs)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append((r, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for dp in dps:
        dp.close()
    store.close()
    assert not errs, errs
    return out


def _batch():
    rng = np.random.default_rng(5)
    return (rng.integers(0, MODEL["vocab_size"], (ROWS, T)).astype(np.int32),
            rng.integers(0, MODEL["vocab_size"], (ROWS, T)).astype(np.int32))


def _tree(params):
    return {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}


@pytest.fixture(scope="module")
def jax_ddp():
    """Three steps of each DDP case over one and two virtual devices, from
    one init (``ddp.init(seed=0)``)."""
    x, y = _batch()
    out, params0 = {}, None
    for world in (1, 2):
        for name, (shard, cd, accum) in DDP_CASES.items():
            ddp = JaxDDP(JaxLM(**MODEL),
                         optimizer=joptim.SGD(lr=0.1, momentum=0.9),
                         loss_fn=jnn.CrossEntropyLoss(),
                         group=JaxGroup(jax.devices()[:world]), donate=False,
                         shard_optimizer=shard, accum_steps=accum,
                         comm_dtype=getattr(jnp, cd) if cd else None)
            state = ddp.init(seed=0)
            params0 = _tree(state.params)
            losses = []
            for _ in range(3):
                state, m = ddp.train_step(state, jnp.asarray(x),
                                          jnp.asarray(y))
                losses.append(float(m["loss"]))
            out[(world, name)] = (losses, _tree(state.params))
    return out, params0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_ddp):
    import json
    tmp = tmp_path_factory.mktemp("zero")
    x, y = _batch()
    feed = {"x": x, "y": y}
    feed.update({f"p|{p}|{k}": v for p, lv in jax_ddp[1].items()
                 for k, v in lv.items()})
    np.savez(tmp / "in.npz", **feed)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    procs = []
    for n in WORLDS:
        port = _free_port()
        procs += [(n, r, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(n), str(r), str(port),
             str(tmp / "in.npz"), str(tmp / f"w{n}r{r}.npz"), PORT_SRC,
             json.dumps(DDP_CASES), json.dumps(MODEL)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for r in range(n)]
    for n, r, p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
    return {n: [dict(np.load(tmp / f"w{n}r{r}.npz")) for r in range(n)]
            for n in WORLDS}


@pytest.fixture
def pg1():
    pg = tdist.init_process_group(device="cpu")
    yield pg
    tdist.destroy_process_group()


def _hold(got, want, n):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _port_zero_world1():
    ns = _ns()
    pg = tdist.get_default_group()
    return ns, ns["zero_run"](pg, 0)


# ---------------------------------------------------------------------------
# ZeroOptimizer against the JAX ZeroOptimizer
# ---------------------------------------------------------------------------

def test_zero_world1_matches_jax(pg1):
    _, (params, zstate) = _port_zero_world1()
    want_p, want_s = _jax_zero(1)[0]
    for k, v in want_p.items():
        _hold(params[k].numpy().reshape(np.shape(v)), v, 1)
    _hold(zstate["shards"]["<f4"].numpy(), want_s["shards"]["<f4"], 1)
    for k in ("m", "v"):
        _hold(zstate["opt"][k]["<f4"].numpy(), want_s["opt"][k]["<f4"], 1)


@pytest.mark.parametrize("n", WORLDS)
def test_zero_params_match_jax(worlds, n):
    want = _jax_zero(n)
    for r in range(n):
        for k, v in want[r][0].items():
            _hold(worlds[n][r][f"zp|{k}"].reshape(np.shape(v)), v, n)


@pytest.mark.parametrize("n", WORLDS)
def test_zero_state_pytree_matches_jax(worlds, n):
    want = _jax_zero(n)
    for r in range(n):
        zs = want[r][1]
        _hold(worlds[n][r]["zs|<f4"], zs["shards"]["<f4"], n)
        for k in ("m", "v"):
            _hold(worlds[n][r][f"zo|{k}|<f4"], zs["opt"][k]["<f4"], n)
        assert int(worlds[n][r]["zo|step"]) == int(zs["opt"]["step"])
        for k, v in zs["meta"].items():
            np.testing.assert_array_equal(worlds[n][r][f"zm|{k}"],
                                          np.asarray(v), err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_zero_equals_replicated_bitwise(worlds, n):
    for r in range(n):
        for k in ("w1", "w2", "w3", "b"):
            assert worlds[n][r][f"zp|{k}"].tobytes() == \
                worlds[n][r][f"rp|{k}"].tobytes(), (r, k)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_clip_matches_jax(worlds, n):
    want = _jax_zero(n, steps=2, clip=0.5)
    for r in range(n):
        for k, v in want[r][0].items():
            np.testing.assert_allclose(
                worlds[n][r][f"zc|{k}"].reshape(np.shape(v)), v, rtol=1e-6,
                atol=1e-7, err_msg=k)


def test_sharded_clip_world1_bitwise_against_replicated_clip(pg1):
    from tpu_dist_torch import optim
    from tpu_dist_torch.parallel import ZeroOptimizer
    ns = _ns()
    params = ns["params0"]()
    z = ZeroOptimizer(optim.SGD(lr=0.1), max_grad_norm=0.5)
    zs = z.init(params)
    h, zs = z.update(ns["grad_tree"](3), zs)
    got = h.wait()
    ref = ns["params0"]()
    g, _ = optim.clip_grad_norm(ns["grad_tree"](3), 0.5)
    opt = optim.SGD(lr=0.1)
    ref, _ = opt.update(g, opt.init(ref), ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("n", WORLDS)
def test_opt_state_bytes_divide_by_world(worlds, n):
    shard = sum(worlds[n][r]["zo|m|<f4"].nbytes for r in range(n))
    full = sum(np.asarray(v).size * 4 for v in _grad_tree(0).values())
    assert shard == full
    assert max(worlds[n][r]["zo|m|<f4"].nbytes for r in range(n)) <= \
        -(-full // n) + 4 * 4


def test_zero_state_errors(pg1):
    from tpu_dist_torch import optim
    from tpu_dist_torch.parallel import ZeroOptimizer, ZeroStateError
    ns = _ns()
    z = ZeroOptimizer(optim.SGD(lr=0.1))
    with pytest.raises(ZeroStateError, match="before init"):
        z.update(ns["grad_tree"](0), {})
    zs = z.init(ns["params0"]())
    with pytest.raises(ZeroStateError, match="not a ZeroOptimizer state"):
        z.update(ns["grad_tree"](0), {"shards": zs["shards"]})
    bad = dict(zs, meta=dict(zs["meta"], world=np.int64(2)))
    with pytest.raises(ZeroStateError, match="'world'"):
        z.update(ns["grad_tree"](0), bad)
    with pytest.raises(ZeroStateError, match="leaves"):
        z.update({"w1": torch.zeros(1001)}, zs)
    # the host ring's wire options are accepted now; error feedback keeps
    # a host residual a dtype group, and a reduce-scatter without the state
    # that holds it is refused
    for kw in (dict(comm_dtype="bfloat16"), dict(error_feedback=True),
               dict(gather_comm_dtype="bfloat16")):
        zk = ZeroOptimizer(optim.SGD(lr=0.1), **kw)
        st = zk.init(ns["params0"]())
        assert ("ef" in st) == bool(kw.get("error_feedback"))
        if "ef" in st:
            assert all(v.device.type == "cpu" and not v.any()
                       and v.shape == st["shards"][k].shape
                       for k, v in st["ef"].items())
            with pytest.raises(ZeroStateError, match="needs the current"):
                zk.reduce_scatter(ns["grad_tree"](0))


# ---------------------------------------------------------------------------
# the DDP's shard_optimizer and comm_dtype against the JAX DDP
# ---------------------------------------------------------------------------

def _hold_ddp(losses, params, want, cd):
    want_losses, want_params = want
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    expected = dict(load_jax_params(TorchLM(**MODEL, device="cpu"),
                                    want_params).named_parameters())
    rtol, atol = (1e-2, 1e-4) if cd else (1e-5, 2e-6)
    for k, v in expected.items():
        np.testing.assert_allclose(np.asarray(params[k]),
                                   v.detach().numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(DDP_CASES))
def test_ddp_world1_matches_jax_ddp(pg1, jax_ddp, name):
    x, y = _batch()
    feed = {"x": x, "y": y}
    feed.update({f"p|{p}|{k}": v for p, lv in jax_ddp[1].items()
                 for k, v in lv.items()})
    losses, params = _ns()["ddp_run"](pg1, 0, 1, DDP_CASES[name], feed,
                                      MODEL)
    _hold_ddp(losses, {k: v.numpy() for k, v in params.items()},
              jax_ddp[0][(1, name)], DDP_CASES[name][1])


@pytest.mark.parametrize("name", sorted(DDP_CASES))
def test_ddp_world2_matches_jax_ddp(worlds, jax_ddp, name):
    for r in range(2):
        res = worlds[2][r]
        params = {k[len(name) + 3:]: v for k, v in res.items()
                  if k.startswith(f"{name}|p|")}
        _hold_ddp(res[f"{name}|loss"], params, jax_ddp[0][(2, name)],
                  DDP_CASES[name][1])


@pytest.mark.parametrize("zero,dense", [("zero1", "dense"),
                                        ("zero1_bf16", "comm_bf16")])
def test_ddp_zero1_equals_replicated_bitwise_world2(worlds, zero, dense):
    for r in range(2):
        res = worlds[2][r]
        for k, v in res.items():
            if k.startswith(f"{dense}|p|"):
                assert res[f"{zero}|p|{k[len(dense) + 3:]}"].tobytes() == \
                    v.tobytes(), k


def test_ddp_zero1_equals_replicated_bitwise_world1(pg1):
    from tpu_dist_torch import nn as tnn_, optim
    from tpu_dist_torch.parallel import DistributedDataParallel
    x, y = (torch.from_numpy(a).long() for a in _batch())
    out = {}
    for shard in (False, True):
        ddp = DistributedDataParallel(
            TorchLM(**MODEL, device="cpu"), optimizer=optim.AdamW(lr=1e-2),
            loss_fn=tnn_.CrossEntropyLoss(), shard_optimizer=shard)
        state = ddp.init(seed=0)
        for _ in range(3):
            state, _ = ddp.train_step(state, x, y)
        out[shard] = state
    for k, v in out[False].params.items():
        assert torch.equal(v, out[True].params[k]), k
    flat = out[True].opt_state["m"]["flat"]
    n = sum(p.numel() for p in out[False].params.values())
    assert flat.numel() == n   # world 1: the whole (unpadded) vector


def test_train_repeat_equals_train_steps(pg1):
    from tpu_dist_torch import nn as tnn_, optim
    from tpu_dist_torch.parallel import DistributedDataParallel
    x, y = (torch.from_numpy(a).long() for a in _batch())
    res = []
    for repeat in (False, True):
        ddp = DistributedDataParallel(
            TorchLM(**MODEL, device="cpu"), optimizer=optim.SGD(lr=0.1),
            loss_fn=tnn_.CrossEntropyLoss(), shard_optimizer=repeat)
        state = ddp.init(seed=0)
        if repeat:
            state, m = ddp.train_repeat(state, x, y, 3)
            losses = m["loss"]
        else:
            losses = []
            for _ in range(3):
                state, m = ddp.train_step(state, x, y)
                losses.append(m["loss"])
            losses = torch.stack(losses)
        res.append((state, losses))
    assert torch.equal(res[0][1], res[1][1]) and res[1][1].shape == (3,)
    assert res[1][0].step == 3
    for k, v in res[0][0].params.items():
        assert torch.equal(v, res[1][0].params[k]), k


def test_state_shardings_restore_a_zero1_state(pg1, tmp_path):
    from tpu_dist_torch import nn as tnn_, optim
    from tpu_dist_torch.parallel import DistributedDataParallel, Placement
    ddp = DistributedDataParallel(
        TorchLM(**MODEL, device="cpu"), optimizer=optim.AdamW(lr=1e-2),
        loss_fn=tnn_.CrossEntropyLoss(), shard_optimizer=True)
    state = ddp.init(seed=0)
    x, y = (torch.from_numpy(a).long() for a in _batch())
    state, _ = ddp.train_step(state, x, y)
    sh = ddp.state_shardings(state)
    assert sh.opt_state["m"]["flat"] == Placement(torch.device("cpu"), True)
    assert sh.opt_state["step"].sharded is False
    assert not any(p.sharded for p in sh.params.values())
    tckpt.save(str(tmp_path), state, step=1)
    back = tckpt.restore(str(tmp_path), state, device=sh)
    assert torch.equal(back.opt_state["v"]["flat"],
                       state.opt_state["v"]["flat"])
    a, _ = ddp.train_step(back, x, y)
    b, _ = ddp.train_step(state, x, y)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_bench_zero_smoke():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    p = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_zero",
         "--device", "cpu", "--smoke"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    rows = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    by = {r["mode"]: r for r in rows}
    assert set(by) == {"replicated", "zero"} and all(
        r["world"] == 2 and r["smoke"] and r["value"] > 0 for r in rows)
    # half the replicated state, up to one element a leaf of each moment
    assert by["zero"]["opt_state_bytes_per_rank"] <= \
        by["replicated"]["opt_state_bytes_per_rank"] / 2 + 16 * 2 * 4


@pytest.mark.parametrize("model", ["lm", "convnet", "vit"])
def test_flat_order_is_the_jax_tree_order(model):
    """The DDP's flat vector follows ``jax.tree.leaves`` of the JAX
    parameter tree, not torch's registration order."""
    from tpu_dist.models import ConvNet as JConv
    from tpu_dist.models import vit_b_16 as jvit
    from tpu_dist_torch.interop import jax_leaf_order
    from tpu_dist_torch.models import ConvNet, vit_b_16
    jax_model, torch_model = {
        "lm": (lambda: JaxLM(**MODEL), lambda: TorchLM(**MODEL,
                                                       device="cpu")),
        "convnet": (JConv, lambda: ConvNet(device="cpu")),
        "vit": (lambda: jvit(num_classes=10),
                lambda: vit_b_16(num_classes=10, device="meta")),
    }[model]
    params = jax.eval_shape(jax_model().init, jax.random.key(0))
    want = [".".join(k.key for k in path if hasattr(k, "key") and k.key)
            for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    names = [k for k, _ in torch_model().named_parameters()]
    assert jax_leaf_order(names) == want
