"""The port's mesh pipeline (``tpu_dist_torch/parallel/pipeline.py``)
against the JAX package's (``tpu_dist/parallel/pipeline.py``) — the twin of
``tests/test_pipeline.py``, on gloo ranks.

The port runs one stage a rank; the worlds are launched once each (every
case inside one launch, the process group destroyed and made again between
meshes), as ``tests/test_torch_fsdp.py`` does: world 2 is ``pipe`` 2, world
4 ``pipe`` 4 and ``data`` 2 × ``pipe`` 2.  Every case starts from the JAX
package's ``model.init(key(0))`` (loaded through
``interop.load_jax_pipe_params``) and is held to:

- the JAX single-device step (``tests/test_pipeline.py``'s oracle) with the
  JAX tests' limits: loss ``rtol`` 1e-5 and parameters ``atol`` 2e-5 for
  SGD at M = 2 and 4 and data 2 × pipe 2, remat and the fused loss; AdamW
  over three steps ``rtol`` 1e-4 / ``atol`` 1e-3 (Adam amplifies
  accumulation-order noise where a gradient is near 0); 1F1B = GPipe at
  ``lr`` 1 to 2e-6 and both to the oracle to 1e-4; bf16 ``compute_dtype``
  loss ``rtol`` 0.05 with float32 parameters that move;
- JAX's ``PipelineParallel`` on the same mesh of virtual devices from the
  same packed weights (pipe 2, data 2 × pipe 2; GPipe and 1F1B): losses and
  packed parameters within ``tests/test_torch_expert_parallel.py``'s
  float32 limits (``rtol`` 1e-5, ``atol`` 1e-5);
- the layout: ``pack_params`` key for key with JAX's, each rank holding its
  stage's blocks plus the repl leaves (its AdamW moments 1/S of the
  stacked ones), the repl copies equal bit for bit across a pipe line;
- a checkpoint of a rank's state restored equal and training on;
- ``train_lm --parallel pp`` at world 4 against the JAX example's loop
  (``examples/train_lm.py:224-253``) on the same (2, 2) mesh.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.parallel import PipelineParallel as JaxPP

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB, DIM, DEPTH, HEADS, T = 31, 16, 4, 2, 12
LM = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
          max_seq_len=T)
TRAIN = dict(vocab=32, dim=32, depth=4, heads=4, seq_len=16, batch=8,
             lr=0.5, steps=3, microbatches=2)
TRAIN_ARGV = ["--parallel", "pp", "--device", "cpu", "--steps",
              str(TRAIN["steps"]), "--seq-len", str(TRAIN["seq_len"]),
              "--dim", str(TRAIN["dim"]), "--depth", str(TRAIN["depth"]),
              "--heads", str(TRAIN["heads"]), "--vocab", str(TRAIN["vocab"]),
              "--batch-size", str(TRAIN["batch"]), "--lr", str(TRAIN["lr"]),
              "--microbatches", str(TRAIN["microbatches"]),
              "--log-every", "1"]

# BatchNorm under the GSPMD step: ResNet-18 (10 classes) at 8x8, a global
# batch of 16, two SGD steps at data 2 against the JAX step on the batch
BN_STEPS, BN_BATCH, BN_HW = 2, 16, 8

# name: (axes, mesh, schedule, M, optimizer, lr, steps, batch, extra)
CASES = {
    2: {"m2": (["pipe"], [2], "gpipe", 2, "sgd", 0.1, 1, 4, {}),
        "m4": (["pipe"], [2], "gpipe", 4, "sgd", 0.1, 1, 8, {}),
        "adamw": (["pipe"], [2], "gpipe", 4, "adamw", 1e-2, 3, 8, {}),
        "remat": (["pipe"], [2], "gpipe", 4, "sgd", 0.1, 1, 8,
                  {"remat": True}),
        "bf16": (["pipe"], [2], "gpipe", 4, "sgd", 0.1, 1, 8,
                 {"bf16": True}),
        "fused": (["pipe"], [2], "gpipe", 4, "sgd", 0.1, 1, 8,
                  {"fused": True}),
        "gpipe_lr1": (["pipe"], [2], "gpipe", 8, "sgd", 1.0, 1, 16, {}),
        "1f1b_lr1": (["pipe"], [2], "1f1b", 8, "sgd", 1.0, 1, 16, {}),
        "1f1b_m4": (["pipe"], [2], "1f1b", 4, "sgd", 0.1, 1, 8, {}),
        "ckpt": (["pipe"], [2], "gpipe", 4, "adamw", 1e-3, 1, 8,
                 {"ckpt": True})},
    4: {"pipe4_gpipe": (["pipe"], [4], "gpipe", 8, "sgd", 1.0, 1, 16, {}),
        "pipe4_1f1b": (["pipe"], [4], "1f1b", 8, "sgd", 1.0, 1, 16, {}),
        "dp": (["data", "pipe"], [2, 2], "gpipe", 2, "sgd", 0.1, 1, 8, {}),
        "dp_gpipe_lr1": (["data", "pipe"], [2, 2], "gpipe", 8, "sgd", 1.0,
                         1, 16, {}),
        "dp_1f1b_lr1": (["data", "pipe"], [2, 2], "1f1b", 8, "sgd", 1.0,
                        1, 16, {})},
}

WORKER = textwrap.dedent("""
    import hashlib
    import json
    import os
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import checkpoint, dist, interop, nn, optim
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import PipelineParallel

    inp, out = sys.argv[1], sys.argv[2]
    cases, lm, train_argv, BN_STEPS = json.loads(sys.argv[3])
    torch.set_num_threads(1)
    d = dict(np.load(inp))
    res = {}

    def plain(prefix):
        t = {}
        for k, v in d.items():
            if k.startswith(prefix + "|"):
                _, path, leaf = k.split("|")
                t.setdefault(path, {})[leaf] = v
        return t

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree] if isinstance(tree, torch.Tensor) else []

    rank = None
    for name, (axes, mesh, sched, m, opt, lr, steps, batch, extra) in \\
            cases.items():
        pg = dist.init_process_group(backend="gloo", init_method="env://",
                                     device="cpu", axis_names=axes,
                                     mesh_shape=mesh)
        rank = pg.rank
        model = TransformerLM(**lm, device="cpu",
                              remat=bool(extra.get("remat")))
        optimizer = (optim.SGD(lr=lr) if opt == "sgd"
                     else optim.AdamW(lr=lr, weight_decay=0.1))
        pp = PipelineParallel(
            model, optimizer=optimizer,
            loss_fn=nn.CrossEntropyLoss(fused=bool(extra.get("fused"))),
            num_microbatches=m, schedule=sched,
            compute_dtype=torch.bfloat16 if extra.get("bf16") else None)
        # the JAX package's packed layout of the JAX init
        state = interop.load_jax_pipe_params(
            pp, pp.pack_params(plain("p")))
        x, y = d[f"x{batch}"], d[f"y{batch}"]
        rows = slice(None)
        if pp.data is not None:
            per = batch // pp.data.size
            rows = slice(pp.data.index * per, (pp.data.index + 1) * per)
        losses = []
        for _ in range(steps):
            state, met = pp.train_step(state, x[rows], y[rows])
            losses.append(float(met["loss"]))
        tag = f"{name}:r{rank}:"
        res[tag + "losses"] = np.array(losses)
        res[tag + "correct"] = np.array(int(met["correct"]))
        res[tag + "repl_digest"] = np.array(hashlib.sha256(b"".join(
            t.numpy().tobytes() for t in leaves(state.params["repl"])
        )).hexdigest())
        res[tag + "stage_elements"] = np.array(sum(
            t.numel() for t in leaves(state.params["stages"])))
        res[tag + "repl_elements"] = np.array(sum(
            t.numel() for t in leaves(state.params["repl"])))
        res[tag + "param_dtype"] = np.array(str(
            state.params["stages"]["0.ln1"]["weight"].dtype))
        if opt == "adamw":
            mom = state.opt_state["stages"]["m"]["0.ln1.weight"]
            res[tag + "moment_shape"] = np.array(mom.shape)
        if extra.get("ckpt"):
            root = os.path.join(out, "ckpt")
            checkpoint.save(root, state, step=state.step,
                            shard=(rank, pg.size()))
            back = checkpoint.restore(root, state,
                                      device=checkpoint.devices(state),
                                      shard=(rank, pg.size()))
            res[tag + "ckpt_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(leaves(state),
                                                  leaves(back))))
            res[tag + "ckpt_step"] = np.array(int(back.step))
            back, met = pp.train_step(back, x[rows], y[rows])
            res[tag + "ckpt_next"] = np.array([int(back.step),
                                               float(met["loss"])])
        whole = interop.jax_pipe_params(pp, state)
        if rank == 0:
            for a, tree in whole["repl"].items():
                for b, lv in tree.items():
                    for c, w in lv.items():
                        res[f"{name}:p|repl|{a}|{b}.{c}"] = w
            for a, lv in whole["stages"].items():
                for b, w in lv.items():
                    res[f"{name}:p|stages|{a}|{b}"] = w
        del pp, state, model
        dist.destroy_process_group()

    if "bx" in d:
        # BatchNorm under the GSPMD step: ResNet-18 at data 2
        from tpu_dist_torch.models import resnet18
        from tpu_dist_torch.parallel import make_gspmd_train_step
        pg = dist.init_process_group(backend="gloo", init_method="env://",
                                     device="cpu", axis_names=["data"],
                                     mesh_shape=[2])
        rank = pg.rank
        net = resnet18(num_classes=10, device="cpu")
        interop.load_jax_params(net, plain("b"))
        interop.load_jax_state(net, plain("bs"))
        opt = optim.SGD(lr=0.1)
        step = make_gspmd_train_step(net, nn.CrossEntropyLoss(), opt)
        params = dict(net.named_parameters())
        opt_state, mstate = opt.init(params), plain("bs")
        per = d["bx"].shape[0] // 2
        rows = slice(rank * per, (rank + 1) * per)
        x = torch.from_numpy(d["bx"][rows].transpose(0, 3, 1, 2).copy())
        y = torch.from_numpy(d["by"][rows]).long()
        losses = []
        for _ in range(BN_STEPS):
            params, opt_state, mstate, met = step(params, opt_state,
                                                  mstate, x, y)
            losses.append(float(met["loss"]))
        res["bn:losses"] = np.array(losses)
        for path, lv in interop.jax_params(net).items():
            for leaf, v in lv.items():
                res[f"bn:p|{path}|{leaf}"] = v
        for path, st in mstate.items():
            for leaf, v in st.items():
                res[f"bn:s|{path}|{leaf}"] = v.numpy()
        dist.destroy_process_group()

    if train_argv:
        from tpu_dist_torch.examples import train_lm
        from tpu_dist_torch.interop import load_jax_params
        tree = plain("t")
        r = train_lm.train(train_lm.parse_args(train_argv),
                           init_params=lambda m: load_jax_params(m, tree))
        res["train:losses"] = np.array(r["losses"])
        res["train:shape"] = np.array([r["batch"], r["seq_len"]])

    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
""")


def _jax_model(**kw):
    return JaxLM(**{**LM, **kw})


def _params0():
    return jax.tree.map(np.array, _jax_model().init(jax.random.key(0)))


def _data(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (batch, T)).astype(np.int32)
    y = rng.integers(0, VOCAB, (batch, T)).astype(np.int32)
    return x, y


def _unpack(packed):
    """A packed ``{"repl", "stages"}`` tree (stage leaves stacked over every
    stage) as the plain JAX tree."""
    s = next(iter(next(iter(packed["stages"].values())).values())).shape[0]
    k = DEPTH // s
    out = {"tok": packed["repl"]["embed"]["tok"],
           "pos": packed["repl"]["embed"]["pos"],
           "ln_f": packed["repl"]["head"]["ln_f"],
           "head": packed["repl"]["head"]["head"]}
    for canon, leaves in packed["stages"].items():
        j, _, suffix = canon.partition(".")
        for st in range(s):
            base = f"block{st * k + int(j)}"
            out[f"{base}.{suffix}" if suffix else base] = {
                n: v[st] for n, v in leaves.items()}
    return out


def _feed(world):
    feed = {f"p|{path}|{leaf}": w for path, lv in _params0().items()
            for leaf, w in lv.items()}
    for batch in (4, 8, 16):
        feed[f"x{batch}"], feed[f"y{batch}"] = _data(batch)
    if world == 2:
        params, state = _bn_start()
        feed.update({f"b|{path}|{leaf}": w for path, lv in params.items()
                     for leaf, w in lv.items()})
        feed.update({f"bs|{path}|{leaf}": w for path, lv in state.items()
                     for leaf, w in lv.items()})
        feed["bx"], feed["by"] = _bn_data()
    if world == 4:
        start = jax.tree.map(np.array, _train_model().init(
            jax.random.key(0)))
        feed.update({f"t|{path}|{leaf}": w for path, lv in start.items()
                     for leaf, w in lv.items()})
    return feed


def _bn_start():
    from tpu_dist.models import resnet18
    model = resnet18(num_classes=10)
    return (jax.tree.map(np.array, model.init(jax.random.key(0))),
            jax.tree.map(np.array, model.init_state()))


def _bn_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((BN_BATCH, BN_HW, BN_HW, 3)).astype(np.float32)
    y = rng.integers(0, 10, BN_BATCH).astype(np.int32)
    return x, y


def _train_model():
    return JaxLM(TRAIN["vocab"], dim=TRAIN["dim"], depth=TRAIN["depth"],
                 num_heads=TRAIN["heads"], max_seq_len=TRAIN["seq_len"])


def _launch(world, tmp):
    """Start every case of ``world`` on gloo ranks under the port's
    launcher."""
    np.savez(tmp / "in.npz", **_feed(world))
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         f"--nproc_per_node={world}", str(tmp / "worker.py"),
         str(tmp / "in.npz"), str(tmp),
         json.dumps([CASES[world], LM, TRAIN_ARGV if world == 4 else [],
                     BN_STEPS])],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's ranks' results; the two worlds run at once."""
    tmps = {w: tmp_path_factory.mktemp(f"pp{w}") for w in CASES}
    procs = {w: _launch(w, tmps[w]) for w in CASES}
    out = {}
    try:
        for w, proc in procs.items():
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-6000:]
            out[w] = [dict(np.load(tmps[w] / f"r{r}.npz"))
                      for r in range(w)]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _world(name):
    return next(w for w in CASES if name in CASES[w])


def _port(ranks, name):
    """``(each rank's losses, the updated plain JAX tree)`` of a case."""
    rs = ranks[_world(name)]
    packed = {"repl": {}, "stages": {}}
    for k, v in rs[0].items():
        if not k.startswith(name + ":p|"):
            continue
        _, top, a, b = k.split("|")
        if top == "repl":
            mod, leaf = b.split(".")
            packed["repl"].setdefault(a, {}).setdefault(mod, {})[leaf] = v
        else:
            packed["stages"].setdefault(a, {})[b] = v
    return [r[f"{name}:r{i}:losses"] for i, r in enumerate(rs)], packed


_OPTS = {"sgd": lambda lr: joptim.SGD(lr=lr),
         "adamw": lambda lr: joptim.AdamW(lr=lr, weight_decay=0.1)}


@functools.lru_cache(maxsize=None)
def _reference_step(opt_name, lr, batch, steps=1):
    """Plain single-device training step(s) from the JAX init on
    ``_data(batch)`` — the JAX tests' oracle."""
    opt = _OPTS[opt_name](lr)
    x, y = _data(batch)
    model = _jax_model()
    params = jax.tree.map(jnp.asarray, _params0())
    ce = jnn.CrossEntropyLoss()
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_of(p):
            logits = model.apply(p, x)
            return ce(logits.reshape(-1, VOCAB), y.reshape(-1))
        loss, grads = jax.value_and_grad(loss_of)(params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    loss = None
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, x, y)
    return jax.tree.map(np.asarray, params), float(loss)


def _close(got_plain, want_plain, **tol):
    assert set(got_plain) == set(want_plain)
    for path, leaves in want_plain.items():
        for leaf, a in leaves.items():
            np.testing.assert_allclose(np.asarray(got_plain[path][leaf]),
                                       np.asarray(a), err_msg=f"{path}.{leaf}",
                                       **tol)


# ---------------------------------------------------------------------------
# (a) against the single-device step (tests/test_pipeline.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batch", [("m2", 4), ("m4", 8), ("dp", 8),
                                        ("remat", 8), ("fused", 8),
                                        ("1f1b_m4", 8)])
def test_pp_matches_single_device(ranks, name, batch):
    """GPipe at M = 2 and 4 (pipe 2), data 2 × pipe 2, remat, the fused
    loss (K1's plain version here) and 1F1B at M = 4 against the plain
    step."""
    losses, packed = _port(ranks, name)
    want, loss = _reference_step("sgd", 0.1, batch)
    for r in losses:
        np.testing.assert_allclose(r[-1], loss, rtol=1e-5)
    _close(_unpack(packed), want, atol=2e-5)


def test_pp_multi_step_adamw(ranks):
    """Three AdamW steps through the pipeline == three plain steps."""
    losses, packed = _port(ranks, "adamw")
    want, loss = _reference_step("adamw", 1e-2, 8, steps=3)
    for r in losses:
        assert len(r) == 3
        np.testing.assert_allclose(r[-1], loss, rtol=1e-4)
    _close(_unpack(packed), want, atol=1e-3)


@pytest.mark.parametrize("gpipe,one_f", [
    ("gpipe_lr1", "1f1b_lr1"), ("pipe4_gpipe", "pipe4_1f1b"),
    ("dp_gpipe_lr1", "dp_1f1b_lr1")], ids=["pipe2", "pipe4", "data2_pipe2"])
def test_1f1b_matches_gpipe_and_single_device(ranks, gpipe, one_f):
    """1F1B (the hand schedule with the recompute backward) is GPipe's
    math: at SGD lr 1 the parameter deltas are the gradients."""
    lg, pg_ = _port(ranks, gpipe)
    l1, p1 = _port(ranks, one_f)
    for a, b in zip(lg, l1):
        assert a[-1] == pytest.approx(b[-1], abs=1e-6)
    g, o = _unpack(pg_), _unpack(p1)
    _close(o, g, atol=2e-6, rtol=2e-6)
    want, loss = _reference_step("sgd", 1.0, 16)
    assert l1[0][-1] == pytest.approx(loss, abs=1e-5)
    _close(o, want, atol=1e-4, rtol=1e-4)


def test_pp_bf16_compute_dtype(ranks):
    """bf16 forward, backward and hops over float32 masters: the loss near
    the float32 step's, the parameters float32 and moved."""
    losses, packed = _port(ranks, "bf16")
    _, loss = _reference_step("sgd", 0.1, 8)
    for r in losses:
        np.testing.assert_allclose(r[-1], loss, rtol=0.05)
    for i, r in enumerate(ranks[2]):
        assert str(r[f"bf16:r{i}:param_dtype"]) == "torch.float32"
    got, start = _unpack(packed), _params0()
    assert max(float(np.abs(got[p][k] - start[p][k]).max())
               for p in got for k in got[p]) > 0


# ---------------------------------------------------------------------------
# (b) the layout and the state
# ---------------------------------------------------------------------------

def _fake_group(s):
    """A stand-in for the port's group with a pipe axis of ``s`` ranks,
    rank 0 (``pack_params``/``unpack_params`` need no communication)."""
    import torch
    from tpu_dist_torch.dist import AxisGroup
    return types.SimpleNamespace(
        axis_names=("pipe",), mesh_shape=(s,), backend=None,
        device=torch.device("cpu"),
        axis_group=lambda n: AxisGroup("pipe", s, 0, tuple(range(s))))


def _jax_pp(mesh_axes, shape, **kw):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    group = types.SimpleNamespace(mesh=Mesh(devs, mesh_axes))
    return JaxPP(_jax_model(), group=group, **kw)


def test_pack_unpack_roundtrip_matches_jax_layout():
    """``pack_params`` gives JAX's packed tree key for key and bit for bit
    (4 stages), and ``unpack_params`` inverts it."""
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import PipelineParallel
    import torch
    params = jax.tree.map(np.array, _jax_model().init(jax.random.key(3)))
    jpp = _jax_pp(("pipe",), (4,), optimizer=joptim.SGD(lr=0.1),
                  loss_fn=jnn.CrossEntropyLoss())
    want = jax.tree.map(np.asarray, jpp.pack_params(params))
    tpp = PipelineParallel(TransformerLM(**LM, device="cpu"),
                           group=_fake_group(4))
    got = tpp.pack_params(params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    back = tpp.unpack_params(got)
    assert set(back) == set(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert torch.is_tensor(tpp.pack_params(
        {p: {k: torch.from_numpy(v) for k, v in lv.items()}
         for p, lv in params.items()})["stages"]["0.ln1"]["weight"])


def test_each_rank_holds_its_stage_and_its_moments(ranks):
    """A rank holds its blocks_per_stage blocks (1/S of the stacked trunk)
    and the whole repl leaves; its AdamW moments are its stage row."""
    params = _params0()
    trunk = sum(a.size for p, lv in params.items() if p.startswith("block")
                for a in lv.values())
    repl = sum(a.size for p, lv in params.items()
               if not p.startswith("block") for a in lv.values())
    for i, r in enumerate(ranks[2]):
        assert int(r[f"adamw:r{i}:stage_elements"]) == trunk // 2
        assert int(r[f"adamw:r{i}:repl_elements"]) == repl
        assert tuple(r[f"adamw:r{i}:moment_shape"]) == (1, DIM)
    for i, r in enumerate(ranks[4]):
        assert int(r[f"pipe4_gpipe:r{i}:stage_elements"]) == trunk // 4


@pytest.mark.parametrize("world", [2, 4])
def test_repl_copies_equal_bit_for_bit(ranks, world):
    """The embedding and head stay equal bit for bit on every rank (the
    owner's gradient broadcast over the pipe line, one all-reduce over
    data)."""
    for name in CASES[world]:
        digests = {str(r[f"{name}:r{i}:repl_digest"])
                   for i, r in enumerate(ranks[world])}
        assert len(digests) == 1, name


def test_pipeline_checkpoint_roundtrip(ranks):
    """A rank's trained state saved as its shard and restored equal, at its
    step; the restored state trains on."""
    for i, r in enumerate(ranks[2]):
        assert bool(r[f"ckpt:r{i}:ckpt_equal"])
        assert int(r[f"ckpt:r{i}:ckpt_step"]) == 1
        step, loss = r[f"ckpt:r{i}:ckpt_next"]
        assert int(step) == 2 and np.isfinite(loss)


@pytest.mark.parametrize("case", ["depth", "no_pipe_axis", "three_d",
                                  "sequence_axis", "schedule"])
def test_refusals_name_the_jax_messages(case):
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import PipelineParallel
    group, kw, lm = _fake_group(2), {}, dict(LM)
    match = {"depth": "divisible", "no_pipe_axis": "has no 'pipe' axis",
             "three_d": "data_axis= explicitly",
             "sequence_axis": "sequence_axis",
             "schedule": "schedule must be"}[case]
    if case == "depth":
        lm["depth"] = 3
    elif case == "no_pipe_axis":
        group.axis_names = ("data",)
    elif case == "three_d":
        group.axis_names = ("data", "pipe", "model")
        group.mesh_shape = (1, 2, 1)
    elif case == "schedule":
        kw["schedule"] = "zb"
    model = TransformerLM(**lm, device="cpu")
    if case == "sequence_axis":
        model.sequence_axis = "seq"
    with pytest.raises(ValueError, match=match):
        PipelineParallel(model, group=group, **kw)


# ---------------------------------------------------------------------------
# (c) against the JAX package's PipelineParallel on the same mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,axes,shape,sched,m,lr,batch", [
    ("m4", ("pipe",), (2,), "gpipe", 4, 0.1, 8),
    ("1f1b_lr1", ("pipe",), (2,), "1f1b", 8, 1.0, 16),
    ("dp", ("data", "pipe"), (2, 2), "gpipe", 2, 0.1, 8)])
def test_port_matches_jax_pipeline(ranks, name, axes, shape, sched, m, lr,
                                   batch):
    """The port's ranks against JAX's PipelineParallel on as many virtual
    devices, from the same packed weights: losses and the packed trees,
    key for key, within the float32 limits (rtol 1e-5, atol 1e-5)."""
    jpp = _jax_pp(axes, shape, optimizer=joptim.SGD(lr=lr),
                  loss_fn=jnn.CrossEntropyLoss(), num_microbatches=m,
                  schedule=sched, donate=False)
    state = jpp.init(seed=0)
    x, y = _data(batch)
    if "data" in axes:
        sh = NamedSharding(jpp.group.mesh, P("data"))
        x, y = jax.device_put(x, sh), jax.device_put(y, sh)
    new, metrics = jpp.train_step(state, x, y)
    want = jax.tree.map(np.asarray, jax.device_get(new.params))
    losses, got = _port(ranks, name)
    for r in losses:
        np.testing.assert_allclose(r[-1], float(metrics["loss"]),
                                   rtol=1e-5)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-5, atol=1e-5), got, want)


def _jax_train_lm_pp():
    """The JAX example's ``--parallel pp`` loop (examples/train_lm.py:
    224-253) over a (2, 2) ``("data", "pipe")`` mesh of four virtual
    devices: each step's loss."""
    v, sl = TRAIN["vocab"], TRAIN["seq_len"]
    rng = np.random.default_rng(0)
    perm = rng.permutation(v)
    jpp = JaxPP(_train_model(), optimizer=joptim.SGD(lr=TRAIN["lr"]),
                loss_fn=jnn.CrossEntropyLoss(),
                num_microbatches=TRAIN["microbatches"],
                group=types.SimpleNamespace(mesh=Mesh(
                    np.array(jax.devices()[:4]).reshape(2, 2),
                    ("data", "pipe"))))
    state = jpp.init(seed=0)
    m = jpp.num_microbatches
    batch = max(TRAIN["batch"] // (2 * m), 1) * 2 * m
    bsh = NamedSharding(jpp.group.mesh, P("data"))
    losses = []
    for _ in range(TRAIN["steps"]):
        x = rng.integers(0, v, (batch, sl))
        state, metrics = jpp.train_step(state, jax.device_put(x, bsh),
                                        jax.device_put(perm[x], bsh))
        losses.append(float(metrics["loss"]))
    return batch, losses


def test_train_lm_pp_world4_matches_jax(ranks):
    """``train_lm --parallel pp`` at world 4 (data 2 × pipe 2, train_lm's
    mesh rule) from the JAX example's initial weights: every step's loss
    against the JAX example's loop on the same mesh."""
    batch, want = _jax_train_lm_pp()
    for r in ranks[4]:
        assert tuple(r["train:shape"]) == (batch, TRAIN["seq_len"])
        np.testing.assert_allclose(r["train:losses"], want, rtol=1e-5)
    assert want[-1] < want[0]


# ---------------------------------------------------------------------------
# (d) BatchNorm under the GSPMD step
# ---------------------------------------------------------------------------

def test_batchnorm_under_the_gspmd_step_matches_jax(ranks):
    """ResNet-18 at data 2 (two gloo ranks, the statistics over the global
    batch) against JAX's ``make_gspmd_train_step`` on the whole batch, two
    SGD steps: losses rtol 1e-5, running statistics atol 1e-5, parameters
    atol 1e-4 (a ReLU input within rounding of 0 may flip in one of two
    float32 runs)."""
    from tpu_dist import parallel as jparallel
    from tpu_dist.models import resnet18
    model = resnet18(num_classes=10)
    params0, state0 = _bn_start()
    params = jax.tree.map(jnp.asarray, params0)
    mstate = jax.tree.map(jnp.asarray, state0)
    opt = joptim.SGD(lr=0.1)
    opt_state = opt.init(params)
    step = jparallel.make_gspmd_train_step(model, jnn.CrossEntropyLoss(),
                                           opt, donate=False)
    x, y = _bn_data()
    losses = []
    for _ in range(BN_STEPS):
        params, opt_state, mstate, m = step(params, opt_state, mstate, x, y)
        losses.append(float(m["loss"]))
    for r in ranks[2]:
        np.testing.assert_allclose(r["bn:losses"], losses, rtol=1e-5)
        for path, st in mstate.items():
            for leaf, v in st.items():
                np.testing.assert_allclose(r[f"bn:s|{path}|{leaf}"],
                                           np.asarray(v), atol=1e-5,
                                           err_msg=f"{path}.{leaf}")
        for path, lv in params.items():
            for leaf, v in lv.items():
                np.testing.assert_allclose(r[f"bn:p|{path}|{leaf}"],
                                           np.asarray(v), atol=1e-4,
                                           err_msg=f"{path}.{leaf}")
    # the statistics moved off their initial values
    assert any(float(np.abs(np.asarray(v) - state0[p][k]).max()) > 1e-3
               for p, st in mstate.items() for k, v in st.items())
