"""The port's tensor-parallel mesh path against the JAX package's.

- ``mesh_shape_for`` and ``get_mesh`` (``parallel/mesh.py``): the JAX
  package's factorizations and errors.
- The GSPMD step on a ``("data", "model")`` mesh of gloo ranks, at data 1 ×
  model 2 (world 2) and data 2 × model 2 (world 4): the tiny LM split by
  ``TRANSFORMER_TP_RULES`` (``TransformerLM(model_axis="model")``) from the
  JAX ``init(key(0))`` tree, two SGD-with-momentum steps, against the JAX
  package's GSPMD step on a mesh of the same shape over conftest's virtual
  CPU devices (``tests/test_gspmd.py:62``'s cell): losses 1e-5 relative,
  the gathered parameters 1e-5 relative plus 2e-6 absolute (test_gspmd's
  own limits against the single-device step are 2e-3 and 2e-5).
- The loss on logits split on the vocab (K1f/K1b's plain versions on the
  CPU, fused and unfused) against the full-vocab plain loss: the loss and
  the gathered logits gradient within 1e-6 relative plus 1e-7 absolute,
  with ignored rows.
- Greedy ``generate`` under the tp placement (float32 and int8 KV caches)
  equals the JAX package's single-device ``generate`` token for token
  (test_gspmd.py:124); the ViT under the same rules, one step against the
  JAX ViT's single-device step (test_gspmd.py:182), the same limits.
- Each rank's fused-qkv rows are its ``[q | k | v]`` heads: the transpose
  of ``spans_for``'s slice of the JAX leaf, which ``shard_pytree`` gives.
- ``train_lm --parallel tp`` at world 4 (data 2 × model 2): three steps
  equal the JAX example's tp step (examples/train_lm.py:297-333, run as
  its single-device global step) from the same initial parameters, losses
  1e-5 relative and parameters 1e-5 relative plus 2e-6 absolute (world 1:
  ``tests/test_torch_ddp_accum.py``).

One launch a world size (the port's launcher, gloo ranks) runs every port
case.
"""

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

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.models import VisionTransformer as JaxViT
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tpu_dist.parallel import gspmd as jgspmd
from tpu_dist.parallel import mesh as jmesh
from tpu_dist.parallel import rules as jrules
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import mesh as tmesh

REPO = pathlib.Path(__file__).resolve().parent.parent
MESHES = {2: (1, 2), 4: (2, 2)}          # world: (data, model)
LM = dict(vocab_size=64, dim=32, depth=2, num_heads=4, max_seq_len=32)
B, T = 4, 16
STEP_RTOL, STEP_ATOL = 1e-5, 2e-6
VIT = dict(image_size=16, patch_size=8, num_layers=2, num_heads=4,
           hidden_dim=32, num_classes=8)
TRAIN = dict(vocab=32, dim=32, depth=2, heads=4, seq_len=16, batch=4,
             steps=3, lr=0.5)
TRAIN_ARGV = ["--parallel", "tp", "--device", "cpu",
              "--steps", str(TRAIN["steps"]), "--seq-len",
              str(TRAIN["seq_len"]), "--batch-size", str(TRAIN["batch"]),
              "--dim", str(TRAIN["dim"]), "--depth", str(TRAIN["depth"]),
              "--heads", str(TRAIN["heads"]), "--vocab", str(TRAIN["vocab"]),
              "--lr", str(TRAIN["lr"]), "--log-every", "1"]

WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import jax_params, load_jax_params
    from tpu_dist_torch.models import TransformerLM, VisionTransformer
    from tpu_dist_torch.nn.tensor_parallel import (ShardedLogits,
                                                   vocab_parallel_cross_entropy)
    from tpu_dist_torch.parallel import (TRANSFORMER_TP_RULES,
                                         make_gspmd_train_step, shard_pytree)

    inp, out = sys.argv[1], sys.argv[2]
    mesh, lm, vit, train_argv = json.loads(sys.argv[3])
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
        axis_names=("data", "model"), mesh_shape=mesh)
    rank = pg.rank
    data, line = pg.axis_group("data"), pg.axis_group("model")
    res["coords"] = np.array([data.index, line.index])
    per = d["x"].shape[0] // data.size
    rows = slice(data.index * per, (data.index + 1) * per)

    # the tp step: two SGD-with-momentum steps from the JAX init
    model = TransformerLM(**lm, device="cpu", model_axis="model")
    load_jax_params(model, tree("lm"))
    v = lm["vocab_size"]
    ce = nn.CrossEntropyLoss()
    opt = optim.SGD(lr=0.1, momentum=0.9)
    step = make_gspmd_train_step(
        model, lambda lg, y: ce(lg.reshape(-1, v), y.reshape(-1)), opt)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    x, y = torch.from_numpy(d["x"][rows]), torch.from_numpy(d["y"][rows])
    losses, correct = [], []
    for _ in range(2):
        params, opt_state, m = step(params, opt_state, x, y)
        losses.append(float(m["loss"]))
        correct.append(int(m["correct"]))
    res["step:losses"] = np.array(losses)
    res["step:correct"] = np.array(correct)
    res["step:qkv_local"] = model.block0.attn.qkv_weight.detach().numpy()
    for path, leaves in jax_params(model).items():
        for leaf, a in leaves.items():
            res[f"step:p|{path}|{leaf}"] = a
    res["slice|block0.attn|qkv_weight"] = shard_pytree(
        tree("lm"), pg, TRANSFORMER_TP_RULES)["block0.attn"]["qkv_weight"]

    # the loss on logits split on the vocab, fused and not
    full = torch.from_numpy(d["ce_logits"])
    vl = full.shape[-1] // line.size
    for fused in (True, False):
        local = full[:, line.index * vl:(line.index + 1) * vl].clone()
        local.requires_grad_(True)
        loss = vocab_parallel_cross_entropy(
            ShardedLogits(local, line, full.shape[-1]),
            torch.from_numpy(d["ce_labels"]), fused=fused)
        loss.backward()
        res[f"ce:{fused}:loss"] = loss.detach().numpy()
        res[f"ce:{fused}:grad"] = local.grad.numpy()
        res[f"ce:{fused}:argmax"] = ShardedLogits(
            local.detach(), line, full.shape[-1]).argmax(-1).numpy()

    # greedy generate under the tp placement, float32 and int8 caches
    gen = TransformerLM(**lm, device="cpu", model_axis="model")
    load_jax_params(gen, tree("lm"))
    prompt = torch.from_numpy(d["prompt"])
    res["gen:f32"] = gen.generate(prompt, 8).numpy()
    res["gen:i8"] = gen.generate(prompt, 8, cache_dtype=torch.int8).numpy()
    res["gen:cache_heads"] = np.array(
        gen.init_cache(1, 4)["block0.attn"]["k"].shape[2])

    # the ViT under the same rules: one step
    model = VisionTransformer(**vit, device="cpu", model_axis="model")
    load_jax_params(model, tree("vit"))
    ce2 = nn.CrossEntropyLoss()
    opt = optim.SGD(lr=0.1)
    step = make_gspmd_train_step(model, lambda lg, t: ce2(lg, t), opt)
    params = dict(model.named_parameters())
    vper = d["vit_x"].shape[0] // data.size
    vrows = slice(data.index * vper, (data.index + 1) * vper)
    params, _, m = step(params, opt.init(params),
                        torch.from_numpy(d["vit_x"][vrows]),
                        torch.from_numpy(d["vit_y"][vrows]))
    res["vit:loss"] = np.array(float(m["loss"]))
    for path, leaves in jax_params(model).items():
        for leaf, a in leaves.items():
            res[f"vit:p|{path}|{leaf}"] = a
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
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
""")


def _flat(prefix, tree):
    return {f"{prefix}|{p}|{k}": np.asarray(v) for p, lv in tree.items()
            for k, v in lv.items()}


def _spawn(world, tmp, feed, extra):
    """The worker on ``world`` gloo ranks under the port's launcher; each
    rank's results."""
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
        cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the inputs and the JAX references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm_tree():
    return jax.tree.map(np.array, JaxLM(**LM).init(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _vit_tree():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.array, JaxViT(**VIT).init(jax.random.key(0)))
    # a non-zero head, so that the step moves it (test_gspmd's)
    params["head"]["weight"] = (rng.normal(
        size=params["head"]["weight"].shape) * 0.02).astype(np.float32)
    return params


def _inputs():
    rng = np.random.default_rng(0)
    feed = {"x": rng.integers(0, LM["vocab_size"], (B, T)),
            "y": rng.integers(0, LM["vocab_size"], (B, T)),
            "prompt": np.random.default_rng(0).integers(
                0, LM["vocab_size"], (4, 8)),
            "ce_logits": (rng.standard_normal((12, LM["vocab_size"]))
                          * 3).astype(np.float32),
            "ce_labels": np.where(np.arange(12) % 5 == 4, -100,
                                  rng.integers(0, LM["vocab_size"], 12)),
            "vit_x": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
            "vit_y": rng.integers(0, VIT["num_classes"], 4)}
    feed["ce_logits"][3, 5] = feed["ce_logits"][3].max() + 1.0
    feed["ce_logits"][3, 40] = feed["ce_logits"][3, 5]   # a tie across ranks
    return feed


def _feed():
    feed = _inputs()
    feed["vit_x"] = feed["vit_x"].transpose(0, 3, 1, 2).copy()   # NCHW
    feed.update(_flat("lm", _lm_tree()))
    feed.update(_flat("vit", _vit_tree()))
    return feed


@functools.lru_cache(maxsize=None)
def _jax_mesh_steps(world):
    """The JAX package's GSPMD tp step, twice, on a (data, model) mesh of
    ``MESHES[world]`` virtual devices (test_gspmd.py:62's cell)."""
    mesh = JaxMesh(np.array(jax.devices()[:world]).reshape(MESHES[world]),
                   ("data", "model"))
    model = JaxLM(**LM)
    ce = jnn.CrossEntropyLoss()
    v = LM["vocab_size"]
    opt = joptim.SGD(lr=0.1, momentum=0.9)
    params = jgspmd.shard_pytree(jax.tree.map(jnp.array, _lm_tree()), mesh,
                                 jgspmd.TRANSFORMER_TP_RULES)
    opt_state = opt.init(params)
    step = jgspmd.make_gspmd_train_step(
        model, lambda lg, y: ce(lg.reshape(-1, v), y.reshape(-1)), opt,
        donate=False)
    bsh = NamedSharding(mesh, P("data", None))
    inp = _inputs()
    x, y = (jax.device_put(jnp.asarray(inp[k]), bsh) for k in ("x", "y"))
    losses = []
    for _ in range(2):
        params, opt_state, m = step(params, opt_state, x, y)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, jax.device_get(params))


@functools.lru_cache(maxsize=None)
def _jax_vit_step():
    model = JaxViT(**VIT)
    ce = jnn.CrossEntropyLoss()
    opt = joptim.SGD(lr=0.1)
    params = jax.tree.map(jnp.array, _vit_tree())
    inp = _inputs()
    x, y = jnp.asarray(inp["vit_x"]), jnp.asarray(inp["vit_y"])
    loss, grads = jax.value_and_grad(
        lambda p: ce(model.apply(p, x), y))(params)
    params, _ = opt.update(grads, opt.init(params), params)
    return float(loss), jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_generate():
    prompt = jnp.asarray(_inputs()["prompt"])
    model = JaxLM(**LM)
    params = jax.tree.map(jnp.array, _lm_tree())
    return (np.asarray(model.generate(params, prompt, max_new_tokens=8)),
            np.asarray(model.generate(params, prompt, max_new_tokens=8,
                                      cache_dtype=jnp.int8)))


@functools.lru_cache(maxsize=None)
def _jax_tp_train():
    """The JAX example's ``--parallel tp`` loop (examples/train_lm.py:
    297-333) at world 4 (dp 2 × tp 2: heads and batch rounded as it rounds
    them), run as the single-device global step its mesh program equals:
    initial params, each step's loss, final params."""
    v, sl = TRAIN["vocab"], TRAIN["seq_len"]
    dp, tp = 2, 2
    heads = max(TRAIN["heads"] // tp, 1) * tp
    batch = max(TRAIN["batch"] // dp, 1) * dp
    rng = np.random.default_rng(0)
    perm = rng.permutation(v)
    model = JaxLM(v, dim=TRAIN["dim"], depth=TRAIN["depth"],
                  num_heads=heads, max_seq_len=sl)
    ce = jnn.CrossEntropyLoss()
    opt = joptim.SGD(lr=TRAIN["lr"])
    params0 = jax.tree.map(np.array, model.init(jax.random.key(0)))
    params = jax.tree.map(jnp.array, params0)
    opt_state = opt.init(params)
    losses = []
    for _ in range(TRAIN["steps"]):
        x = rng.integers(0, v, (batch, sl))
        y = perm[x]

        def objective(p):
            return ce(model.apply(p, x).reshape(-1, v), y.reshape(-1))
        loss, grads = jax.value_and_grad(objective)(params)
        params, opt_state = opt.update(grads, opt_state, params)
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("tp2"), _feed(),
                  [json.dumps([MESHES[2], LM, VIT, []])])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    feed = {**_feed(), **_flat("train", _jax_tp_train()[0])}
    return _spawn(4, tmp_path_factory.mktemp("tp4"), feed,
                  [json.dumps([MESHES[4], LM, VIT, TRAIN_ARGV])])


def _ranks(world, world2, world4):
    return world2 if world == 2 else world4


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,mp", [(8, 2), (8, 4), (4, 1), (6, 3)])
@pytest.mark.parametrize("table", ["default", "all_none"])
def test_mesh_shape_for_is_the_jax_packages(world, mp, table):
    rules = (dict(jrules.DEFAULT_RULES) if table == "default"
             else {a: None for a in jrules.DEFAULT_RULES})
    assert tmesh.mesh_shape_for(rules, world, mp) == \
        jmesh.mesh_shape_for(rules, world, mp)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.mesh_shape_for(dict(jrules.DEFAULT_RULES), 5, 2)


def test_get_mesh_shapes_and_errors():
    for dp, mp in ((None, 2), (2, 2), (4, 1), (None, 1)):
        want = jmesh.get_mesh(dp=dp, mp=mp, devices=jax.devices()[:8])
        got = tmesh.get_mesh(dp=dp, mp=mp, ranks=range(8))
        assert got.shape == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
    assert tmesh.get_mesh().shape == {"data": 1, "model": 1}
    for kw, match in (({"mp": 3}, "not divisible"),
                      ({"dp": 4, "mp": 4}, "need 16 devices")):
        with pytest.raises(ValueError, match=match):
            jmesh.get_mesh(devices=jax.devices()[:8], **kw)
        with pytest.raises(ValueError, match=match):
            tmesh.get_mesh(ranks=range(8), **kw)


# ---------------------------------------------------------------------------
# the GSPMD step on a model axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_step_matches_the_jax_mesh_step(world, world2, world4):
    losses, want = _jax_mesh_steps(world)
    for r in _ranks(world, world2, world4):
        np.testing.assert_allclose(r["step:losses"], losses, rtol=1e-5)
        for path, leaves in want.items():
            for leaf, a in leaves.items():
                np.testing.assert_allclose(
                    r[f"step:p|{path}|{leaf}"], a, rtol=STEP_RTOL,
                    atol=STEP_ATOL, err_msg=f"{path}.{leaf}")
    # the steps moved the parameters: the check above is not vacuous
    start = _lm_tree()
    assert max(float(np.abs(want[p][k] - start[p][k]).max())
               for p in want for k in want[p]) > 1e-3


@pytest.mark.parametrize("world", sorted(MESHES))
def test_vocab_parallel_loss_and_gradient(world, world2, world4):
    inp = _inputs()
    logits = torch.from_numpy(inp["ce_logits"]).requires_grad_(True)
    labels = torch.from_numpy(inp["ce_labels"])
    want = torch.nn.functional.cross_entropy(logits, labels,
                                             ignore_index=-100)
    want.backward()
    dp, tp = MESHES[world]
    vl = LM["vocab_size"] // tp
    ranks = _ranks(world, world2, world4)
    for fused in (True, False):
        grads = [None] * tp
        for r in ranks:
            np.testing.assert_allclose(r[f"ce:{fused}:loss"],
                                       want.detach().numpy(), rtol=1e-6)
            grads[int(r["coords"][1])] = r[f"ce:{fused}:grad"]
            # the global argmax, the lowest column on a tie across ranks
            np.testing.assert_array_equal(
                r[f"ce:{fused}:argmax"], inp["ce_logits"].argmax(-1))
        assert all(g.shape == (12, vl) for g in grads)
        np.testing.assert_allclose(np.concatenate(grads, -1),
                                   logits.grad.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_generate_under_tp_is_the_single_devices(world, world2, world4):
    f32, i8 = _jax_generate()
    for r in _ranks(world, world2, world4):
        np.testing.assert_array_equal(r["gen:f32"], f32)
        np.testing.assert_array_equal(r["gen:i8"], i8)
        # the KV cache holds this rank's heads
        assert int(r["gen:cache_heads"]) == LM["num_heads"] // MESHES[
            world][1]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_vit_under_tp_matches_the_single_device_step(world, world2, world4):
    loss, want = _jax_vit_step()
    for r in _ranks(world, world2, world4):
        np.testing.assert_allclose(float(r["vit:loss"]), loss, rtol=1e-5)
        for path, leaves in want.items():
            for leaf, a in leaves.items():
                np.testing.assert_allclose(
                    r[f"vit:p|{path}|{leaf}"], a, rtol=STEP_RTOL,
                    atol=STEP_ATOL, err_msg=f"{path}.{leaf}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_qkv_rows_are_the_ranks_heads(world, world2, world4):
    """A rank's fused-qkv rows are [q_r | k_r | v_r]: the transpose of
    ``spans_for``'s slice of the JAX leaf, and ``shard_pytree``'s."""
    tree = _lm_tree()
    qkv = tree["block0.attn"]["qkv_weight"]
    tp = MESHES[world][1]
    axes = {"qkv3": 3, "heads": LM["num_heads"],
            "head_dim": LM["dim"] // LM["num_heads"], "embed": LM["dim"]}
    for r in _ranks(world, world2, world4):
        m = int(r["coords"][1])
        want = jrules.shard_leaf(qkv, jrules.spans_for(
            "block0.attn", "qkv_weight", qkv.shape, axes, m, tp))
        np.testing.assert_array_equal(r["slice|block0.attn|qkv_weight"],
                                      want)
        # the step's initial rows were these; q, k and v each 1/tp
        hl = LM["dim"] // tp
        cols = np.concatenate([np.arange(j * LM["dim"] + m * hl,
                                         j * LM["dim"] + (m + 1) * hl)
                               for j in range(3)])
        np.testing.assert_array_equal(want, qkv[:, cols])
        assert r["step:qkv_local"].shape == (3 * hl, LM["dim"])


def _reassemble(parts, full_shape, key):
    """A leaf whole from its model-line slices (port layout): the fused
    qkv rows in three groups, anything else one."""
    if parts[0].shape == tuple(full_shape):
        return parts[0]
    dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, full_shape))
               if a != b)
    groups = 3 if key.rpartition(".")[2] in ("qkv_weight", "qkv_bias") \
        else 1
    split = [np.split(p, groups, axis=dim) for p in parts]
    return np.concatenate([s[g] for g in range(groups) for s in split],
                          axis=dim)


def test_train_lm_tp_world4_matches_jax(world4):
    params0, losses_j, params_j = _jax_tp_train()
    full = TorchLM(TRAIN["vocab"], dim=TRAIN["dim"], depth=TRAIN["depth"],
                   num_heads=TRAIN["heads"], max_seq_len=TRAIN["seq_len"],
                   device="cpu")
    ref = {k: p.detach().numpy().copy() for k, p in
           load_jax_params(full, params_j).named_parameters()}
    start = {k: p.detach().numpy().copy() for k, p in
             load_jax_params(full, params0).named_parameters()}
    by_line = {}
    for r in world4:
        di, mi = (int(c) for c in r["coords"])
        assert tuple(r["train:shape"]) == (TRAIN["batch"], TRAIN["seq_len"])
        np.testing.assert_allclose(r["train:losses"], losses_j, rtol=1e-5)
        by_line.setdefault(di, {})[mi] = r
    for di, line in by_line.items():
        for k, want in ref.items():
            got = _reassemble([line[m][f"train:p:{k}"] for m in sorted(line)],
                              want.shape, k)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6,
                                       err_msg=k)
    assert max(float(np.abs(ref[k] - start[k]).max()) for k in ref) > 1e-3
