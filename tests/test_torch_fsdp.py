"""The port's FSDP (``parallel/fsdp.py`` and the GSPMD step under an fsdp
axis) against the JAX package's.

- ``fsdp_specs`` gives the JAX package's specs, leaf for leaf: the largest
  divisible dim, ``min_size``, the indivisible leaves
  (``tests/test_fsdp.py:28``), and composed after ``TRANSFORMER_TP_RULES``
  on a ``("data", "model")`` and a ``("data", "fsdp", "model")`` mesh
  (``tests/test_fsdp.py:126-149``), with the rules as a ``PartitionRules``
  and as a rule table.
- ``fsdp_shard`` gives each rank the slice the JAX placement puts on its
  device, bit for bit (1-D, eight virtual devices); under the tp rules each
  slice has the JAX placement's shard shape.
- The GSPMD step on gloo ranks against the JAX package's single-device
  step: 1-D FSDP over ``data`` at world 2 (AdamW, ``min_size=256``, the
  ``tests/test_fsdp.py:44`` cell: loss 1e-5 relative, parameters 2e-5
  absolute, its limits), then 14 more steps on a learnable task (the loss
  falls more than twofold, ``:100``); ``data 1 × fsdp 2 × model 2`` and
  ``data 2 × fsdp 2`` at world 4 (SGD, ``min_size=128``, the ``:149``
  cell, the same limits).  Each rank holds its shard of every sharded leaf
  and of its optimizer state: 1/(fsdp × model) of the leaf's elements.
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
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.parallel import fsdp as jfsdp
from tpu_dist.parallel import gspmd as jgspmd
from tpu_dist.parallel import rules as jrules
from tpu_dist_torch import dist as tdist
from tpu_dist_torch.parallel import fsdp as tfsdp
from tpu_dist_torch.parallel import gspmd as tgspmd
from tpu_dist_torch.parallel import rules as trules
from tpu_dist_torch.parallel.mesh import Mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
T = 16
ONE_D = dict(vocab_size=33, dim=64, depth=2, num_heads=4, max_seq_len=T)
THREE_D = dict(vocab_size=32, dim=32, depth=1, num_heads=2, max_seq_len=T)
ATOL = 2e-5
# world: [(case, axis_names, mesh_shape, model kwargs, fsdp axis, min_size)]
CASES = {2: [("1d", ("data",), (2,), ONE_D, "data", 256)],
         4: [("3d", ("data", "fsdp", "model"), (1, 2, 2), THREE_D, "fsdp",
              128),
             ("dp_fsdp", ("data", "fsdp"), (2, 2), THREE_D, "fsdp", 128)]}
TRAIN_STEPS = 15

WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import jax_params, shard_jax_params
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import make_gspmd_train_step

    inp, out = sys.argv[1], sys.argv[2]
    cases, train_steps = json.loads(sys.argv[3])
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

    for name, axes, mesh, lm, axis, min_size in cases:
        pg = dist.init_process_group(
            init_method="env://", device="cpu", timeout=120,
            axis_names=axes, mesh_shape=mesh)
        rank = pg.rank
        data = pg.axis_group("data")
        model = TransformerLM(**lm, device="cpu",
                              model_axis="model" if "model" in axes
                              else None)
        params = shard_jax_params(model, tree(name), axis=axis,
                                  min_size=min_size)
        v = lm["vocab_size"]
        ce = nn.CrossEntropyLoss()
        opt = (optim.AdamW(lr=1e-3) if name == "1d" else optim.SGD(lr=0.1))
        step = make_gspmd_train_step(
            model, lambda lg, y: ce(lg.reshape(-1, v), y.reshape(-1)), opt)
        opt_state = opt.init(params)
        res[f"{name}:coords"] = np.array(
            [pg.axis_group(a).index for a in axes])
        for k, t in params.items():
            res[f"{name}:shape:{k}"] = np.array(t.shape)
        for k, t in opt_state.get("m", {}).items():
            res[f"{name}:mshape:{k}"] = np.array(t.shape)
        per = d[name + "_x"].shape[0] // data.size
        rows = slice(data.index * per, (data.index + 1) * per)
        x = torch.from_numpy(d[name + "_x"][rows])
        y = torch.from_numpy(d[name + "_y"][rows])
        params, opt_state, m = step(params, opt_state, x, y)
        res[f"{name}:loss"] = np.array(float(m["loss"]))
        for path, leaves in jax_params(model, params).items():
            for leaf, a in leaves.items():
                res[f"{name}:p|{path}|{leaf}"] = a
        if name == "1d":
            # the learnable task of tests/test_fsdp.py:100
            opt = optim.AdamW(lr=3e-3)
            params = shard_jax_params(model, tree(name), axis=axis,
                                      min_size=min_size)
            opt_state = opt.init(params)
            step = make_gspmd_train_step(
                model, lambda lg, y: ce(lg.reshape(-1, v), y.reshape(-1)),
                opt)
            yy = (x + 1) % v
            losses = []
            for _ in range(train_steps):
                params, opt_state, m = step(params, opt_state, x, yy)
                losses.append(float(m["loss"]))
            res["1d:train_losses"] = np.array(losses)
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
""")


def _jax_mesh(axes, shape):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _port_mesh(axes, shape):
    return Mesh(tuple(axes), tuple(shape), tuple(range(int(np.prod(shape)))))


def _spec_tree(specs):
    return jax.tree.map(tuple, specs,
                        is_leaf=lambda s: isinstance(s, jax.sharding.
                                                     PartitionSpec))


@functools.lru_cache(maxsize=None)
def _tree(name):
    lm = {"1d": ONE_D, "3d": THREE_D, "dp_fsdp": THREE_D}[name]
    return jax.tree.map(np.array, JaxLM(**lm).init(jax.random.key(0)))


# ---------------------------------------------------------------------------
# the specs and the slices
# ---------------------------------------------------------------------------

def test_fsdp_specs_shard_largest_divisible_dim():
    tree = {"w": np.zeros((48, 8)), "tall": np.zeros((7, 4096)),
            "bias": np.zeros((4096,)), "tiny": np.zeros((64,)),
            "odd": np.zeros((7, 9))}
    want = _spec_tree(jfsdp.fsdp_specs(
        jax.tree.map(jnp.asarray, tree), _jax_mesh(("data",), (8,)),
        axis="data", min_size=256))
    got = tfsdp.fsdp_specs(tree, _port_mesh(("data",), (8,)), axis="data",
                           min_size=256)
    assert got == want
    assert got["w"] == ("data", None) and got["tall"] == (None, "data")
    assert got["tiny"] == () and got["odd"] == ()


@pytest.mark.parametrize("rules_as", ["partition_rules", "rule_table"])
@pytest.mark.parametrize("axes,shape,axis", [
    (("data", "model"), (2, 4), "data"),
    (("data", "fsdp", "model"), (2, 2, 2), "fsdp")])
def test_fsdp_specs_compose_with_the_tp_rules(axes, shape, axis, rules_as):
    tree = jax.tree.map(np.array, JaxLM(
        vocab_size=32, dim=32, depth=1, num_heads=4,
        max_seq_len=T).init(jax.random.key(0)))
    jr = (jgspmd.TRANSFORMER_TP_RULES if rules_as == "partition_rules"
          else jrules.DEFAULT_RULES)
    tr = (tgspmd.TRANSFORMER_TP_RULES if rules_as == "partition_rules"
          else trules.DEFAULT_RULES)
    want = _spec_tree(jfsdp.fsdp_specs(jax.tree.map(jnp.asarray, tree),
                                       _jax_mesh(axes, shape), axis=axis,
                                       min_size=128, rules=jr))
    got = tfsdp.fsdp_specs(tree, _port_mesh(axes, shape), axis=axis,
                           min_size=128, rules=tr)
    assert got == want
    # 2-D weight sharding: the tp axis kept, the fsdp axis gained
    assert got["block0.attn"]["qkv_weight"] == (axis, "model")


class _Rank:
    """A mesh stand-in at one set of coordinates (``axis_group`` only)."""

    def __init__(self, axes, shape, coords):
        self._lines = {a: tdist.AxisGroup(a, n, i, ())
                       for a, n, i in zip(axes, shape, coords)}

    def axis_group(self, axis):
        return self._lines[axis]


def test_fsdp_shard_is_the_jax_placement():
    tree = _tree("1d")
    mesh = _jax_mesh(("data",), (8,))
    placed = jfsdp.fsdp_shard(jax.tree.map(jnp.asarray, tree), mesh,
                              min_size=256)
    for i, dev in enumerate(mesh.devices.reshape(-1)):
        got = tfsdp.fsdp_shard(tree, _Rank(("data",), (8,), (i,)),
                               min_size=256)
        for path, leaves in placed.items():
            for leaf, arr in leaves.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device == dev)
                np.testing.assert_array_equal(got[path][leaf],
                                              np.asarray(shard.data))
    assert got["tok"]["weight"].shape == (33, 64 // 8)


def test_fsdp_shard_under_the_tp_rules_has_the_jax_shard_shapes():
    tree = _tree("3d")
    axes, shape = ("data", "fsdp", "model"), (2, 2, 2)
    mesh = _jax_mesh(axes, shape)
    specs = jfsdp.fsdp_specs(jgspmd.shard_pytree(
        jax.tree.map(jnp.asarray, tree), mesh, jgspmd.TRANSFORMER_TP_RULES),
        mesh, axis="fsdp", min_size=128)
    got = tfsdp.fsdp_shard(tree, _Rank(axes, shape, (1, 1, 1)),
                           axis="fsdp", min_size=128,
                           rules=tgspmd.TRANSFORMER_TP_RULES)
    for path, leaves in tree.items():
        for leaf, a in leaves.items():
            want = NamedSharding(mesh, specs[path][leaf]).shard_shape(
                a.shape)
            assert got[path][leaf].shape == want, (path, leaf)


# ---------------------------------------------------------------------------
# the step under an fsdp axis
# ---------------------------------------------------------------------------

def _batch(name):
    rng = np.random.default_rng(0)
    lm = {"1d": ONE_D, "3d": THREE_D, "dp_fsdp": THREE_D}[name]
    b = 16 if name == "1d" else 8
    return (rng.integers(0, lm["vocab_size"], (b, T)),
            rng.integers(0, lm["vocab_size"], (b, T)))


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """The JAX package's single-device step (test_fsdp.py's oracle)."""
    lm = {"1d": ONE_D, "3d": THREE_D, "dp_fsdp": THREE_D}[name]
    model = JaxLM(**lm)
    ce = jnn.CrossEntropyLoss()
    v = lm["vocab_size"]
    opt = joptim.AdamW(lr=1e-3) if name == "1d" else joptim.SGD(lr=0.1)
    params = jax.tree.map(jnp.array, _tree(name))
    x, y = (jnp.asarray(a) for a in _batch(name))
    loss, grads = jax.value_and_grad(
        lambda p: ce(model.apply(p, x).reshape(-1, v), y.reshape(-1)))(
        params)
    new, _ = opt.update(grads, opt.init(params), params)
    return float(loss), jax.tree.map(np.asarray, new)


def _spawn(world, tmp):
    feed = {}
    for name, *_ in CASES[world]:
        feed.update({f"{name}|{p}|{k}": v for p, lv in _tree(name).items()
                     for k, v in lv.items()})
        feed[name + "_x"], feed[name + "_y"] = _batch(name)
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
         str(tmp / "in.npz"), str(tmp),
         json.dumps([CASES[world], TRAIN_STEPS])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: _spawn(w, tmp_path_factory.mktemp(f"fsdp{w}"))
            for w in sorted(CASES)}


ALL = [(w, c) for w in sorted(CASES) for c in CASES[w]]


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_fsdp_step_matches_the_single_device_step(world, case, ranks):
    name = case[0]
    loss, want = _jax_step(name)
    for r in ranks[world]:
        np.testing.assert_allclose(float(r[f"{name}:loss"]), loss,
                                   rtol=1e-5)
        for path, leaves in want.items():
            for leaf, a in leaves.items():
                np.testing.assert_allclose(r[f"{name}:p|{path}|{leaf}"], a,
                                           atol=ATOL,
                                           err_msg=f"{path}.{leaf}")
    start = _tree(name)
    assert max(float(np.abs(want[p][k] - start[p][k]).max())
               for p in want for k in want[p]) > 1e-4


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_each_rank_holds_its_shard(world, case, ranks):
    """Every leaf the JAX placement splits is split here the same way:
    1/(fsdp × model) of its elements a rank (its Adam moments too)."""
    name, axes, shape, lm, axis, min_size = case
    tree = _tree(name)
    rules = (jgspmd.TRANSFORMER_TP_RULES if "model" in axes else None)
    specs = jfsdp.fsdp_specs(jax.tree.map(jnp.asarray, tree),
                             _jax_mesh(axes, shape), axis=axis,
                             min_size=min_size, rules=rules)
    split = 0
    for path, leaves in tree.items():
        for leaf, a in leaves.items():
            spec = tuple(specs[path][leaf])
            ways = int(np.prod([dict(zip(axes, shape))[ax] for ax in spec
                                if ax is not None]))
            split += ways > 1
            for r in ranks[world]:
                got = r[f"{name}:shape:{path}.{leaf}"]
                assert int(np.prod(got)) * ways == a.size, (path, leaf)
                if name == "1d":
                    np.testing.assert_array_equal(
                        r[f"{name}:mshape:{path}.{leaf}"], got)
    assert split >= 5


def test_fsdp_multi_step_trains(ranks):
    for r in ranks[2]:
        losses = r["1d:train_losses"]
        assert losses[0] / losses[-1] > 2, losses
