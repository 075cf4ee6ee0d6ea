"""The port's sequence-parallel slice against the JAX package's.

- ``TransformerLM(sequence_axis="seq", mode=...)``: the forward on two gloo
  ranks equals the JAX package's ``test_sequence_parallel_matches_dense``
  case (tests/test_transformer.py:60) over two virtual devices, at its
  tolerance (5e-4 relative, 5e-5 absolute);
- ``train_lm --parallel sp --device cpu`` at world 4 (data 2 × seq 2): three
  steps equal the JAX example's sp step (examples/train_lm.py:179-222) over
  four virtual devices from the same initial parameters, in loss (1e-5
  relative) and parameters (1e-5 relative + 2e-6 absolute, the dense
  slice's tolerances in tests/test_torch_transformer_lm.py: float32 with the
  same terms summed in another order);
- ``init_process_group(axis_names=, mesh_shape=)``: the row-major groups;
- a KV-cache decode with ``sequence_axis`` raises.

One module-scoped spawn a world size runs every port case."""

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
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM

REPO = pathlib.Path(__file__).resolve().parent.parent
MODES = ("ring", "ulysses")
FWD_KW = dict(vocab_size=50, dim=32, depth=2, num_heads=8, max_seq_len=128)
TRAIN = dict(vocab=32, dim=32, depth=2, heads=4, seq_len=32, batch=4,
             steps=3, lr=0.5)
TRAIN_ARGV = ["--parallel", "sp", "--device", "cpu",
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
    from tpu_dist_torch import dist

    rank, world, ports, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    json.loads(sys.argv[3]), sys.argv[4],
                                    sys.argv[5])
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

    def init(port, **kw):
        return dist.init_process_group(
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, device="cpu", timeout=120, **kw)

    # the mesh: each axis's size, this rank's index and its line's ranks
    shapes = {2: [(2,), (1, 2), (2, 1)], 4: [(4,), (2, 2), (1, 4)]}[world]
    for i, shape in enumerate(shapes):
        names = ("data", "seq")[:len(shape)]
        pg = init(ports.pop(), axis_names=names, mesh_shape=shape)
        for name in names:
            a = pg.axis_group(name)
            res[f"mesh{i}:{name}"] = np.array([a.size, a.index, *a.ranks])
            if a.size > 1:  # the group reduces over exactly its line
                x = torch.tensor([float(rank)])
                torch.distributed.all_reduce(x, group=a.group)
                res[f"mesh{i}:{name}:sum"] = x.numpy()
        dist.destroy_process_group()

    if world == 2:
        # the sp model's forward on this rank's half of the tokens
        from tpu_dist_torch.interop import load_jax_params
        from tpu_dist_torch.models import TransformerLM
        init(ports.pop(), axis_names=("seq",), mesh_shape=(2,))
        kw = json.loads(sys.argv[6])
        idx = torch.from_numpy(d["idx"])
        t = idx.shape[1] // 2
        for mode in ("ring", "ulysses"):
            model = TransformerLM(**kw, sequence_axis="seq", mode=mode,
                                  device="cpu")
            load_jax_params(model, tree("fwd"))
            with torch.no_grad():
                res[f"fwd:{mode}"] = model(
                    idx[:, rank * t:(rank + 1) * t]).numpy()
        dist.destroy_process_group()
    else:
        from tpu_dist_torch.examples import train_lm
        from tpu_dist_torch.interop import load_jax_params
        from tpu_dist_torch.parallel import DistributedDataParallel as DDP
        draw = DDP.init
        for mode in ("ring", "ulysses"):
            os.environ.update(MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(ports.pop()),
                              WORLD_SIZE=str(world), RANK=str(rank))
            args = train_lm.parse_args(json.loads(sys.argv[6])
                                       + ["--sp-mode", mode])

            def init_from_jax(self, seed=0, start=tree(f"train_{mode}")):
                # the JAX run's initial parameters, written into the
                # state's own tensors (the module's)
                state = draw(self, seed)
                load_jax_params(self.module, start)
                return state

            DDP.init = init_from_jax
            r = train_lm.train(args)
            res[f"train:{mode}:losses"] = np.array(r["losses"])
            res[f"train:{mode}:shape"] = np.array([r["batch"], r["seq_len"]])
            for k, v in r["state"].params.items():
                res[f"train:{mode}:p:{k}"] = v.detach().numpy()
    np.savez(out, **res)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(prefix, tree):
    return {f"{prefix}|{p}|{k}": np.asarray(v) for p, lv in tree.items()
            for k, v in lv.items()}


def _tokens():
    # the JAX test's _tokens(): b=2, t=64, vocab=50, seed=0
    return np.random.default_rng(0).integers(0, 50, (2, 64))


def _spawn(world, tmp, feed, extra):
    np.savez(tmp / "in.npz", **feed)
    ports = [_free_port() for _ in range(6)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), repr(ports),
         str(tmp / "in.npz"), str(tmp / f"r{r}.npz"), extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


def _jax_params(model):
    return jax.tree.map(np.asarray, model.init(jax.random.key(0)))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The mesh checks and the sp forward on two gloo ranks; the JAX
    parameters they start from."""
    import json
    params = _jax_params(JaxLM(**FWD_KW))
    feed = {"idx": _tokens(), **_flat("fwd", params)}
    ranks = _spawn(2, tmp_path_factory.mktemp("sp2"), feed,
                   json.dumps(FWD_KW))
    return params, ranks


def _jax_sp_train(mode):
    """The JAX example's ``--parallel sp`` loop (examples/train_lm.py:
    179-222) over a (2, 2) mesh of four virtual devices: initial params,
    each step's loss, final params."""
    v, sl, bs = TRAIN["vocab"], TRAIN["seq_len"], TRAIN["batch"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "seq"))
    rng = np.random.default_rng(0)
    perm = rng.permutation(v)
    model = JaxLM(v, dim=TRAIN["dim"], depth=TRAIN["depth"],
                  num_heads=TRAIN["heads"], max_seq_len=sl,
                  sequence_axis="seq", mode=mode)
    params = model.init(jax.random.key(0))
    params0 = jax.tree.map(np.asarray, params)
    opt = joptim.SGD(lr=TRAIN["lr"])
    opt_state = opt.init(params)
    ce = jnn.CrossEntropyLoss()

    def local_step(params, opt_state, x, y):
        def loss_local(p):
            logits = model.apply(p, x)
            loss = ce(logits.reshape(-1, v), y.reshape(-1))
            return lax.pmean(lax.pmean(loss, "seq"), "data")

        loss, grads = jax.value_and_grad(loss_local)(params)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, loss

    pspec = jax.tree.map(lambda _: P(), params)
    ospec = jax.tree.map(lambda _: P(), opt_state)
    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(pspec, ospec, P("data", "seq"), P("data", "seq")),
        out_specs=(pspec, ospec, P())))
    losses = []
    for _ in range(TRAIN["steps"]):
        x = rng.integers(0, v, (bs, sl))
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x),
                                       jnp.asarray(perm[x]))
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Three sp steps a mode on four gloo ranks, and the JAX package's."""
    import json
    want = {mode: _jax_sp_train(mode) for mode in MODES}
    feed = {}
    for mode in MODES:
        feed.update(_flat(f"train_{mode}", want[mode][0]))
    ranks = _spawn(4, tmp_path_factory.mktemp("sp4"), feed,
                   json.dumps(TRAIN_ARGV))
    return want, ranks


@pytest.mark.parametrize("mode", MODES)
def test_sp_forward_matches_jax_at_seq_world2(world2, mode):
    """``test_sequence_parallel_matches_dense``'s case: the port's two
    ranks' logits against the JAX sharded model over two devices, and
    against the JAX dense model."""
    params, ranks = world2
    idx = _tokens()
    sharded = JaxLM(**FWD_KW, sequence_axis="seq", mode=mode)
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    pspec = jax.tree.map(lambda _: P(), params)
    want = jax.jit(jax.shard_map(
        lambda p, i: sharded.apply(p, i), mesh=mesh,
        in_specs=(pspec, P(None, "seq")), out_specs=P(None, "seq")))(
            params, jnp.asarray(idx))
    dense = JaxLM(**FWD_KW).apply(params, jnp.asarray(idx))
    got = np.concatenate([r[f"fwd:{mode}"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("mode", MODES)
def test_train_lm_sp_world4_matches_jax(world4, mode):
    """Three ``--parallel sp`` steps on a (data 2 × seq 2) mesh: every
    rank's losses and parameters against the JAX example's step."""
    want, ranks = world4
    _, losses_j, params_j = want[mode]
    def port_layout(tree):
        model = TorchLM(TRAIN["vocab"], dim=TRAIN["dim"],
                        depth=TRAIN["depth"], num_heads=TRAIN["heads"],
                        max_seq_len=TRAIN["seq_len"], device="cpu")
        return {k: p.detach().numpy() for k, p in
                load_jax_params(model, tree).named_parameters()}

    ref = port_layout(params_j)
    for r in ranks:
        assert tuple(r[f"train:{mode}:shape"]) == (TRAIN["batch"],
                                                   TRAIN["seq_len"])
        np.testing.assert_allclose(r[f"train:{mode}:losses"], losses_j,
                                   rtol=1e-5)
        for k, want_p in ref.items():
            np.testing.assert_allclose(r[f"train:{mode}:p:{k}"], want_p,
                                       rtol=1e-5, atol=2e-6, err_msg=k)
    # the step moved the parameters: the check above is not vacuous
    p0 = port_layout(want[mode][0])
    assert max(float(np.abs(ref[k] - p0[k]).max()) for k in ref) > 1e-3


def _axis(res, i, name):
    size, index, *ranks = (int(x) for x in res[f"mesh{i}:{name}"])
    return size, index, tuple(ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_axes_are_row_major_groups(world, world2, world4):
    """Rank r of mesh_shape sits at np.unravel_index(r, mesh_shape); each
    axis's group is its line of ranks, and an all-reduce over the group sums
    exactly that line."""
    ranks = world2[1] if world == 2 else world4[1]
    shapes = {2: [(2,), (1, 2), (2, 1)], 4: [(4,), (2, 2), (1, 4)]}[world]
    for i, shape in enumerate(shapes):
        names = ("data", "seq")[:len(shape)]
        grid = np.arange(world).reshape(shape)
        for r, res in enumerate(ranks):
            coords = np.unravel_index(r, shape)
            for a, name in enumerate(names):
                size, index, line = _axis(res, i, name)
                sel = list(coords)
                sel[a] = slice(None)
                want = tuple(int(x) for x in grid[tuple(sel)])
                assert (size, index, line) == (shape[a], coords[a], want)
                if size > 1:
                    assert float(res[f"mesh{i}:{name}:sum"][0]) == sum(want)


def test_mesh_at_world1_and_without_a_group():
    from tpu_dist_torch import dist
    assert dist.axis_group("seq") == dist.AxisGroup("seq", 1, 0, (0,))
    pg = dist.init_process_group(device="cpu", axis_names=("data", "seq"),
                                 mesh_shape=(1, 1))
    try:
        assert pg.axis_group("seq").size == 1
        assert pg.axis_group("seq").group is None
        with pytest.raises(ValueError, match="no mesh axis"):
            pg.axis_group("model")
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="does not cover"):
        dist.init_process_group(device="cpu", mesh_shape=(2,))
    assert not dist.is_initialized()


def test_kv_cache_decode_with_sequence_axis_raises():
    """The JAX model refuses init_cache with sequence_axis
    (tests/test_transformer.py:202); so do the port's model and layer."""
    model = TorchLM(vocab_size=50, dim=32, depth=1, num_heads=4,
                    max_seq_len=64, sequence_axis="seq", device="cpu")
    with pytest.raises(ValueError, match="sequence_axis"):
        model.init_cache(batch=1)
    with pytest.raises(ValueError, match="sequence_axis"):
        model.generate(torch.zeros(1, 4, dtype=torch.long), 2)
    attn = model.block0.attn
    cache = TorchLM(vocab_size=50, dim=32, depth=1, num_heads=4,
                    max_seq_len=64, device="cpu").init_cache(1)
    with pytest.raises(ValueError, match="sequence_axis"):
        attn(torch.zeros(1, 4, 32), cache=cache["block0.attn"])
    jax_model = JaxLM(vocab_size=50, dim=32, depth=1, num_heads=4,
                      max_seq_len=64, sequence_axis="seq")
    with pytest.raises(ValueError, match="sequence_axis"):
        jax_model.init_cache(batch=1)


def test_sp_model_has_the_dense_models_parameters():
    """load_jax_params takes the JAX dense model's tree into the sp model,
    leaf for leaf; at world 1 (no group) the sp forward is the dense one
    (the ring's one block through the plain flash version, the dense model
    through the softmax composition: float32 round-off apart)."""
    params = _jax_params(JaxLM(**FWD_KW))
    sp = load_jax_params(TorchLM(**FWD_KW, sequence_axis="seq",
                                 device="cpu"), params)
    dense = load_jax_params(TorchLM(**FWD_KW, device="cpu"), params)
    assert [k for k, _ in sp.named_parameters()] == \
        [k for k, _ in dense.named_parameters()]
    idx = torch.from_numpy(_tokens())
    with torch.no_grad():
        np.testing.assert_allclose(sp(idx).numpy(), dense(idx).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_sp_lm_benchmark_matches_world1_on_cpu(dtype, tol):
    """benchmarks/sp_lm.py's three runs at a tiny size on gloo: world 4 (data
    2 × seq 2) in each mode trains on world 1's global batch with its
    gradient, so the losses agree to round-off: float32's, or bf16's (2e-2:
    a few bf16 steps of a loss near 3.5, the ring merging its blocks in
    another order).  In bf16 a causal ring's first rank skips its second
    hop and keeps a bf16 accumulator where its neighbour's turns float32;
    the shifts must still match."""
    from tpu_dist_torch.benchmarks import sp_lm
    tiny = ["--seq-len", "32", "--batch-size", "2", "--dim", "32",
            "--depth", "1", "--heads", "4", "--vocab", "32", "--lr", "0.5",
            "--log-every", "1000", "--compute-dtype", dtype]
    res = sp_lm.run(4, 2, "cpu", tiny)
    assert res["ring"]["batch"] == res["world1"]["batch"] == 2
    assert res["ring"]["seq_len"] == 32
    assert max(res["max_loss_rel_diff"].values()) < tol, res


def test_option_and_mode_errors():
    from tpu_dist_torch import nn
    with pytest.raises(ValueError, match="sequence-parallel mode"):
        nn.MultiheadSelfAttention(32, 4, mode="tree", device="cpu")
    with pytest.raises(ValueError, match="even head_dim"):
        nn.MultiheadSelfAttention(36, 4, rope=True, device="cpu")
    from tpu_dist_torch.examples import train_lm
    with pytest.raises(ValueError, match="generate"):
        train_lm.train(train_lm.parse_args(
            ["--parallel", "sp", "--device", "cpu", "--generate", "4"]))
    assert train_lm.sp_mesh(1) == (1, 1)
    assert train_lm.sp_mesh(4) == (2, 2)
    assert train_lm.sp_mesh(8) == (2, 4)
    assert train_lm.sp_mesh(3) == (1, 3)
