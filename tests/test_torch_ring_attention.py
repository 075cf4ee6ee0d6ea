"""The port's ring attention and Ulysses against the JAX package's.

The port runs as gloo ranks at worlds 2 and 4 (one spawn of ``world``
processes a world size, module-scoped, running every case); the JAX package
runs ``shard_map`` over as many of conftest's virtual CPU devices, its flash
impl through the Pallas kernel in interpret mode.  Inputs are the same numpy
arrays.  Tolerances are tests/test_ring_attention.py's: the forward 2e-4
relative + 2e-5 absolute (line 50), the gradients 5e-3 + 5e-4 (line 70),
bf16 5e-2 (line 111).  The one-process ring of the hop functions, which
chip_smoke.py runs on the card, must equal each gloo rank bit for bit: both
run the same float32 operations on the same shards in the same order."""

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
from jax.sharding import Mesh, PartitionSpec as P

from tpu_dist.nn.attention import scaled_dot_product_attention as jax_sdpa
from tpu_dist.parallel.ring_attention import (
    ring_self_attention as jax_ring, ulysses_self_attention as jax_ulysses)

REPO = pathlib.Path(__file__).resolve().parent.parent
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-3, atol=5e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
B, T, H, D = 2, 32, 4, 8

# (name, fn, impl, causal, dtype, grads): the cases every rank runs
CASES = [(f"ring-{impl}-{causal}", "ring", impl, causal, "float32", True)
         for impl in ("dense", "flash") for causal in (False, True)]
# bf16 with grads: under a causal mask a rank that skips hops holds a
# bf16 accumulator where its neighbour's is float32, and the shifts must
# still match
CASES += [(f"ring-flash-{causal}-bf16", "ring", "flash", causal, "bfloat16",
           True) for causal in (False, True)]
CASES += [(f"ulysses-{causal}", "ulysses", None, causal, "float32", True)
          for causal in (False, True)]

WORKER = textwrap.dedent("""
    import ast
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist
    from tpu_dist_torch.parallel import (ring_self_attention,
                                         ulysses_self_attention)
    from tpu_dist_torch.parallel.ring_attention import ring_one_process

    rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    cases = ast.literal_eval(sys.argv[6])
    d = dict(np.load(inp))
    dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, device="cpu",
                            axis_names=("seq",), mesh_shape=(world,),
                            timeout=120)
    tl = d["q"].shape[1] // world
    mine = slice(rank * tl, (rank + 1) * tl)
    res = {}
    for name, fn, impl, causal, dtype, grads in cases:
        dt = getattr(torch, dtype)
        full = [torch.from_numpy(d[x]).to(dt) for x in ("q", "k", "v", "do")]
        q, k, v = (x[:, mine].clone().requires_grad_(True) for x in full[:3])
        f = ring_self_attention if fn == "ring" else ulysses_self_attention
        o = f(q, k, v, "seq", causal=causal, impl=impl)
        res[f"{name}:o"] = o.detach().float().numpy()
        if grads:
            g = torch.autograd.grad(o, (q, k, v), full[3][:, mine])
            for x, gx in zip("qkv", g):
                res[f"{name}:d{x}"] = gx.float().numpy()
        if fn == "ring":
            # the one-process ring over all shards: this rank's share
            shards = [list(x.chunk(world, 1)) for x in full]
            got = ring_one_process(*shards[:3], causal, impl,
                                   dos=shards[3] if grads else None)
            outs, gs = got if grads else (got, None)
            same = torch.equal(outs[rank], o.detach())
            if grads:
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(gs[rank], g))
            res[f"{name}:one_process_equal"] = np.array(same)
    # heads not divisible by the axis: Ulysses refuses
    x = torch.zeros(1, 4, 3, 8)
    try:
        ulysses_self_attention(x, x, x, "seq")
        res["indivisible_raised"] = np.array(False)
    except ValueError as e:
        res["indivisible_raised"] = np.array("divisible" in str(e))
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(0)
    return {x: rng.standard_normal((B, T, H, D)).astype(np.float32)
            for x in ("q", "k", "v", "do")}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def world_run(request, tmp_path_factory):
    """Every case on ``world`` gloo ranks: each rank's results."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    np.savez(tmp / "in.npz", **_inputs())
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(tmp / "in.npz"), str(tmp / f"r{r}.npz"), repr(CASES)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err
    return world, [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _jax_case(world, fn, impl, causal, dtype, grads):
    """The JAX package's output (and grads of sum(o · do)) over ``world``
    virtual devices, gathered."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    d = _inputs()
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, do = (jnp.asarray(d[x], dt) for x in ("q", "k", "v", "do"))

    def local(a, b, c):
        if fn == "ring":
            return jax_ring(a, b, c, "seq", causal=causal, impl=impl)
        return jax_ulysses(a, b, c, "seq", causal=causal)

    sharded = jax.shard_map(local, mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                            out_specs=P(None, "seq"))
    if not grads:
        return np.asarray(jax.jit(sharded)(q, k, v), np.float32), None
    o, vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return (np.asarray(o, np.float32),
            [np.asarray(g, np.float32) for g in vjp(do)])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_matches_jax(world_run, case):
    """Ring (dense and flash impl, causal and not, bf16) and Ulysses: the
    gathered output and q/k/v grads against the JAX package's over as many
    devices."""
    world, ranks = world_run
    name, fn, impl, causal, dtype, grads = case
    o_j, g_j = _jax_case(world, fn, impl, causal, dtype, grads)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(_gathered(ranks, f"{name}:o"), o_j,
                               **(BF16 if bf16 else FWD))
    if grads:
        for x, gj in zip("qkv", g_j):
            np.testing.assert_allclose(_gathered(ranks, f"{name}:d{x}"), gj,
                                       err_msg=f"d{x}",
                                       **(BF16 if bf16 else GRAD))


def test_ring_matches_dense_attention(world_run):
    """The gathered ring output and grads equal dense attention on the
    whole sequence (the JAX package's dense composition)."""
    world, ranks = world_run
    d = _inputs()
    for causal in (False, True):
        q, k, v = (jnp.asarray(d[x]) for x in "qkv")
        o, vjp = jax.vjp(lambda q, k, v: jax_sdpa(q, k, v, causal=causal),
                         q, k, v)
        g = vjp(jnp.asarray(d["do"]))
        name = f"ring-flash-{causal}"
        np.testing.assert_allclose(_gathered(ranks, f"{name}:o"),
                                   np.asarray(o), **FWD)
        for x, gj in zip("qkv", g):
            np.testing.assert_allclose(_gathered(ranks, f"{name}:d{x}"),
                                       np.asarray(gj), **GRAD)


def test_one_process_ring_equals_the_gloo_world(world_run):
    """chip_smoke.py's one-process ring of the hop functions gives every
    rank's output and grads bit for bit."""
    _, ranks = world_run
    for r in ranks:
        for name, fn, *_ in CASES:
            if fn == "ring":
                assert bool(r[f"{name}:one_process_equal"]), name


def test_ulysses_indivisible_heads_raises(world_run):
    """3 heads over 2 or 4 ranks: Ulysses refuses, naming the rule, as the
    JAX package does."""
    world, ranks = world_run
    assert all(bool(r["indivisible_raised"]) for r in ranks)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    x = jnp.zeros((1, 4 * world, 3, 8))
    with pytest.raises(ValueError, match="divisible"):
        jax.shard_map(lambda a, b, c: jax_ulysses(a, b, c, "seq"),
                      mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                      out_specs=P(None, "seq"))(x, x, x)


def test_ring_block_classification():
    """Hop i of rank me meets rank (me + i) mod n's block: the diagonal at
    hop 0, then in full from a lower rank and skipped from a higher one;
    n(n+1)/2 live blocks over a causal ring, n² without the mask."""
    from tpu_dist_torch.parallel.ring_attention import ring_block_mode
    for n in (1, 2, 4, 8):
        modes = [[ring_block_mode(i, me, n, True) for i in range(n)]
                 for me in range(n)]
        assert all(m[0] is True for m in modes)
        for me in range(n):
            for i in range(1, n):
                want = False if (me + i) % n < me else None
                assert modes[me][i] is want
        assert sum(m is not None for row in modes for m in row) == \
            n * (n + 1) // 2
        assert all(ring_block_mode(i, me, n, False) is False
                   for i in range(n) for me in range(n))
