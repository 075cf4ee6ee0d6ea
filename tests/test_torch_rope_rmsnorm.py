"""The port's RMSNorm and rotary embeddings (``norm="rmsnorm", rope=True``)
against the JAX package's.

Same numpy inputs on both sides; weights from the JAX ``model.init`` moved
over by ``load_jax_params``.  The rope model's rotation takes its positions
from three places, each held here: 0 (the uncached forward), the cache's
write index (an int in ``generate``'s prefill and a chunked prefill, the
slot pool's per-slot ``lengths`` in ``decode_step``) and the shard's offset
under ``sequence_axis`` (ring and Ulysses on two gloo ranks against the
unsharded JAX model).  Then DDP steps against the JAX DDP over conftest's
8-device CPU mesh (global batch 8), and the int8 model and the slot engine.

Tolerances: float32, the same terms summed in another order (and XLA's and
torch's float32 ``pow``/``cos``/``sin`` may differ in the last bit): logits
and layer outputs ``rtol=atol=1e-5``; parameters after SGD with momentum
``rtol=1e-5, atol=2e-6`` (lr × the gradient differences, compounded over the
steps), as in ``tests/test_torch_transformer_lm.py``; the sequence-parallel
gradients (a sum of the two ranks' shares) ``rtol=atol=1e-5``, the gradient
tolerance of ``tests/test_torch_moe.py``.  A bfloat16 RMSNorm output may differ by one bfloat16 rounding of
a float32 value that differs in its last bits (``2**-8`` relative).  Tokens
must be equal, token for token."""

import json
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
from jax.sharding import Mesh, PartitionSpec as P

import tpu_dist.dist as jdist
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn.quant import quantize_linear_weights as jax_quantize
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch import serve
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-5
LLAMA = dict(norm="rmsnorm", rope=True)
CFG = dict(vocab_size=61, dim=32, depth=2, num_heads=4, max_seq_len=64,
           **LLAMA)
BATCH, T, STEPS = 8, 16, 3
OPT = dict(lr=0.1, momentum=0.9)


def _tree(params):
    return {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.key(0))
    tm = load_jax_params(TorchLM(**CFG, device="cpu"), _tree(params))
    return jm, params, tm


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_rmsnorm_matches_jax(affine):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 10, 8)).astype(np.float32) * 3
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    ours = tnn.RMSNorm(8, elementwise_affine=affine, device="cpu")
    theirs = jnn.RMSNorm(8, elementwise_affine=affine)
    params = {"": {"weight": jnp.asarray(w)}} if affine else {}
    if affine:
        load_jax_params(ours, _tree(params))
        assert ours.eps == theirs.eps == 1e-6
    else:
        assert not list(ours.parameters())
    want = np.asarray(theirs.apply(params, jnp.asarray(x)))
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rmsnorm_keeps_bf16_and_float32_statistics():
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ours = tnn.RMSNorm(64, device="cpu").to(torch.bfloat16)
    got = ours(xb).detach()
    assert got.dtype == torch.bfloat16
    want = jnn.RMSNorm(64).apply(
        {"": {"weight": jnp.ones(64, jnp.bfloat16)}},
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("positions", ["shared", "per_row"])
@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rotary_embed_matches_jax(positions, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    pos = (np.arange(9) + 4 if positions == "shared"
           else rng.integers(0, 50, (3, 9)))
    want = np.asarray(jnn.rotary_embed(jnp.asarray(x), jnp.asarray(pos),
                                       theta))
    got = tnn.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos),
                           theta).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # bf16 in, bf16 out (angles, cos and sin in float32)
    assert tnn.rotary_embed(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(pos)).dtype == torch.bfloat16


def test_rope_attention_layer_matches_jax():
    """The layer alone, uncached: positions from 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    theirs = jnn.MultiheadSelfAttention(32, 4, causal=True, rope=True,
                                        rope_theta=300.0)
    params = theirs.init(jax.random.key(1))
    ours = tnn.MultiheadSelfAttention(32, 4, causal=True, rope=True,
                                      rope_theta=300.0, device="cpu")
    load_jax_params(ours, _tree(params))
    want = np.asarray(theirs.apply(params, jnp.asarray(x)))
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_odd_head_dim_with_rope_is_refused():
    with pytest.raises(ValueError, match="even head_dim"):
        jnn.MultiheadSelfAttention(30, 2, rope=True)
    with pytest.raises(ValueError, match="even head_dim"):
        tnn.MultiheadSelfAttention(30, 2, rope=True, device="cpu")
    with pytest.raises(ValueError, match="even head_dim"):
        TorchLM(vocab_size=11, dim=30, num_heads=2, rope=True, device="cpu")
    tnn.MultiheadSelfAttention(30, 2, device="cpu")     # odd is fine without
    with pytest.raises(ValueError, match="Unknown norm"):
        TorchLM(vocab_size=11, dim=32, norm="batchnorm", device="cpu")


# ---------------------------------------------------------------------------
# the model: three position sources
# ---------------------------------------------------------------------------

def test_load_jax_params_maps_rmsnorm_and_no_position_table(models):
    _, params, tm = models
    tree = _tree(params)
    assert "pos" not in tree and tm.pos is None
    ours = dict(tm.named_parameters())
    assert not any(k.startswith("pos.") for k in ours)
    for path in ("block0.ln1", "block1.ln2", "ln_f"):
        assert isinstance(tm.get_submodule(path), tnn.RMSNorm)
        assert set(tree[path]) == {"weight"}
        np.testing.assert_array_equal(ours[f"{path}.weight"].detach().numpy(),
                                      tree[path]["weight"])
    broken = {p: dict(v) for p, v in tree.items()}
    broken["pos"] = {"weight": np.zeros((64, 32), np.float32)}
    with pytest.raises(KeyError, match="pos.weight"):
        load_jax_params(TorchLM(**CFG, device="cpu"), broken)
    broken = {p: dict(v) for p, v in tree.items()}
    broken["ln_f"]["bias"] = np.zeros(32, np.float32)
    with pytest.raises(KeyError, match="ln_f.bias"):
        load_jax_params(TorchLM(**CFG, device="cpu"), broken)
    # the layernorm model's tree does not load into the rope model
    dense = _tree(JaxLM(**{**CFG, "norm": "layernorm", "rope": False}).init(
        jax.random.key(0)))
    with pytest.raises(KeyError, match="pos.weight"):
        load_jax_params(TorchLM(**CFG, device="cpu"), dense)


def test_uncached_logits_match_jax(models):
    jm, params, tm = models
    x = np.random.default_rng(4).integers(0, 61, (3, 20))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cached_chunks_with_a_scalar_index_match_jax(models):
    """A prefill, then chunks of 3 and 1 tokens through the same cache: the
    rotation's offset is the int write index (7, then 10)."""
    jm, params, tm = models
    x = np.random.default_rng(5).integers(0, 61, (2, 11))
    jstate = jm.init_cache(2, 32)
    tcache = tm.init_cache(2, 32)
    for lo, hi in ((0, 7), (7, 10), (10, 11)):
        want, jstate = jm.apply(params, jnp.asarray(x[:, lo:hi]),
                                state=jstate)
        with torch.no_grad():
            got = tm(torch.from_numpy(x[:, lo:hi]), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        assert tcache["block0.attn"]["index"] == hi
    # and the cached logits are the full forward's
    with torch.no_grad():
        full = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), rtol=RTOL,
                               atol=ATOL)


def test_slot_pool_lengths_match_jax_decode_step(models):
    """``prefill_into_slot`` at unequal lengths, then ``decode_step`` with
    the per-slot ``lengths`` as the rotation's (B,) offsets."""
    jm, params, tm = models
    rng = np.random.default_rng(6)
    prefill = jax.jit(jm.prefill_into_slot)
    decode = jax.jit(jm.decode_step)
    jc = jm.init_slot_cache(3, 32)
    tc = tm.init_slot_cache(3, 32)
    lengths = np.array([5, 11, 2])
    for slot, n in enumerate(lengths):
        prompt = np.zeros(16, np.int32)
        prompt[:n] = rng.integers(0, 61, n)
        jl, jc = prefill(params, jnp.asarray(prompt), int(n), slot, jc)
        tl, tc = tm.prefill_into_slot(torch.from_numpy(prompt), int(n), slot,
                                      tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    tokens = rng.integers(0, 61, 3)
    for _ in range(3):
        jl, jc = decode(params, jnp.asarray(tokens), jnp.asarray(lengths),
                        jc)
        tl, tc = tm.decode_step(torch.from_numpy(tokens), lengths, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        lengths = lengths + 1
        tokens = np.asarray(jl).argmax(-1)
    # keys are cached after the rotation, as in the JAX package
    for path, entry in jc.items():
        for s, n in enumerate(lengths):
            np.testing.assert_allclose(tc[path]["k"][s, :n].numpy(),
                                       np.asarray(entry["k"])[s, :n],
                                       rtol=RTOL, atol=ATOL)


def test_generate_greedy_matches_jax(models):
    jm, params, tm = models
    prompt = np.random.default_rng(7).integers(0, 61, (2, 7))
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 12))
    got = tm.generate(torch.from_numpy(prompt), 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_model_and_cache_match_jax(models):
    """The int8 weights (norms left in float, as the JAX converter leaves
    them) with an int8 cache: greedy tokens equal."""
    jm, params, _ = models
    opts = dict(attention=True, embedding=True)
    jq, qparams = jax_quantize(jm, params, **opts)
    tq = tnn.quantize_linear_weights(TorchLM(**CFG, device="cpu"), **opts)
    load_jax_params(tq, _tree(qparams))
    for path in ("block0.ln1", "ln_f"):
        assert isinstance(tq.get_submodule(path), tnn.RMSNorm)
    assert tq.block0.attn.rope and isinstance(
        tq.block0.attn, tnn.QuantMultiheadSelfAttention)
    prompt = np.random.default_rng(8).integers(0, 61, (2, 7))
    want = np.asarray(jq.generate(qparams, jnp.asarray(prompt), 10,
                                  cache_dtype=jnp.int8))
    got = tq.generate(torch.from_numpy(prompt), 10,
                      cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got, want)


def test_slot_engine_serves_the_rope_model_as_generate(models):
    """Admissions between decode steps, each slot at its own position."""
    _, _, tm = models
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, 61, int(rng.integers(3, 14))).astype(np.int32)
            for _ in range(5)]
    budgets = [int(rng.integers(2, 9)) for _ in reqs]
    engine = serve.SlotEngine(tm, num_slots=3, device="cpu")
    outs = {}
    pending = [serve.Request(p, n, on_token=lambda q, tok: outs.setdefault(
        q.id, []).append(tok)) for p, n in zip(reqs, budgets)]
    order = [r.id for r in pending]
    while pending or not engine.idle():
        if pending and engine.free_slots():
            engine.admit(pending.pop(0))
        engine.step()
    for p, n, i in zip(reqs, budgets, order):
        want = tm.generate(torch.from_numpy(p)[None], n)
        assert outs[i] == want[0, len(p):].tolist()


# ---------------------------------------------------------------------------
# sequence parallelism: the shard's offset, on two gloo ranks
# ---------------------------------------------------------------------------

SP_KW = dict(vocab_size=50, dim=32, depth=2, num_heads=4, max_seq_len=64,
             **LLAMA)

SP_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist
    from tpu_dist_torch.interop import load_jax_params
    from tpu_dist_torch.models import TransformerLM

    rank, port, inp, out, kw = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4], json.loads(sys.argv[5]))
    torch.set_num_threads(1)
    d = dict(np.load(inp))
    tree = {}
    for k, v in d.items():
        if k.startswith("p|"):
            _, path, leaf = k.split("|")
            tree.setdefault(path, {})[leaf] = v
    dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank, device="cpu",
                            timeout=120, axis_names=("seq",),
                            mesh_shape=(2,))
    idx = torch.from_numpy(d["idx"])
    cot = torch.from_numpy(d["cot"])
    t = idx.shape[1] // 2
    rows = slice(rank * t, (rank + 1) * t)
    res = {}
    for mode in ("ring", "ulysses"):
        model = TransformerLM(**kw, sequence_axis="seq", mode=mode,
                              device="cpu")
        load_jax_params(model, tree)
        logits = model(idx[:, rows])
        (logits * cot[:, rows]).sum().backward()
        res[f"{mode}:logits"] = logits.detach().numpy()
        for k, p in model.named_parameters():
            res[f"{mode}:g:{k}"] = p.grad.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sp_world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rope_sp")
    jm = JaxLM(**SP_KW)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 50, (2, 32))
    cot = rng.standard_normal((2, 32, 50)).astype(np.float32)
    feed = {"idx": idx, "cot": cot}
    feed.update({f"p|{p}|{k}": v for p, lv in _tree(params).items()
                 for k, v in lv.items()})
    np.savez(tmp / "in.npz", **feed)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", SP_WORKER, str(r), str(port),
         str(tmp / "in.npz"), str(tmp / f"r{r}.npz"), json.dumps(SP_KW)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err

    def objective(p):
        logits = jm.apply(p, jnp.asarray(idx))
        return jnp.sum(logits * cot), logits

    (_, logits), grads = jax.value_and_grad(objective, has_aux=True)(params)
    return (np.asarray(logits), _tree(grads), params, idx,
            [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)])


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_rope_matches_the_unsharded_jax_model(sp_world2, mode):
    """Each rank rotates its shard from ``index * t``: the two ranks'
    logits are the unsharded JAX model's, and the sum of their gradients
    its gradient.  The JAX sharded model (shard_map over two devices)
    agrees too."""
    want, grads, params, idx, ranks = sp_world2
    got = np.concatenate([r[f"{mode}:logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for path, leaves in grads.items():
        for leaf, g in leaves.items():
            ours = sum(r[f"{mode}:g:{path}.{leaf}"] for r in ranks)
            if ours.ndim == 2 and leaf in ("qkv_weight", "out_weight",
                                           "weight") and path != "tok":
                ours = ours.T
            np.testing.assert_allclose(ours, g, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{path}.{leaf}")
    sharded = JaxLM(**SP_KW, sequence_axis="seq", mode=mode)
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    pspec = jax.tree.map(lambda _: P(), params)
    jax_sp = jax.jit(jax.shard_map(
        lambda p, i: sharded.apply(p, i), mesh=mesh,
        in_specs=(pspec, P(None, "seq")), out_specs=P(None, "seq")))(
            params, jnp.asarray(idx))
    np.testing.assert_allclose(got, np.asarray(jax_sp), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# DDP steps against the JAX DDP
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 61, (BATCH, T)).astype(np.int32)
    y = rng.integers(0, 61, (BATCH, T)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def jax_ddp_run():
    """The JAX DDP over conftest's 8 CPU devices (one row each): initial
    params, then each step's loss and params."""
    x, y = _batch()
    model = JaxLM(**CFG)
    if jdist.is_initialized():
        jdist.destroy_process_group()
    pg = jdist.init_process_group(backend="cpu")
    try:
        ddp = JaxDDP(model, optimizer=joptim.SGD(**OPT),
                     loss_fn=jnn.CrossEntropyLoss(fused=True), group=pg)
        state = ddp.init(seed=0)
        params0 = _tree(state.params)
        steps = []
        for _ in range(STEPS):
            state, m = ddp.train_step(state, jnp.asarray(x), jnp.asarray(y))
            steps.append((float(m["loss"]), _tree(state.params)))
    finally:
        jdist.destroy_process_group()
    return params0, steps


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_ddp_train_steps_match_jax(jax_ddp_run, n_steps):
    params0, steps = jax_ddp_run
    x, y = _batch()
    model = load_jax_params(TorchLM(**CFG, device="cpu"), params0)
    ddp = TorchDDP(model, optimizer=toptim.SGD(**OPT),
                   loss_fn=tnn.CrossEntropyLoss(fused=True))
    state = ddp.init(seed=0)
    load_jax_params(model, params0)  # the state holds the module's tensors
    for _ in range(n_steps):
        state, m = ddp.train_step(state, torch.from_numpy(x),
                                  torch.from_numpy(y))
    loss_j, params_j = steps[n_steps - 1]
    np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-5)
    want = dict(load_jax_params(TorchLM(**CFG, device="cpu"),
                                params_j).named_parameters())
    for key, got in state.params.items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[key].detach().numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=key)
