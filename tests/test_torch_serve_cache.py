"""The port's KV-cache path against the JAX package's: ``prefill_into_slot``
and ``decode_step`` over a slot pool (float32, bfloat16 and int8 caches,
unequal per-slot lengths), ``generate`` greedy and seeded-sampled, and the
engine against ``generate`` (the port's, held to the JAX package's here).

Both sides run the tiny model (vocab 251, dim 64, depth 2, heads 2,
``max_seq_len`` 64) with the weights of JAX ``model.init(jax.random.key(0))``
moved over by ``load_jax_params``.  Tolerances: float32 logits and cache
leaves ``rtol=atol=1e-5`` (the same sums in another order; measured ≤ 1e-6).
A bfloat16 cache leaf may differ by one bfloat16 rounding of a float32 value
that differs in its last bits (``2**-8`` relative); an int8 leaf by one
quantization step (1) where the quotient sits on a rounding boundary, its
scale by 1e-5 relative; the logits of both stay within 1e-4 (measured
≤ 1e-6).  Tokens must be equal, token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch import serve
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM

CFG = dict(vocab_size=251, dim=64, depth=2, num_heads=2, max_seq_len=64)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 1e-4}


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.key(0))
    tree = {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}
    tm = load_jax_params(TorchLM(**CFG, device="cpu"), tree)
    return jm, params, tm


def _check_leaves(jax_cache, torch_cache, dtype, upto=None):
    """Every leaf of both slot pools (each slot's row up to ``upto[slot]``
    positions when given, else whole)."""
    for path, entry in jax_cache.items():
        assert set(entry) == set(torch_cache[path])
        for name, a in entry.items():
            a = np.asarray(a.astype(jnp.float32))
            b = torch_cache[path][name].float().numpy()
            rows = (range(a.shape[0]) if upto is None else range(len(upto)))
            for s in rows:
                n = a.shape[1] if upto is None else upto[s]
                x, y = a[s, :n], b[s, :n]
                if name.endswith("scale") or dtype == "float32":
                    np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5,
                                               err_msg=f"{path}.{name}")
                elif dtype == "bfloat16":
                    np.testing.assert_allclose(y, x, rtol=2.0 ** -8,
                                               atol=1e-6,
                                               err_msg=f"{path}.{name}")
                else:
                    np.testing.assert_array_less(np.abs(y - x), 1.5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_steps_match_jax(models, dtype):
    jm, params, tm = models
    jd, td = DTYPES[dtype]
    tol = LOGIT_TOL[dtype]
    rng = np.random.default_rng(1)
    # one compiled program each, instead of one per primitive
    prefill = jax.jit(jm.prefill_into_slot)
    decode = jax.jit(jm.decode_step)
    jc = jm.init_slot_cache(3, 64, jd)
    tc = tm.init_slot_cache(3, 64, td)
    lengths = np.array([5, 11, 2])
    for slot, n in enumerate(lengths):
        prompt = np.zeros(16, np.int32)
        prompt[:n] = rng.integers(0, 251, n)
        jl, jc = prefill(params, jnp.asarray(prompt), int(n), slot, jc)
        tl, tc = tm.prefill_into_slot(torch.from_numpy(prompt), int(n), slot,
                                      tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
    # whole rows: the fresh batch-1 rows are copied in, zeros past each
    # prompt (the padding's K/V at 16 > n is written too)
    _check_leaves(jc, tc, dtype)
    tokens = rng.integers(0, 251, 3)
    for _ in range(3):
        jl, jc = decode(params, jnp.asarray(tokens), jnp.asarray(lengths),
                        jc)
        tl, tc = tm.decode_step(torch.from_numpy(tokens), lengths, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        lengths = lengths + 1
        tokens = np.asarray(jl).argmax(-1)
    _check_leaves(jc, tc, dtype, upto=lengths)


def test_decode_step_names_the_slot_out_of_range(models):
    _, _, tm = models
    cache = tm.init_slot_cache(2, 8)
    with pytest.raises(ValueError, match="slot 1 is at length 8"):
        tm.decode_step(torch.tensor([1, 2]), np.array([3, 8]), cache)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_generate_greedy_matches_jax(models, cache):
    jm, params, tm = models
    jd, td = DTYPES[cache]
    prompt = np.random.default_rng(2).integers(0, 251, (2, 7))
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 10,
                                  cache_dtype=jd))
    got = tm.generate(torch.from_numpy(prompt), 10, cache_dtype=td).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,top_k,top_p", [(5, 0, 1.0), (5, 20, 0.9),
                                              (11, 7, 1.0), (11, 0, 0.6)])
def test_generate_sampled_matches_jax(models, seed, top_k, top_p):
    jm, params, tm = models
    prompt = np.random.default_rng(3).integers(0, 251, (2, 7))
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 10,
                                  temperature=0.8, rng=jax.random.key(seed),
                                  top_k=top_k, top_p=top_p))
    got = tm.generate(torch.from_numpy(prompt), 10, temperature=0.8,
                      rng=serve.random_key(seed), top_k=top_k,
                      top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)


def _run_engine(tm, reqs, slots, cache_dtype=None):
    """Admissions interleaved with decoding, one a boundary; each
    request's tokens in submission order."""
    engine = serve.SlotEngine(tm, num_slots=slots, cache_dtype=cache_dtype,
                              device="cpu")
    outs = {}
    pending = [serve.Request(p, n, temperature=t, seed=s,
                             on_token=lambda q, tok: outs.setdefault(
                                 q.id, []).append(tok))
               for p, n, t, s in reqs]
    order = [r.id for r in pending]
    while pending or not engine.idle():
        if pending and engine.free_slots():
            engine.admit(pending.pop(0))
        engine.step()
    return [outs[i] for i in order], engine


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_engine_matches_generate(models, cache):
    """Against the port's ``generate`` for each request alone, which the
    tests above hold to the JAX package's."""
    _, _, tm = models
    td = DTYPES[cache][1]
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 251, int(rng.integers(3, 14))).astype(np.int32),
             int(rng.integers(2, 9)), 0.0, 0) for _ in range(5)]
    reqs.append((reqs[0][0], 6, 0.8, 7))   # a sampled request in the pool
    outs, engine = _run_engine(tm, reqs, slots=3, cache_dtype=td)
    for (p, n, temp, seed), got in zip(reqs, outs):
        want = tm.generate(torch.from_numpy(p)[None], n, temperature=temp,
                           rng=serve.random_key(seed), cache_dtype=td)
        assert got == want[0, len(p):].tolist()
    assert engine.completed == len(reqs)
    assert engine.stats()["e2e"]["count"] == len(reqs)


def test_init_cache_and_norm_rules(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="causal"):
        TorchLM(**CFG, causal=False, device="cpu").init_cache(1)
    with pytest.raises(NotImplementedError, match="RMSNorm"):
        TorchLM(**CFG, norm="rmsnorm", device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        tm.generate(torch.zeros(1, 60, dtype=torch.long), 5)
    with pytest.raises(ValueError, match="requires rng"):
        tm.generate(torch.zeros(1, 4, dtype=torch.long), 2, temperature=1.0)
