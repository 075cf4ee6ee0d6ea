"""Disaggregated prefill/decode serving on the port (``tpu_dist_torch.serve``
disagg, kvtransfer, prefix) against the JAX package — the twin of
``tests/test_serve_disagg.py``.

- **KV wire**: the port's per-layer fragments round-trip exact on the exact
  wire (int8 cache rows and their scales included, bfloat16 tensors too),
  the int8_block wire is the lossy opt-in, and the wire is the JAX
  package's: a JAX sender's transfer fetches bit for bit on the port.
  Every drift is the same named ``KVTransferError``.
- **Prefix cache**: verified misses on collisions, eviction under the byte
  cap, spill and restore bit for bit, the restarted index (and a JAX
  package's spill directory) served without recompute; bfloat16 entries
  round-trip by their recorded dtype.
- **prefill_rows**: with and without prefix rows, within 1e-5 of JAX's.
- **Decode engine**: one re-dispatch, then the named failure.
- **Smoke**: disaggregated greedy tokens, prefix hits included, equal JAX
  ``generate()`` on the same weights; the int8 cache too.

The prefill-rank SIGKILL e2e is slow, as in JAX (the card covers it:
``chip_smoke.py`` ``serve_disagg``)."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import serve as jserve
from tpu_dist.collectives import transport as JT
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch import interop, serve
from tpu_dist_torch.benchmarks import serve_lm as bench
from tpu_dist_torch.collectives import transport as TT
from tpu_dist_torch.dist.store import TCPStore
from tpu_dist_torch.models import TransformerLM
from tpu_dist_torch.serve import (DisaggError, DisaggSlotEngine, KVTransfer,
                                  KVTransferError, PrefixCache, Request,
                                  kv_template)

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def store():
    s = TCPStore(is_master=True, timeout=60)
    yield s
    s.close()


def _mk_rows(T, layers=2, heads=2, hd=4, seed=0):
    rng = np.random.default_rng(seed)
    return {f"blocks/{j}": {k: rng.standard_normal(
        (1, T, heads, hd)).astype(np.float32) for k in ("k", "v")}
        for j in range(layers)}


def _mk_int8_rows(T, layers=2, heads=2, hd=4, seed=0):
    rng = np.random.default_rng(seed)
    return {f"blocks/{j}": {
        "k": rng.integers(-127, 128, (1, T, heads, hd)).astype(np.int8),
        "v": rng.integers(-127, 128, (1, T, heads, hd)).astype(np.int8),
        "k_scale": rng.random((1, T, heads)).astype(np.float32),
        "v_scale": rng.random((1, T, heads)).astype(np.float32)}
        for j in range(layers)}


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _send_fetch(kv0, kv1, rows, rid, length, first_tok, **kw):
    err = []

    def send():
        try:
            kv0.send(1, rid, rows, length, first_tok, **kw)
        except Exception as e:     # surfaces in the assert below
            err.append(e)
    t = threading.Thread(target=send, daemon=True)
    t.start()
    got = kv1.fetch(0, rid, 30.0)
    t.join(30)
    assert not err, err
    return got


# ---------------------------------------------------------------------------
# KV transfer wire
# ---------------------------------------------------------------------------

class TestKVTransfer:
    def _pair(self, store, wire=None, template=None, recv_template=None):
        dp0, dp1 = TT.DataPlane(store, 0, 2), TT.DataPlane(store, 1, 2)
        template = template or kv_template(_mk_rows(8))
        return (dp0, dp1, KVTransfer(dp0, template, wire=wire),
                KVTransfer(dp1, recv_template or template, wire=wire))

    def test_round_trip_exact_bitwise(self, store):
        dp0, dp1, kv0, kv1 = self._pair(store)
        try:
            rows = _mk_rows(12, seed=3)
            got = _send_fetch(kv0, kv1, rows, 7, 10, 42, prefix_hit=4,
                              prefill_ns=1234)
            assert got["length"] == 10 and got["first_tok"] == 42
            assert got["prefix_hit"] == 4 and got["prefill_ns"] == 1234
            for path in rows:
                for k in ("k", "v"):
                    np.testing.assert_array_equal(got["rows"][path][k],
                                                  rows[path][k][:, :10])
            assert kv1.fetched_bytes == got["bytes"] > 0
        finally:
            dp0.close(), dp1.close()

    def test_tensor_rows_bf16_round_trip_exact(self, store):
        """A prefill rank's rows are tensors (bfloat16 for a bf16 cache):
        they travel as their bit patterns and come back bit for bit."""
        rows = {p: {k: torch.from_numpy(a).to(torch.bfloat16)
                    for k, a in e.items()} for p, e in _mk_rows(9).items()}
        dp0, dp1, kv0, kv1 = self._pair(store, template=kv_template(rows))
        try:
            got = _send_fetch(kv0, kv1, rows, 5, 7, 1)
            from tpu_dist_torch.collectives import _lowp
            for path in rows:
                for k in ("k", "v"):
                    t = _lowp.to_torch(got["rows"][path][k])
                    assert t.dtype == torch.bfloat16
                    assert torch.equal(t, rows[path][k][:, :7])
        finally:
            dp0.close(), dp1.close()

    def test_int8_block_wire_lossy_opt_in(self, store):
        dp0, dp1, kv0, kv1 = self._pair(store, wire="int8_block32")
        try:
            rows = _mk_rows(16, seed=5)
            got = _send_fetch(kv0, kv1, rows, 9, 16, 1)
            for path in rows:
                for k in ("k", "v"):
                    a, b = got["rows"][path][k], rows[path][k]
                    assert a.shape == b.shape and a.dtype == b.dtype
                    assert np.max(np.abs(a - b)) < 0.1
                    assert not np.array_equal(a, b)
            exact = sum(r[k][:, :16].nbytes for r in rows.values()
                        for k in r)
            assert kv1.fetched_bytes < exact / 2
        finally:
            dp0.close(), dp1.close()

    def test_int8_cache_rows_exact_on_quant_wire(self, store):
        template = kv_template(_mk_int8_rows(8))
        dp0, dp1, kv0, kv1 = self._pair(store, wire="int8_block32",
                                        template=template)
        try:
            rows = _mk_int8_rows(16, seed=11)
            got = _send_fetch(kv0, kv1, rows, 21, 16, 3)
            for path in rows:
                for k in ("k", "v"):
                    assert got["rows"][path][k].dtype == np.int8
                    np.testing.assert_array_equal(got["rows"][path][k],
                                                  rows[path][k])
                for k in ("k_scale", "v_scale"):
                    a, b = got["rows"][path][k], rows[path][k]
                    assert a.dtype == np.float32
                    assert np.max(np.abs(a - b)) < 0.1
                    assert not np.array_equal(a, b)
        finally:
            dp0.close(), dp1.close()

    def test_int8_cache_rows_round_trip_exact_wire(self, store):
        template = kv_template(_mk_int8_rows(8))
        dp0, dp1, kv0, kv1 = self._pair(store, template=template)
        try:
            rows = _mk_int8_rows(12, seed=13)
            got = _send_fetch(kv0, kv1, rows, 23, 10, 5)
            for path in rows:
                for k in ("k", "v", "k_scale", "v_scale"):
                    np.testing.assert_array_equal(got["rows"][path][k],
                                                  rows[path][k][:, :10])
        finally:
            dp0.close(), dp1.close()

    @pytest.mark.parametrize("wire", [None, "int8_block32"])
    def test_jax_sender_port_receiver_same_wire(self, store, wire):
        """The wire is the JAX package's: a JAX KVTransfer's rows fetch on
        the port's (exact wire bit for bit; the quantized wire decodes to
        the JAX receiver's own bytes)."""
        jdp, tdp = JT.DataPlane(store, 0, 2), TT.DataPlane(store, 1, 2)
        try:
            rows = _mk_rows(11, seed=17)
            jkv = jserve.KVTransfer(jdp, jserve.kv_template(rows), wire=wire)
            tkv = KVTransfer(tdp, kv_template(rows), wire=wire)
            got = _send_fetch(jkv, tkv, rows, 31, 11, 8, prefix_hit=2)
            assert (got["length"], got["first_tok"], got["prefix_hit"]) == \
                (11, 8, 2)
            for path in rows:
                for k in ("k", "v"):
                    a, b = got["rows"][path][k], rows[path][k]
                    if wire is None:
                        np.testing.assert_array_equal(a, b)
                    else:
                        from tpu_dist.collectives.quant import (dequantize,
                                                                parse_scheme,
                                                                quantize)
                        sch = parse_scheme(wire)
                        q, sc = quantize(b.reshape(-1), sch)
                        np.testing.assert_array_equal(
                            a.reshape(-1), dequantize(q, sc, sch))
        finally:
            jdp.close(), tdp.close()

    def test_bad_wire_spec_named(self, store):
        dp = TT.DataPlane(store, 1, 2)
        try:
            with pytest.raises(KVTransferError, match="int8_block"):
                KVTransfer(dp, kv_template(_mk_rows(8)), wire="gzip")
        finally:
            dp.close()

    def test_sender_shape_drift_named(self, store):
        dp0, dp1, kv0, kv1 = self._pair(store)
        try:
            with pytest.raises(KVTransferError, match="models disagree"):
                kv0.send(1, 11, _mk_rows(8, hd=6), 8, 0)
        finally:
            dp0.close(), dp1.close()

    def test_layer_count_drift_named(self, store):
        dp0, dp1, kv0, kv1 = self._pair(store)
        kv0 = KVTransfer(dp0, kv_template(_mk_rows(8, layers=3)))
        try:
            rows = _mk_rows(8, layers=3)
            t = threading.Thread(target=lambda: kv0.send(1, 13, rows, 8, 0),
                                 daemon=True)
            t.start()
            with pytest.raises(KVTransferError, match="layer layout drift"):
                kv1.fetch(0, 13, 30.0)
            t.join(30)
        finally:
            dp0.close(), dp1.close()

    def test_fetch_deadline_names_request_and_peer(self, store):
        dp0, dp1, kv0, kv1 = self._pair(store)
        try:
            with pytest.raises(KVTransferError, match=r"kv fetch 99.*rank 0"):
                kv1.fetch(0, 99, 0.3)
        finally:
            dp0.close(), dp1.close()


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def _pc(**kw):
    return PrefixCache(device="cpu", **kw)


class TestPrefixCache:
    def test_hit_is_bitwise_and_capped_below_prompt(self):
        pc = _pc(block_tokens=4)
        prompt = np.arange(10, 26, dtype=np.int32)
        rows = _mk_rows(16, seed=1)
        assert pc.insert(prompt, rows, 16) == 4
        hit, got = pc.match(prompt)
        assert hit == 12
        for path in rows:
            for k in ("k", "v"):
                assert torch.is_tensor(got[path][k])
                np.testing.assert_array_equal(_np(got[path][k]),
                                              rows[path][k][:, :12])
        hit, got = pc.match(np.concatenate([prompt, [7, 8, 9]]))
        assert hit == 16
        np.testing.assert_array_equal(_np(got["blocks/0"]["k"]),
                                      rows["blocks/0"]["k"])
        assert pc.stats()["tokens_saved"] == 28
        # entries are tensors; resident bytes count them
        assert pc.resident_bytes() == 4 * 2 * 2 * 4 * 2 * 4 * 4

    def test_forced_collision_is_verified_miss(self, monkeypatch):
        pc = _pc(block_tokens=4)
        monkeypatch.setattr(pc, "_key_for",
                            lambda tokens: f"len{len(tokens)}")
        a = np.arange(1, 9, dtype=np.int32)
        b = np.arange(101, 109, dtype=np.int32)
        pc.insert(a, _mk_rows(8, seed=2), 8)
        hit, got = pc.match(np.concatenate([b, [5]]))
        assert (hit, got) == (0, None)
        assert pc.collisions == 1 and pc.hits == 0
        pc.insert(b, _mk_rows(8, seed=3), 8)
        hit, got = pc.match(np.concatenate([a, [5]]))
        assert hit == 8
        np.testing.assert_array_equal(_np(got["blocks/0"]["k"]),
                                      _mk_rows(8, seed=2)["blocks/0"]["k"])

    def test_eviction_under_byte_cap_without_spill(self):
        pc = _pc(block_tokens=4, capacity_bytes=600)
        pc.insert(np.arange(1, 9, dtype=np.int32), _mk_rows(8, seed=4), 8)
        assert pc.evicted >= 1
        assert pc.resident_bytes() <= 600

    def test_spill_page_out_restore_bitwise(self, tmp_path):
        pc = _pc(block_tokens=4, capacity_bytes=600, spill_dir=str(tmp_path))
        a = np.arange(1, 9, dtype=np.int32)
        rows = _mk_rows(8, seed=6)
        pc.insert(a, rows, 8)
        assert pc.paged_out >= 1 and pc.evicted == 0
        assert pc.resident_bytes() <= 600
        hit, got = pc.match(np.concatenate([a, [3]]))
        assert hit == 8 and pc.paged_in >= 1
        for path in rows:
            for k in ("k", "v"):
                np.testing.assert_array_equal(_np(got[path][k]),
                                              rows[path][k])

    def test_spill_index_survives_restart(self, tmp_path):
        pc = _pc(block_tokens=4, capacity_bytes=600, spill_dir=str(tmp_path))
        a = np.arange(1, 9, dtype=np.int32)
        rows = _mk_rows(8, seed=8)
        pc.insert(a, rows, 8)
        paged = pc.paged_out
        assert paged >= 1
        pc.close()
        pc2 = _pc(block_tokens=4, capacity_bytes=600,
                  spill_dir=str(tmp_path))
        assert len(pc2._entries) == paged
        hit, got = pc2.match(np.concatenate([a, [3]]))
        assert hit == 4 and pc2.paged_in == 1
        np.testing.assert_array_equal(_np(got["blocks/0"]["k"]),
                                      rows["blocks/0"]["k"][:, :4])
        assert len(_pc(block_tokens=8, spill_dir=str(tmp_path))._entries) == 0

    def test_jax_spill_directory_serves_on_the_port(self, tmp_path):
        """A JAX package's spill tier (index.json + npz) pages in on the
        port bit for bit: the same layout, read by the same range-reads."""
        jpc = jserve.PrefixCache(block_tokens=4, capacity_bytes=600,
                                 spill_dir=str(tmp_path))
        a = np.arange(1, 9, dtype=np.int32)
        rows = _mk_rows(8, seed=9)
        jpc.insert(a, rows, 8)
        jpc.close()
        pc = _pc(block_tokens=4, capacity_bytes=600, spill_dir=str(tmp_path))
        hit, got = pc.match(np.concatenate([a, [3]]))
        assert hit == 4
        np.testing.assert_array_equal(_np(got["blocks/1"]["v"]),
                                      rows["blocks/1"]["v"][:, :4])

    def test_bf16_entry_round_trips_by_recorded_dtype(self, tmp_path):
        """A bfloat16 cache's rows spill as their 16-bit patterns with
        "bfloat16" in the index and page back in as bfloat16, bit for bit
        — including after a restart."""
        rows = {p: {k: torch.from_numpy(a).to(torch.bfloat16)
                    for k, a in e.items()} for p, e in _mk_rows(8).items()}
        pc = _pc(block_tokens=4, capacity_bytes=0, spill_dir=str(tmp_path))
        a = np.arange(1, 9, dtype=np.int32)
        pc.insert(a, rows, 8)
        assert pc.paged_out >= 1
        pc.close()
        pc2 = _pc(block_tokens=4, capacity_bytes=0,
                  spill_dir=str(tmp_path))
        hit, got = pc2.match(np.concatenate([a, [3]]))
        assert hit == 8
        for path in rows:
            for k in ("k", "v"):
                assert got[path][k].dtype == torch.bfloat16
                assert torch.equal(got[path][k], rows[path][k])
        spans = next(iter(pc2._entries.values())).spans
        assert {s[5] for s in spans} == {"bfloat16"}


# ---------------------------------------------------------------------------
# prefill_rows against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """The JAX test's decode model and the port's with its weights."""
    jmodel = JaxLM(vocab_size=61, dim=24, depth=2, num_heads=2,
                   max_seq_len=64)
    params = jmodel.init(jax.random.key(0))
    model = TransformerLM(61, dim=24, depth=2, num_heads=2, max_seq_len=64,
                          device="cpu")
    interop.load_jax_params(model, {p: {n: np.asarray(a) for n, a in
                                        d.items()} for p, d in
                                    params.items()})
    return jmodel, params, model


@pytest.mark.parametrize("prefix", [0, 16])
def test_prefill_rows_match_jax(lm, prefix):
    """Fresh rows and the suffix-only prefill over cached prefix rows: the
    last real token's logits and every row within 1e-5 of JAX's."""
    jmodel, params, model = lm
    tokens = (np.arange(23) * 7 % 61).astype(np.int32)
    L = len(tokens)
    if prefix:
        suffix = np.zeros(16, np.int32)
        suffix[:L - prefix] = tokens[prefix:]
        # the prefix rows: a full prefill's first `prefix` columns
        _, jfull = jmodel.prefill_rows(params, jnp.asarray(
            np.pad(tokens[:prefix], (0, 0))), prefix, 64)
        jpre = {p: {k: jnp.where(jnp.arange(64)[None, :, None, None] <
                                 prefix, v, 0) for k, v in e.items()}
                for p, e in jfull.items()}
        tpre = {p: {k: torch.from_numpy(np.array(v))
                    for k, v in e.items()} for p, e in jpre.items()}
        jl, jrows = jmodel.prefill_rows(params, jnp.asarray(suffix), L, 64,
                                        prefix_rows=jpre, prefix_len=prefix)
        tl, trows = model.prefill_rows(suffix, L, 64, prefix_rows=tpre,
                                       prefix_len=prefix)
    else:
        padded = np.zeros(32, np.int32)
        padded[:L] = tokens
        jl, jrows = jmodel.prefill_rows(params, jnp.asarray(padded), L, 64)
        tl, trows = model.prefill_rows(padded, L, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for path in jrows:
        for k in ("k", "v"):
            got = trows[path][k][:, :L].numpy()
            np.testing.assert_allclose(got, np.asarray(jrows[path][k])[
                :, :L], **TOL)
    # and the full prefill's logits (no prefix) — a hit is the same token
    padded = np.zeros(32, np.int32)
    padded[:L] = tokens
    full_l, _ = model.prefill_rows(padded, L, 64)
    assert int(tl.argmax()) == int(full_l.argmax())


# ---------------------------------------------------------------------------
# decode engine / role graph units
# ---------------------------------------------------------------------------

class _StubDispatch:
    def __init__(self):
        self.put_count = 0

    def put(self, desc, timeout=None):
        self.put_count += 1


class _StubArrive:
    def get(self, timeout=None):
        time.sleep(min(timeout or 0.1, 0.1))
        raise TimeoutError("empty")


def _engine(model, **kw):
    return DisaggSlotEngine(model, kv=SimpleNamespace(fetched_bytes=0),
                            dispatch_ch=_StubDispatch(),
                            arrive_ch=_StubArrive(), num_slots=2, max_len=64,
                            rank=1, device="cpu", **kw)


class TestDisaggEngine:
    def test_stage_timeout_redispatches_once_then_names_request(self, lm):
        eng = _engine(lm[2], kv_timeout=0.3)
        try:
            req = Request(np.arange(1, 7, dtype=np.int32), 4)
            eng.dispatch({"id": int(req.id), "prompt": req.prompt.tolist(),
                          "dst": 1, "dst_rr": 0})
            t0 = time.monotonic()
            with pytest.raises(KVTransferError,
                               match=rf"request {req.id}.*no KV arrival"
                                     r".*after one re-dispatch"):
                eng.stage(req)
            assert 0.5 < time.monotonic() - t0 < 5.0
            assert eng.redispatches == 1
        finally:
            eng.close()

    def test_cancelled_request_stops_waiting_by_name(self, lm):
        eng = _engine(lm[2], kv_timeout=30.0)
        try:
            req = Request(np.arange(1, 7, dtype=np.int32), 4)
            eng.dispatch({"id": int(req.id)})
            threading.Timer(0.2, req.cancel).start()
            with pytest.raises(KVTransferError, match="cancelled/expired"):
                eng.stage(req)
        finally:
            eng.close()

    def test_int8_slot_cache_pool_carries_scales(self, lm):
        model = lm[2]
        eng = _engine(model, cache_dtype=torch.int8)
        try:
            entry = next(iter(eng.cache.values()))
            assert entry["k"].dtype == torch.int8
            assert entry["k_scale"].dtype == torch.float32
            tpl = kv_template(model.init_slot_cache(1, 64, torch.int8))
            assert set(next(iter(tpl.values()))) == {
                "k", "v", "k_scale", "v_scale"}
        finally:
            eng.close()

    def test_disagg_graph_shape(self):
        g = serve.disagg_graph(2, 3)
        assert [(r.name, r.world) for r in g.roles] == \
            [("prefill", 2), ("decode", 3)]
        assert {c.name for c in g.channels} == {"prefill-q", "kv0", "kv1",
                                                "kv2"}
        with pytest.raises(DisaggError, match="prefill:0"):
            serve.disagg_graph(0, 1)
        jg = jserve.disagg_graph(2, 3)
        assert g.to_json() == jg.to_json()


class TestSchedulerSweepFatal:
    def test_sweep_death_takes_cause_naming_fatal_path(self, lm):
        engine = serve.SlotEngine(lm[2], num_slots=2, max_len=64,
                                  device="cpu")
        boom = RuntimeError("probe hit a dead follower")
        engine.sweep_expired = lambda: (_ for _ in ()).throw(boom)
        sched = serve.Scheduler(engine)
        try:
            with pytest.raises(Exception) as ei:
                sched.submit(list(range(2, 8)), max_new_tokens=4,
                             timeout=10.0).wait_done(timeout=30.0)
            assert "dead follower" in str(ei.value)
            assert sched.fatal is boom
        finally:
            sched.close()


# ---------------------------------------------------------------------------
# the smoke gate: disaggregated greedy decode == JAX generate()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_lm():
    cfg = bench.DISAGG_SMOKE_CONFIG
    jmodel = JaxLM(**cfg)
    params = jmodel.init(jax.random.key(0))
    model = TransformerLM(cfg["vocab_size"], dim=cfg["dim"],
                          depth=cfg["depth"], num_heads=cfg["num_heads"],
                          max_seq_len=cfg["max_seq_len"], device="cpu")
    interop.load_jax_params(model, {p: {n: np.asarray(a) for n, a in
                                        d.items()} for p, d in
                                    params.items()})
    return jmodel, params, model


def _jax_refs(jmodel, params, reqs, cache_dtype=None):
    out = []
    for p, g in reqs:
        toks = jmodel.generate(params, jnp.asarray(p)[None, :], g,
                               cache_dtype=cache_dtype)
        out.append(np.asarray(toks)[0, len(p):].tolist())
    return out


def test_disagg_smoke_equals_jax_generate(smoke_lm):
    """bench_serve's disagg smoke on the port: five requests, three sharing
    a 36-token prefix, through dispatch → prefill → transfer → slot →
    decode; token for token JAX ``generate()``, with 5 transfers, at least
    2 prefix hits and fewer prefilled tokens than prompt tokens."""
    jmodel, params, model = smoke_lm
    rig = bench.DisaggRig(model, 160, slots=4,
                          prefix=PrefixCache(block_tokens=16, device="cpu"))
    try:
        shared = list(range(5, 41))
        reqs = [(np.asarray(shared + [60 + i], np.int32), 6)
                for i in range(3)]
        reqs += [(np.arange(3, 3 + p, dtype=np.int32), g)
                 for p, g in ((6, 4), (20, 8))]
        refs = _jax_refs(jmodel, params, reqs)
        outs = [rig.sched.submit(p, max_new_tokens=g, timeout=60.0)
                .wait_done(timeout=120.0) for p, g in reqs]
        assert outs == refs
        st = rig.engine.stats()
        assert st["kv"]["transfers"] == len(reqs)
        assert st["prefix_cache"]["hits"] >= 2
        w = rig.worker.stats()
        assert w["prefilled_tokens"] < w["total_tokens"]
    finally:
        rig.close()


def test_int8_disagg_parity_vs_jax_int8_generate(lm):
    """The int8 slot cache through the disaggregated stack: quantized rows
    and scales over the KV wire, slot write, quantized decode — token for
    token JAX ``generate(cache_dtype=int8)``."""
    jmodel, params, model = lm
    rig = bench.DisaggRig(model, 64, slots=2, cache_dtype=torch.int8)
    try:
        reqs = [(np.arange(2, 10, dtype=np.int32), 5),
                (np.arange(11, 31, dtype=np.int32), 4)]
        refs = _jax_refs(jmodel, params, reqs, cache_dtype=jnp.int8)
        for i, (p, g) in enumerate(reqs):
            assert rig.sched.submit(p, max_new_tokens=g, timeout=60.0) \
                .wait_done(timeout=120.0) == refs[i]
        assert rig.engine.stats()["kv"]["transfers"] == len(reqs)
    finally:
        rig.close()


def test_prefill_warm_sends_caches_and_counts_nothing(lm):
    """``PrefillWorker.warm`` runs the forward once and leaves no trace: no
    bytes on the wire, nothing in the prefix cache, no claim or token in
    the worker's counts; the requests after it still equal JAX
    ``generate()`` (the first a prefix miss, the second a hit)."""
    jmodel, params, model = lm
    rig = bench.DisaggRig(model, 64, slots=2,
                          prefix=PrefixCache(block_tokens=4, device="cpu"))
    try:
        before = rig.worker.stats()
        assert rig.worker.warm() >= 0.0
        assert rig.worker.stats() == before
        assert before["kv_bytes_out"] == 0
        assert before["prefix_cache"]["inserts"] == 0
        reqs = [(np.arange(2, 14, dtype=np.int32), 5),
                (np.arange(2, 18, dtype=np.int32), 4)]
        refs = _jax_refs(jmodel, params, reqs)
        for i, (p, g) in enumerate(reqs):
            assert rig.sched.submit(p, max_new_tokens=g, timeout=60.0) \
                .wait_done(timeout=120.0) == refs[i]
        w = rig.worker.stats()
        assert w["claims"] == rig.engine.stats()["kv"]["transfers"] == 2
        assert w["prefix_cache"]["hits"] == 1
    finally:
        rig.close()


def test_bench_serve_disagg_smoke():
    row = bench.run_disagg(smoke=True, device="cpu")
    assert row["tokens_ok"] is True
    assert row["transfers"] == row["requests"] == 5
    assert row["prefix_hits"] >= 2


# ---------------------------------------------------------------------------
# chaos e2e: SIGKILL the prefill rank under load (slow, as in JAX)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@pytest.mark.chaos
@pytest.mark.multiprocess
@pytest.mark.slow
def test_prefill_rank_sigkill_redispatch_and_recover(tmp_path):
    """SIGKILL the prefill rank of prefill:1,decode:1 under load: in-flight
    requests end bounded (done, or a named error), the solo-restarted
    prefill rank re-attaches, and the SAME client connection reproduces
    the pre-kill tokens."""
    serve_port = _free_port()
    pid_file = str(tmp_path / "worker.pid")
    log = open(tmp_path / "launcher.log", "w")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               TPU_DIST_KV_TIMEOUT="5")
    env.pop("TPU_DIST_CHAOS", None)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--max_restarts", "3", "--serve", "--serve_port", str(serve_port),
         "--roles", "prefill:1,decode:1", "-m",
         "tpu_dist_torch.examples.serve_lm", "--tiny", "--device", "cpu",
         "--disagg", "--pid-file", pid_file, "--run-seconds", "600"],
        env=env, cwd=REPO, stdout=log, stderr=log, start_new_session=True)
    cli = None
    try:
        cli = serve.ServeClient("127.0.0.1", serve_port, connect_retry=180)
        probe = list(range(3, 10))
        ref = cli.submit(probe, max_new_tokens=8).wait_done(300.0)
        inflight = [cli.submit(list(range(2, 8 + i)), max_new_tokens=150)
                    for i in range(4)]
        next(iter(inflight[0].iter_tokens(timeout=120.0)))
        with open(pid_file) as f:      # rank 0 is the prefill rank
            os.kill(int(f.read().strip()), signal.SIGKILL)
        for h in inflight:
            try:
                h.wait_done(timeout=240.0)
            except serve.RequestFailedError as e:
                assert e.error in ("KVTransferError", "ChannelPeerGoneError",
                                   "PeerGoneError", "BackendGoneError",
                                   "BackendUnavailableError",
                                   "SchedulerClosedError"), e
        deadline = time.monotonic() + 300
        got = None
        while time.monotonic() < deadline:
            try:
                got = cli.submit(probe, max_new_tokens=8).wait_done(120.0)
                break
            except serve.RequestFailedError:
                time.sleep(1.0)
        assert got == ref, f"post-restart output diverged: {got}"
    finally:
        if cli is not None:
            cli.close()
        if launcher.poll() is None:
            launcher.send_signal(signal.SIGINT)
            try:
                launcher.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(launcher.pid, signal.SIGKILL)
                launcher.wait()
        log.close()
