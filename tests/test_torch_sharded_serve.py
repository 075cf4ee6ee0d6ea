"""Tensor-parallel sharded decode on the port (``tpu_dist_torch.serve.
sharded``) against the JAX package — the twin of
``tests/test_sharded_serve.py``.

The model is the JAX test's (vocab 61, dim 24, depth 2, 12 heads, 64
positions, ``init(jax.random.key(0))``), its weights carried into the port
through ``interop``.  Shard trees and checkpoint range-reads are held bit
for bit to the JAX package's; one ``decode_pool`` and one ``prefill_pool``
at shard worlds 2-4 to its ``ShardedDecoder``'s logits within 1e-5; the
sharded greedy tokens to JAX ``generate()`` at worlds 2-4 and the sharded
temperature stream to the JAX single-rank engine's, token for token; every
follower's token stream to the leader's.  Ranks run as threads over
in-process DataPlanes, as in the JAX tests.  The SIGKILL gang-restart
twin is slow, as in JAX; the card covers it (``chip_smoke.py``
``serve_sharded``)."""

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

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=61, dim=24, depth=2, num_heads=12, max_seq_len=64)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lm12():
    """The JAX test's model (12 heads, MLP 96: every world 2-4 divides
    them) and the port's with the same weights."""
    jmodel = JaxLM(**CFG)
    params = jmodel.init(jax.random.key(0))
    np_params = {p: {n: np.asarray(a) for n, a in d.items()}
                 for p, d in params.items()}
    model = TransformerLM(CFG["vocab_size"], dim=CFG["dim"],
                          depth=CFG["depth"], num_heads=CFG["num_heads"],
                          max_seq_len=CFG["max_seq_len"], device="cpu")
    interop.load_jax_params(model, np_params)
    return jmodel, params, np_params, model


@pytest.fixture()
def store():
    s = TCPStore(is_master=True, timeout=60)
    yield s
    s.close()


def _jax_refs(jmodel, params, reqs):
    out = []
    for p, g in reqs:
        toks = jmodel.generate(params, jnp.asarray(p)[None, :], g)
        out.append(np.asarray(toks)[0, len(p):].tolist())
    return out


def _reqs():
    rng = np.random.default_rng(1)
    return [(rng.integers(0, 61, int(n)).astype(np.int32), int(g))
            for n, g in ((5, 6), (13, 4), (3, 7), (9, 2))]


def _drive(reqs, temps=None, seeds=None):
    """The JAX test's driver: one admission per decode step."""
    def drive(engine):
        return bench.drive_engine(engine, [
            {"prompt": p, "max_new_tokens": g,
             "temperature": 0.0 if temps is None else temps[i],
             "seed": 0 if seeds is None else seeds[i]}
            for i, (p, g) in enumerate(reqs)])
    return drive


class TestShardLayout:
    @pytest.mark.parametrize("world", [1, 2, 3, 4])
    def test_shard_params_equal_jax_leaf_for_leaf(self, lm12, world):
        jmodel, params, np_params, model = lm12
        carried = interop.jax_params(model)
        for r in range(world):
            want = jserve.shard_params(jmodel, params, r, world)
            for tree in (serve.shard_params(model, np_params, r, world),
                         serve.shard_params(model, carried, r, world)):
                assert set(tree) == set(want)
                for path in want:
                    assert set(tree[path]) == set(want[path]), (r, path)
                    for name in want[path]:
                        w = np.asarray(want[path][name])
                        assert tree[path][name].dtype == w.dtype
                        np.testing.assert_array_equal(tree[path][name], w)

    def test_shard_tree_loads_into_sharded_lm_through_interop(self, lm12):
        """A shard tree binds to the ShardedLM's parameter paths through
        ``interop`` (torch's (out, in) layout) and comes back out of it bit
        for bit; ranks above 0 carry the qkv bias and no out bias."""
        jmodel, params, np_params, model = lm12
        for r in range(3):
            tree = serve.shard_params(model, np_params, r, 3)
            slm = serve.ShardedLM(model, r, 3)
            interop.load_jax_params(slm, tree)
            back = interop.jax_params(slm)
            assert set(back) == set(tree)
            for path in tree:
                for name in tree[path]:
                    np.testing.assert_array_equal(back[path][name],
                                                  tree[path][name])
            attn = slm.block0.attn
            assert attn.qkv_weight.shape == (3 * 4 * 2, 24)
            assert attn.out_weight.shape == (24, 4 * 2)
            assert (attn.out_bias is not None) == (r == 0)
            assert attn.qkv_bias is not None
            assert (slm.block0.mlp[2].bias is not None) == (r == 0)

    def test_shard_shapes_and_bias_placement(self, lm12):
        _, _, np_params, model = lm12
        for W in (2, 3, 4):
            for r in range(W):
                sp = serve.shard_params(model, np_params, r, W)
                nl, hd = 12 // W, 2
                a = sp["block0.attn"]
                assert a["qkv_weight"].shape == (24, 3 * nl * hd)
                assert a["out_weight"].shape == (nl * hd, 24)
                assert ("out_bias" in a) == (r == 0)
                m2 = sp["block0.mlp.2"]
                assert m2["weight"].shape == (96 // W, 24)
                assert ("bias" in m2) == (r == 0)
                np.testing.assert_array_equal(sp["head"]["weight"],
                                              np_params["head"]["weight"])

    def test_shards_reassemble_the_full_qkv(self, lm12):
        _, _, np_params, model = lm12
        full = np_params["block1.attn"]["qkv_weight"]
        got = np.zeros_like(full)
        view = got.reshape(24, 3, 12, 2)
        for r in range(3):
            view[:, :, r * 4:(r + 1) * 4, :] = serve.shard_params(
                model, np_params, r, 3)["block1.attn"][
                    "qkv_weight"].reshape(24, 3, 4, 2)
        np.testing.assert_array_equal(got, full)

    def test_named_config_errors(self, lm12):
        _, _, np_params, model = lm12
        with pytest.raises(serve.ShardConfigError, match="not divisible"):
            serve.shard_params(model, np_params, 0, 5)
        with pytest.raises(serve.ShardConfigError, match="data plane"):
            serve.ShardedDecoder(model, serve.shard_params(
                model, np_params, 0, 2), None, 0, 2)
        slm = serve.ShardedLM(model, 0, 2)
        with pytest.raises(serve.ShardConfigError, match="partial"):
            slm(torch.zeros((1, 4), dtype=torch.long))
        with pytest.raises(serve.ShardConfigError, match="out of range"):
            serve.ShardedLM(model, 2, 2)
        moe = TransformerLM(61, dim=24, depth=1, num_heads=12, num_experts=2,
                            max_seq_len=16, device="cpu")
        with pytest.raises(serve.ShardConfigError, match="MoE"):
            serve.ShardedLM(moe, 0, 2)

    def test_from_checkpoint_of_a_jax_written_checkpoint(self, lm12,
                                                         tmp_path):
        """A checkpoint the JAX package wrote, range-read into every rank's
        layout at worlds 2 and 3: bit for bit the JAX package's own
        range-read and the in-memory shards; and the port's own save of the
        JAX-layout tree reads back the same."""
        from tpu_dist import checkpoint as jckpt
        from tpu_dist_torch import checkpoint as ckpt

        jmodel, params, np_params, model = lm12
        jckpt.save(str(tmp_path / "jax"), params, step=7)
        ckpt.save(str(tmp_path / "port"), interop.jax_params(model), step=3)
        for W in (2, 3):
            for r in range(W):
                want = jserve.ShardedParams.from_checkpoint(
                    str(tmp_path / "jax"), jmodel, r, W)
                ref = serve.shard_params(model, np_params, r, W)
                for root in ("jax", "port"):
                    got = serve.ShardedParams.from_checkpoint(
                        str(tmp_path / root), model, r, W)
                    assert set(got) == set(want) == set(ref)
                    for path in want:
                        assert set(got[path]) == set(want[path])
                        for name in want[path]:
                            np.testing.assert_array_equal(
                                got[path][name], np.asarray(
                                    want[path][name]))
                            np.testing.assert_array_equal(
                                got[path][name], ref[path][name])

    def test_from_checkpoint_refuses_a_train_state_tree(self, lm12,
                                                       tmp_path):
        from tpu_dist_torch import checkpoint as ckpt
        _, _, _, model = lm12
        ckpt.save(str(tmp_path),
                  {"params": {"block0.attn": {"w": np.zeros(3, np.float32)}}},
                  step=0)
        with pytest.raises(serve.ShardConfigError, match="parameter tree"):
            serve.ShardedParams.from_checkpoint(str(tmp_path), model, 0, 2)


# ---------------------------------------------------------------------------
# the decoder's logits against the JAX package's ShardedDecoder
# ---------------------------------------------------------------------------

def _jax_segments(jdec, params, cache, toks, index, fresh=None):
    """JAX ``ShardedDecoder.decode_pool``/``prefill_pool``'s segment loop,
    returning the logits its head samples from (its own compiled segments
    and combines)."""
    out = dict(cache if fresh is None else fresh)
    p0 = jdec._layer_paths[0]
    x, part, out[p0] = jdec._embed_attn0(params, toks, index, out[p0])
    add = None
    for i in range(jdec.depth):
        if i > 0:
            path = jdec._layer_paths[i]
            x, part, out[path] = jdec._attn[i](params, x, add, out[path],
                                              index)
        attn_out = jdec.all_reduce(part)
        x, part2 = jdec._mlp[i](params, x, attn_out)
        add = jdec.all_reduce(part2)
    return np.asarray(jdec.slm.apply(params, x, add, op="head")), out


def _jax_rank(jmodel, params, dp, r, world):
    """One JAX rank: prefill a 5-token prompt (padded to 16) into slot 1,
    then one decode step of the 3-slot pool; the two logits."""
    jdec = jserve.ShardedDecoder(
        jmodel, jserve.shard_params(jmodel, params, r, world), dp, r, world)
    params = jdec.params             # this rank's shard tree
    cache = jdec.init_slot_cache(3, 64, jnp.float32)
    prompt = np.zeros(16, np.int32)
    prompt[:5] = [3, 14, 15, 9, 26]
    fresh = jdec.slm.init_slot_cache(1, 64, jnp.float32)
    logits, rows = _jax_segments(jdec, params, cache,
                                 jnp.asarray(prompt)[None, :],
                                 jnp.zeros((), jnp.int32), fresh=fresh)
    pf = logits[0, 4]
    cache = jdec._write(cache, rows, np.int32(1))
    tok = int(pf.argmax())
    dec, _ = _jax_segments(jdec, params, cache,
                           jnp.asarray([0, tok, 0], jnp.int32)[:, None],
                           jnp.asarray([0, 5, 0], jnp.int32))
    return pf, dec[:, -1], tok


def _port_rank(model, np_params, dp, r, world):
    dec = serve.ShardedDecoder(model, serve.shard_params(
        model, np_params, r, world), dp, r, world)
    with torch.inference_mode():
        cache = dec.init_slot_cache(3, 64, torch.float32)
    prompt = np.zeros(16, np.int64)
    prompt[:5] = [3, 14, 15, 9, 26]
    pf, cache = dec.prefill_pool(prompt, 5, 1, cache)
    tok = int(pf.argmax())
    logits, cache = dec.decode_pool([0, tok, 0], [0, 5, 0], cache)
    return pf.numpy(), logits.numpy(), tok


def _threads(world, fn):
    out, errs = [None] * world, []

    def run(r):
        try:
            out[r] = fn(r)
        except Exception:
            import traceback
            errs.append((r, traceback.format_exc()))

    ts = [threading.Thread(target=run, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(240)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts), "a rank hung"
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_decoder_logits_match_jax_sharded_decoder(lm12, world):
    jmodel, params, np_params, model = lm12
    s1, s2 = TCPStore(is_master=True, timeout=60), TCPStore(is_master=True,
                                                             timeout=60)
    jdps = [JT.DataPlane(s1, r, world) for r in range(world)]
    tdps = [TT.DataPlane(s2, r, world) for r in range(world)]
    try:
        want = _threads(world, lambda r: _jax_rank(jmodel, params, jdps[r],
                                                   r, world))
        got = _threads(world, lambda r: _port_rank(model, np_params,
                                                   tdps[r], r, world))
    finally:
        for dp in jdps + tdps:
            dp.close()
        s1.close()
        s2.close()
    for r in range(world):
        # every rank of a group holds the same bytes (lockstep)
        np.testing.assert_array_equal(got[r][0], got[0][0])
        np.testing.assert_array_equal(got[r][1], got[0][1])
        np.testing.assert_allclose(got[r][0], want[r][0], **TOL)
        np.testing.assert_allclose(got[r][1], want[r][1], **TOL)
        assert got[r][2] == want[r][2]


# ---------------------------------------------------------------------------
# token parity
# ---------------------------------------------------------------------------

class TestShardedParity:
    def test_greedy_tokens_equal_jax_generate_worlds_2_3_4(self, lm12):
        """Sharded greedy decode == JAX ``generate()`` token for token at
        shard worlds 2-4 (mixed prompts, one bucket-padded prefill), and
        every follower's stream is the leader's, slot by slot."""
        jmodel, params, _, model = lm12
        reqs = _reqs()
        refs = _jax_refs(jmodel, params, reqs)
        for world in (2, 3, 4):
            res = bench.shard_world_threads(model, world, _drive(reqs))
            assert res["out"]["outputs"] == refs, f"world {world} diverged"
            for r in range(1, world):
                cause, streams = res[r]
                assert cause == "shutdown"
                assert streams == res["out"]["finished"], (world, r)

    def test_temperature_matches_jax_single_rank_engine(self, lm12):
        jmodel, params, _, model = lm12
        prompt = np.arange(1, 7, dtype=np.int32)
        single = jserve.SlotEngine(jmodel, params, num_slots=2)
        outs = {}
        r = jserve.Request(prompt, 6, temperature=0.8, seed=11,
                           on_token=lambda q, t: outs.setdefault(
                               q.id, []).append(t))
        single.admit(r)
        while not single.idle():
            single.step()
        ref = outs[r.id]
        res = bench.shard_world_threads(
            model, 2, _drive([(prompt, 6)], temps=[0.8], seeds=[11]),
            slots=2)
        assert res["out"]["outputs"] == [ref]
        assert res[1][1] == res["out"]["finished"]
        assert len(ref) == 6 and all(0 <= t < 61 for t in ref)

    def test_int8_wire_opt_in_stays_in_lockstep(self, lm12):
        _, _, _, model = lm12
        reqs = [(np.arange(2, 10, dtype=np.int32), 5),
                (np.arange(1, 5, dtype=np.int32), 4)]
        res = bench.shard_world_threads(model, 2, _drive(reqs),
                                        comm_dtype="int8_block256")
        out = res["out"]
        assert [len(t) for t in out["outputs"]] == [5, 4]
        assert all(0 <= t < 61 for ts in out["outputs"] for t in ts)
        assert res[1][1] == out["finished"]

    def test_combine_takes_exchange_below_and_ring_above(self, lm12, store):
        """Small partials take the direct exchange, large ones (and every
        comm_dtype) the ring; both give the same bytes on every rank."""
        _, _, np_params, model = lm12
        dps = [TT.DataPlane(store, r, 2) for r in range(2)]
        try:
            decs = [serve.ShardedDecoder(model, serve.shard_params(
                model, np_params, r, 2), dps[r], r, 2) for r in range(2)]
            small = [torch.full((4, 24), float(r + 1)) for r in range(2)]
            big = [torch.arange(40000, dtype=torch.float32) * (r + 1)
                   for r in range(2)]
            got = _threads(2, lambda r: (decs[r].all_reduce(small[r]),
                                         decs[r].all_reduce(big[r])))
        finally:
            for dp in dps:
                dp.close()
        for r in range(2):
            assert torch.equal(got[r][0], torch.full((4, 24), 3.0))
            assert torch.equal(got[r][1], big[0] * 3)
            assert decs[r].algo_counts == {"exchange": 1, "ring": 1}

    def test_follower_death_fails_leader_by_name(self, lm12, store):
        """A dead shard surfaces as the leader's named PeerGoneError at the
        next combine; the scheduler records it as the fatal cause and
        refuses new submits by name."""
        _, _, np_params, model = lm12
        dps = [TT.DataPlane(store, r, 2) for r in range(2)]
        dec = serve.ShardedDecoder(model, serve.shard_params(
            model, np_params, 0, 2), dps[0], 0, 2)
        fdec = serve.ShardedDecoder(model, serve.shard_params(
            model, np_params, 1, 2), dps[1], 1, 2)
        engine = serve.ShardedSlotEngine(dec, num_slots=2)
        follower = serve.ShardFollower(fdec, num_slots=2)
        left = [3]

        def run_follower():
            while left[0] > 0:
                try:
                    plan = follower.recv_plan(timeout=30.0)
                except TimeoutError:
                    return
                follower.apply_plan(plan)
                left[0] -= 1
            dps[1].close()

        ft = threading.Thread(target=run_follower, daemon=True)
        ft.start()
        sched = serve.Scheduler(engine, batch_window=0.0)
        try:
            h = sched.submit(list(range(1, 6)), max_new_tokens=30)
            with pytest.raises(serve.SchedulerClosedError,
                               match="PeerGoneError"):
                h.wait_done(60.0)
            assert isinstance(sched.fatal, TT.PeerGoneError)
            with pytest.raises(serve.SchedulerClosedError):
                sched.submit([1, 2], max_new_tokens=2)
        finally:
            ft.join(30)
            sched.close()
            for dp in dps:
                dp.close()

    def test_failed_prefill_after_the_plan_poisons_the_group(self, lm12):
        """The scheduler's fatal probe after a failed admit: a leader whose
        prefill fails AFTER its admit plan went out reports a poisoned
        lockstep, and the scheduler shuts down with it by name."""
        _, _, np_params, model = lm12
        dec = serve.ShardedDecoder(model, serve.shard_params(
            model, np_params, 0, 1), None, 0, 1)
        engine = serve.ShardedSlotEngine(dec, num_slots=2)

        def boom(*a, **k):
            raise RuntimeError("device fault mid-prefill")
        engine._prefill = boom
        sched = serve.Scheduler(engine, batch_window=0.0)
        try:
            h = sched.submit(list(range(1, 6)), max_new_tokens=3)
            with pytest.raises(RuntimeError, match="mid-prefill"):
                h.wait_done(30.0)
            deadline = time.monotonic() + 10
            while sched.fatal is None and time.monotonic() < deadline:
                time.sleep(0.05)
            assert isinstance(sched.fatal, serve.ShardPlanError)
            assert "lost lockstep" in str(engine.fatal_error)
            with pytest.raises(serve.SchedulerClosedError):
                sched.submit([1, 2], max_new_tokens=2)
        finally:
            sched.close()


class TestShardedIdleProbe:
    def test_follower_ping_plan_is_noop(self):
        f = SimpleNamespace(plans_applied=0)
        assert serve.ShardFollower.apply_plan(f, {"op": "ping"}) is not False
        assert f.plans_applied == 1

    def _leader_stub(self, world=2, idle_for=10.0):
        pings = []
        stub = SimpleNamespace(
            decoder=SimpleNamespace(world=world), _poisoned=None,
            _closed_plan_sent=False, _last_plan=time.monotonic() - idle_for,
            _bcast=lambda plan: pings.append(plan))
        return stub, pings

    def test_idle_leader_pings_after_probe_interval(self, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SERVE_PROBE", "0.5")
        stub, pings = self._leader_stub(idle_for=10.0)
        serve.ShardedSlotEngine._probe_followers(stub)
        assert pings == [{"op": "ping"}]

    def test_busy_or_disabled_probe_stays_quiet(self, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SERVE_PROBE", "5.0")
        stub, pings = self._leader_stub(idle_for=0.0)
        serve.ShardedSlotEngine._probe_followers(stub)
        assert pings == []
        monkeypatch.setenv("TPU_DIST_SERVE_PROBE", "0")
        stub, pings = self._leader_stub(idle_for=100.0)
        serve.ShardedSlotEngine._probe_followers(stub)
        assert pings == []
        monkeypatch.setenv("TPU_DIST_SERVE_PROBE", "0.1")
        stub, pings = self._leader_stub(world=1)
        serve.ShardedSlotEngine._probe_followers(stub)
        assert pings == []

    def test_unknown_plan_and_slot_drift_are_named(self, lm12):
        _, _, np_params, model = lm12
        f = SimpleNamespace(plans_applied=0, num_slots=2)
        with pytest.raises(serve.ShardPlanError, match="unknown"):
            serve.ShardFollower.apply_plan(f, {"op": "warp"})
        f._check_slot = lambda s: serve.ShardFollower._check_slot(f, s)
        with pytest.raises(serve.ShardPlanError, match="num_slots"):
            serve.ShardFollower.apply_plan(f, {"op": "free", "slots": [5]})


def test_bench_serve_sharded_smoke():
    """The benchmark twin's smoke row: a world-2 group's streamed tokens
    against ``generate()`` and the follower's stream, in one process."""
    row = bench.run_sharded(smoke=True, device="cpu")
    assert row["tokens_ok"] is True and row["shard_world"] == 2
    assert row["tokens_per_sec"] > 0


# ---------------------------------------------------------------------------
# subprocess chaos: a real SIGKILL under the launcher (slow, as in JAX)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("TPU_DIST_CHAOS", None)
    return env


@pytest.mark.chaos
@pytest.mark.multiprocess
@pytest.mark.slow
def test_shard_rank_sigkill_gang_restart_resume(tmp_path):
    """SIGKILL the follower of a world-2 group under load: every in-flight
    handle ends bounded with a named error, the launcher's gang restart
    re-forms the group, and the SAME client connection reproduces the
    pre-kill tokens bit for bit."""
    serve_port = _free_port()
    pid_file = str(tmp_path / "worker.pid")
    log = open(tmp_path / "launcher.log", "w")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--nproc_per_node", "2", "--max_restarts", "2", "--serve",
         "--serve_port", str(serve_port), "-m",
         "tpu_dist_torch.examples.serve_lm", "--tiny", "--device", "cpu",
         "--sharded", "--pid-file", pid_file, "--run-seconds", "600"],
        env=_env(), cwd=REPO, stdout=log, stderr=log,
        start_new_session=True)
    cli = None
    try:
        cli = serve.ServeClient("127.0.0.1", serve_port, connect_retry=180)
        probe = list(range(3, 10))
        ref = cli.submit(probe, max_new_tokens=8).wait_done(300.0)
        inflight = [cli.submit(list(range(2, 8 + i)), max_new_tokens=150)
                    for i in range(4)]
        next(iter(inflight[0].iter_tokens(timeout=120.0)))
        with open(pid_file + ".r1") as f:
            os.kill(int(f.read().strip()), signal.SIGKILL)
        named = 0
        for h in inflight:
            try:
                h.wait_done(timeout=180.0)
            except serve.RequestFailedError as e:
                assert e.error in ("BackendGoneError",
                                   "BackendUnavailableError",
                                   "SchedulerClosedError", "PeerGoneError",
                                   "ShardPlanError"), e
                named += 1
        assert named >= 1
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
