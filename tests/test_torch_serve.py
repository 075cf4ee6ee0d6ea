"""The port's serving layer (``tpu_dist_torch.serve``): engine rules,
scheduler semantics, the socket frontend and client, cancellation and
deadlines — the cases of ``tests/test_serve.py`` — and the wire against the
JAX package's: the same frame bytes, the same checksum, the JAX
``ServeClient`` streaming the JAX engine's tokens from a port ``Frontend``
and the port's client those of a JAX ``Frontend``.

The tiny model (vocab 251, dim 64, depth 2, heads 2, ``max_seq_len`` 64)
carries the weights of JAX ``model.init(jax.random.key(0))``.  Every socket
and every wait has its own timeout."""

import gc
import json
import socket
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from tpu_dist import serve as jserve
from tpu_dist.collectives import transport as jtransport
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.serve import frontend as jfrontend
from tpu_dist_torch import serve
from tpu_dist_torch.benchmarks import serve_lm
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.serve import _wire, frontend

pytestmark = pytest.mark.serve

CFG = dict(vocab_size=251, dim=64, depth=2, num_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.key(0))
    tree = {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}
    return jm, params, load_jax_params(TorchLM(**CFG, device="cpu"), tree)


def _gen_ref(tm, prompt, n, **kw):
    out = tm.generate(torch.as_tensor(np.asarray(prompt))[None], n, **kw)
    return out[0, len(prompt):].tolist()


def _engine(tm, slots):
    return serve.SlotEngine(tm, num_slots=slots, device="cpu")


def _drive(engine, req):
    engine.admit(req)
    while not engine.idle():
        engine.step()


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


class TestEngine:
    def test_batched_generate_equals_batch1(self, lm):
        _, _, tm = lm
        prompt = torch.from_numpy(
            np.random.default_rng(0).integers(0, 251, (4, 7)))
        batched = tm.generate(prompt, 6)
        for b in range(4):
            torch.testing.assert_close(batched[b],
                                       tm.generate(prompt[b:b + 1], 6)[0])

    def test_padded_prefill_logits(self, lm):
        # bucket padding must not perturb the last real token's logits
        _, _, tm = lm
        prompt = np.random.default_rng(2).integers(0, 251, 5)
        padded = np.zeros(16, np.int64)
        padded[:5] = prompt
        logits, _ = tm.prefill_into_slot(padded, 5, 1, tm.init_slot_cache(2))
        with torch.inference_mode():
            ref = tm(torch.from_numpy(prompt)[None], cache=tm.init_cache(1))
        torch.testing.assert_close(logits, ref[0, -1], rtol=1e-6, atol=1e-6)

    def test_sampling_reproducible_per_seed(self, lm):
        _, _, tm = lm
        prompt = np.arange(4, dtype=np.int32)
        runs = []
        for _ in range(2):
            toks = []
            _drive(_engine(tm, 2), serve.Request(
                prompt, 6, temperature=0.8, seed=7,
                on_token=lambda q, t: toks.append(t)))
            runs.append(toks)
        assert runs[0] == runs[1]
        assert len(runs[0]) == 6 and all(0 <= t < 251 for t in runs[0])
        assert runs[0] == _gen_ref(tm, prompt, 6, temperature=0.8,
                                   rng=serve.random_key(7))

    def test_eos_frees_slot(self, lm):
        _, _, tm = lm
        prompt = np.arange(5, dtype=np.int32)
        ref = _gen_ref(tm, prompt, 6)
        engine = _engine(tm, 2)
        done, toks = {}, []
        _drive(engine, serve.Request(
            prompt, 6, eos_id=ref[2], on_token=lambda q, t: toks.append(t),
            on_done=lambda q, reason: done.setdefault("reason", reason)))
        assert done["reason"] == "eos"
        assert toks == ref[:3]
        assert engine.free_slots() == 2

    def test_validate_and_device_rules(self, lm, monkeypatch):
        _, _, tm = lm
        engine = _engine(tm, 2)
        with pytest.raises(ValueError, match="exceeds the slot capacity"):
            engine.validate(60, 10)
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.validate(4, 0)
        with pytest.raises(ValueError, match="max_len 65 exceeds"):
            serve.SlotEngine(tm, max_len=65, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.SlotEngine(tm)


class TestScheduler:
    def test_coalesced_admission_and_completion(self, lm):
        _, _, tm = lm
        engine = _engine(tm, 4)
        with serve.Scheduler(engine, batch_window=0.05) as sched:
            prompt = np.arange(5, dtype=np.int32)
            handles = [sched.submit(prompt, max_new_tokens=5)
                       for _ in range(3)]
            ref = _gen_ref(tm, prompt, 5)
            for h in handles:
                assert h.wait_done(60.0) == ref
            # the window coalesced the burst: far fewer decode steps than
            # three sequential runs
            assert engine.stats()["decode_steps"] <= 10

    def test_queue_full_is_named(self, lm):
        _, _, tm = lm
        with serve.Scheduler(_engine(tm, 1), max_pending=1,
                             stage_depth=1) as sched:
            prompt = np.arange(4, dtype=np.int32)
            handles = [sched.submit(prompt, max_new_tokens=50, timeout=5.0)]
            with pytest.raises(serve.QueueFullError):
                for _ in range(16):
                    handles.append(sched.submit(prompt, max_new_tokens=50,
                                                timeout=0.05))
            for h in handles:     # everything accepted still completes
                h.wait_done(120.0)

    def test_drain_finishes_inflight_rejects_queued(self, lm):
        _, _, tm = lm
        with serve.Scheduler(_engine(tm, 1), batch_window=0.0) as sched:
            prompt = np.arange(4, dtype=np.int32)
            inflight = sched.submit(prompt, max_new_tokens=40)
            assert _wait(inflight.tokens, 30), "never started decoding"
            queued = sched.submit(prompt, max_new_tokens=40)
            assert sched.drain(timeout=60.0)
            assert len(inflight.wait_done(5.0)) == 40
            with pytest.raises(serve.SchedulerDrainingError):
                queued.wait_done(5.0)
            with pytest.raises(serve.SchedulerDrainingError):
                sched.submit(prompt, max_new_tokens=2)

    def test_decode_loop_death_fails_everything_by_name(self, lm):
        _, _, tm = lm
        engine = _engine(tm, 1)
        with serve.Scheduler(engine) as sched:
            prompt = np.arange(4, dtype=np.int32)
            inflight = sched.submit(prompt, max_new_tokens=40)
            assert _wait(inflight.tokens, 30), "never started decoding"
            queued = sched.submit(prompt, max_new_tokens=40)

            def boom():
                raise RuntimeError("device died")

            engine.step = boom
            for h in (inflight, queued):
                with pytest.raises(serve.SchedulerClosedError,
                                   match="device died"):
                    h.wait_done(30.0)
            with pytest.raises(serve.SchedulerClosedError,
                               match="device died"):
                sched.submit(prompt, max_new_tokens=2)

    def test_close_fails_pending_by_name(self, lm):
        _, _, tm = lm
        sched = serve.Scheduler(_engine(tm, 1))
        prompt = np.arange(4, dtype=np.int32)
        handles = [sched.submit(prompt, max_new_tokens=30)
                   for _ in range(4)]
        sched.close()
        outcomes = []
        for h in handles:
            try:
                h.wait_done(10.0)
                outcomes.append("done")
            except serve.SchedulerClosedError:
                outcomes.append("closed")
        assert len(outcomes) == 4 and "closed" in outcomes


@pytest.fixture()
def stack(lm):
    """A port engine (4 slots) behind a scheduler and a frontend."""
    _, _, tm = lm
    engine = _engine(tm, 4)
    sched = serve.Scheduler(engine, batch_window=0.002)
    fe = serve.Frontend(sched, port=0)
    yield engine, fe
    fe.close()
    sched.close()


class TestSocketLayer:
    def test_stream_roundtrip_interleaved_and_stats(self, stack, lm):
        _, _, tm = lm
        engine, fe = stack
        with serve.ServeClient("127.0.0.1", fe.port,
                               connect_retry=10) as cli:
            rng = np.random.default_rng(5)
            reqs = [(rng.integers(0, 251, int(rng.integers(3, 12))),
                     int(rng.integers(2, 8))) for _ in range(6)]
            handles = [cli.submit(p.tolist(), max_new_tokens=n)
                       for p, n in reqs]
            for h, (p, n) in zip(handles, reqs):
                assert h.wait_done(120.0) == _gen_ref(tm, p, n)
                assert h.reason == "length"
            stats = cli.stats(timeout=20.0)
        assert stats["completed"] == 6 and stats["free_slots"] == 4
        assert stats["backend"] == "default"

    def test_streaming_iterator(self, stack, lm):
        _, _, tm = lm
        _, fe = stack
        with serve.ServeClient("127.0.0.1", fe.port,
                               connect_retry=10) as cli:
            prompt = np.arange(6, dtype=np.int32)
            h = cli.submit(prompt.tolist(), max_new_tokens=5)
            assert list(h.iter_tokens(timeout=60.0)) == _gen_ref(tm, prompt,
                                                                 5)

    def test_invalid_request_error_frame(self, stack):
        _, fe = stack
        with serve.ServeClient("127.0.0.1", fe.port,
                               connect_retry=10) as cli:
            h = cli.submit(list(range(10)), max_new_tokens=500)
            with pytest.raises(serve.RequestFailedError) as ei:
                h.wait_done(30.0)
            assert ei.value.error == "ValueError"

    def test_client_fails_inflight_on_server_death(self):
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)

        def server():
            conn, _ = lst.accept()
            conn.recv(frontend._HELLO.size)
            conn.sendall(frontend._HELLO.pack(frontend._MAGIC,
                                              frontend._VERSION))
            time.sleep(0.3)
            conn.close()

        t = threading.Thread(target=server, daemon=True)
        t.start()
        cli = serve.ServeClient("127.0.0.1", lst.getsockname()[1],
                                connect_retry=5)
        h = cli.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(serve.ServerGoneError):
            h.wait_done(30.0)
        t.join(10.0)
        assert not t.is_alive()
        lst.close()
        cli.close()

    def test_close_ends_every_thread_and_frees_the_engine(self, lm):
        """``Frontend.close`` ends the connections still open and joins its
        threads, ``ServeClient.close`` joins its reader: nothing is left
        holding the scheduler, so the engine's pool is freed."""
        _, _, tm = lm
        before = set(threading.enumerate())
        engine = _engine(tm, 4)
        pool = weakref.ref(engine.cache["block0.attn"]["k"])
        sched = serve.Scheduler(engine, batch_window=0.002)
        fe = serve.Frontend(sched, port=0)
        cli = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10)
        idle = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10)
        prompt = np.arange(6, dtype=np.int32)
        assert cli.submit(prompt.tolist(), max_new_tokens=3).wait_done(
            60.0) == _gen_ref(tm, prompt, 3)
        assert _wait(lambda: len(fe._conns) == 2)
        fe.close()        # ``idle`` is still connected
        sched.close()
        cli.close()
        idle.close()
        assert [t.name for t in set(threading.enumerate()) - before] == []
        del engine, sched, fe, cli, idle
        gc.collect()
        assert pool() is None

    def test_store_waits_for_the_launcher_slice(self, lm):
        _, _, tm = lm
        sched = serve.Scheduler(_engine(tm, 1))
        try:
            with pytest.raises(NotImplementedError, match="A5"):
                serve.Frontend(sched, port=0, store=object())
        finally:
            sched.close()


class TestCancellationAndDeadlines:
    @pytest.mark.parametrize("how", ["cancel", "deadline"])
    def test_slot_freed_at_next_iteration_boundary(self, lm, how):
        _, _, tm = lm
        engine = _engine(tm, 2)
        errs = []
        r = serve.Request(np.arange(4, dtype=np.int32), 30,
                          deadline_ms=30 if how == "deadline" else None,
                          on_error=lambda q, e: errs.append(e))
        engine.admit(r)
        engine.step()
        assert engine.active_count() == 1
        if how == "cancel":
            r.cancel()
        else:
            time.sleep(0.05)  # past the 30 ms budget
        assert engine.sweep_expired() == 1
        assert engine.idle() and engine.free_slots() == 2
        want = (serve.RequestCancelledError if how == "cancel"
                else serve.DeadlineExceededError)
        assert isinstance(errs[0], want)

    def test_expired_request_is_shed_before_admission(self, lm):
        _, _, tm = lm
        engine = _engine(tm, 2)
        r = serve.Request(np.arange(4, dtype=np.int32), 4, deadline_ms=1)
        time.sleep(0.01)
        with pytest.raises(serve.DeadlineExceededError):
            engine.admit(r)
        assert engine.idle()

    def test_scheduler_handle_cancel_terminates_by_name(self, lm):
        _, _, tm = lm
        engine = _engine(tm, 2)
        with serve.Scheduler(engine, batch_window=0.0) as sched:
            h = sched.submit(list(range(4)), max_new_tokens=50)
            for _ in h.iter_tokens(timeout=30.0):
                break             # the cancel lands mid-decode
            h.cancel()
            with pytest.raises(serve.RequestCancelledError):
                h.wait_done(10.0)
            assert _wait(engine.idle), "slot not freed at a boundary"

    def test_client_disconnect_cancels(self, stack):
        engine, fe = stack
        cli = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10)
        h = cli.submit(list(range(4)), max_new_tokens=50)
        for _ in h.iter_tokens(timeout=30.0):
            break                 # at least one token decoded
        cli.close()               # the client vanishes mid-decode
        assert _wait(engine.idle), "slot not freed after disconnect"
        assert engine.completed == 0

    @pytest.mark.parametrize("how", ["deadline", "cancel"])
    def test_over_the_wire_names_the_error(self, stack, how):
        _, fe = stack
        with serve.ServeClient("127.0.0.1", fe.port,
                               connect_retry=10) as cli:
            if how == "deadline":
                h = cli.submit(list(range(4)), max_new_tokens=50,
                               deadline_ms=25)
            else:
                h = cli.submit(list(range(4)), max_new_tokens=55)
                h.cancel()        # sends the cancel frame
            with pytest.raises(serve.RequestFailedError) as ei:
                h.wait_done(30.0)
        assert ei.value.error == ("DeadlineExceededError"
                                  if how == "deadline"
                                  else "RequestCancelledError")


class TestWireAgainstJax:
    FRAMES = [{"type": "submit", "id": 1, "prompt": [1, 2, 3],
               "max_new_tokens": 4, "temperature": 0.0, "eos_id": None,
               "seed": 0},
              {"type": "token", "id": 7, "t": 250},
              {"type": "error", "id": 3, "error": "ValueError",
               "detail": "prompt (60) + max_new_tokens (10) — ü"},
              {"type": "stats", "id": 2, "stats": {"occupancy": 0.25}}]

    def test_send_frame_bytes_identical(self):
        a, b = socket.socketpair()
        a.settimeout(10.0)
        b.settimeout(10.0)
        try:
            for obj in self.FRAMES:
                frontend.send_frame(a, obj)
                ours = b.recv(1 << 16)
                jfrontend.send_frame(a, obj)
                theirs = b.recv(1 << 16)
                assert ours == theirs
                # and each side reads the other's frame
                jfrontend.send_frame(a, obj)
                assert frontend.read_frame(b) == obj
        finally:
            a.close()
            b.close()

    def test_checksum_resolves_like_the_jax_package(self):
        # both ends of a connection must checksum alike: this holds where
        # the two resolve the same implementation, as on one host
        for n in (0, 1, 7, 4096, 100_003):
            data = np.random.default_rng(n).bytes(n)
            assert (_wire.frame_checksum((data,))
                    == jtransport.frame_checksum((data,)))
        assert _wire.frame_checksum((b"123456789",)) == \
            jtransport.frame_checksum((b"123456789",))

    def test_jax_client_streams_from_a_port_frontend(self, stack, lm):
        """The JAX package's client against the port's frontend gets the
        JAX engine's tokens; the port's client against the JAX package's
        frontend gets the port engine's."""
        jm, params, tm = lm
        _, fe = stack
        rng = np.random.default_rng(6)
        reqs = [(rng.integers(0, 251, int(rng.integers(3, 12))).tolist(),
                 int(rng.integers(2, 8))) for _ in range(3)]
        jengine = jserve.SlotEngine(jm, params, num_slots=4)
        jsched = jserve.Scheduler(jengine, batch_window=0.002)
        jfe = jserve.Frontend(jsched, port=0)
        try:
            with jserve.ServeClient("127.0.0.1", fe.port,
                                    connect_retry=10) as jcli, \
                    serve.ServeClient("127.0.0.1", jfe.port,
                                      connect_retry=10) as cli:
                from_port = [jcli.submit(p, max_new_tokens=n)
                             for p, n in reqs]
                from_jax = [cli.submit(p, max_new_tokens=n)
                            for p, n in reqs]
                for a, b in zip(from_port, from_jax):
                    assert a.wait_done(120.0) == b.wait_done(120.0)
                    assert a.reason == b.reason == "length"
        finally:
            jfe.close()
            jsched.close()


def test_latency_histogram_matches_jax():
    """The engine's stats read like the JAX package's: same buckets, same
    ``summary()``."""
    from tpu_dist.utils.metrics import LatencyHistogram as JaxHistogram
    from tpu_dist_torch.utils import LatencyHistogram

    ours, theirs = LatencyHistogram(), JaxHistogram()
    for v in np.random.default_rng(0).lognormal(-5, 2, 500):
        ours.observe(v)
        theirs.observe(v)
    assert ours.summary() == theirs.summary()
    assert LatencyHistogram().summary() == JaxHistogram().summary()


def test_serve_lm_benchmark_runs_both_modes():
    """The benchmark at a tiny width on the CPU: both batching modes serve
    every request with the same tokens, for both caches, and the
    sustained-rate sweep serves its list too."""
    res = serve_lm.run(requests=12, config=dict(CFG, max_seq_len=128),
                       device="cpu")
    assert res["requests_differing_between_modes"] == 0
    assert [(r["cache"], r["mode"]) for r in res["rows"]] == [
        (cache, mode) for cache in ("float32", "int8")
        for mode in ("static", "continuous", "sweep", "sweep", "sweep",
                     "continuous_vs_static")]
    for r in res["rows"]:
        if r["mode"] == "continuous_vs_static":
            assert r["tokens_per_s_ratio"] > 0
            continue
        assert r["generated_tokens"] > 0 and 0 < r["occupancy"] <= 1
        if r["mode"] != "sweep":
            assert r["generated_tokens"] == res["new_tokens"]
    json.dumps(res)


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_lm_workload_is_bench_serves(seed):
    """The benchmark's traffic is bench_serve's: request for request at its
    160-position pool, prompt lengths scaled to a 2048-position one."""
    from benchmarks.bench_serve import _workload

    ours = serve_lm.workload(96, seed=seed, max_len=160)
    for r, (prompt, gen) in zip(ours, _workload(96, seed=seed),
                                strict=True):
        np.testing.assert_array_equal(r["prompt"], prompt)
        assert (r["max_new_tokens"], r["temperature"]) == (gen, 0.0)
    full = serve_lm.workload(96, seed=seed)
    assert [len(r["prompt"]) for r in full] == [
        round(len(r["prompt"]) * 2048 / 160) for r in ours]
    assert {len(r["prompt"]) for r in full} <= {77, 154, 307, 512}
    for a, b in zip(full, ours):
        np.testing.assert_array_equal(a["prompt"][:len(b["prompt"])],
                                      b["prompt"])
        assert a["max_new_tokens"] == b["max_new_tokens"]
