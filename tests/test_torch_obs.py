"""The port's flight recorder (``tpu_dist_torch.obs``) against the JAX
package's (``tpu_dist.obs``).

Units: the ring buffer and its pending-span pinning, arming (disarmed
hooks are a shared no-op), spans (p2p spans take no collective sequence
number), store tails, the signal handlers off the main thread.  Parity:
the same event sequence through both recorders gives equal dumps once
timestamps and pids are dropped; each package's trace tools read the
other's dumps to the same diagnosis and the same merged trace; the port's
digest of a torch tree equals JAX's of the same numpy tree, bfloat16
included; the serve engine's request spans carry the JAX fields.  End to
end: one world-2 stalled-rank run through the port's launcher on the CPU,
held to the JAX acceptance run's assertions (``tests/test_obs.py``) but
its replay part.  Every check is exact."""

import json
import os
import subprocess
import sys
import textwrap
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_dist import obs as jobs
from tpu_dist.obs import hooks as jhooks
from tpu_dist.obs import recorder as jrec
from tpu_dist_torch import obs as tobs
from tpu_dist_torch.obs import hooks as thooks
from tpu_dist_torch.obs import recorder as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fields of a dump that differ between any two runs
_VOLATILE = ("pid", "wall_anchor_ns", "mono_anchor_ns", "mono_dump_ns")
_EV_VOLATILE = ("t0", "t1")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each test starts disarmed, with no recorder in either package."""
    for k in ("TPU_DIST_OBS", "TPU_DIST_OBS_DIR", "TPU_DIST_ROLE",
              "TPU_DIST_ROLE_RANK", "TPU_DIST_OBS_CAPACITY"):
        monkeypatch.delenv(k, raising=False)
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


def _arm(monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_DIST_OBS", "1")
    monkeypatch.setenv("TPU_DIST_OBS_DIR", str(tmp_path))
    jobs.reset()
    tobs.reset()


class TestRecorder:
    def test_ring_overwrite_keeps_newest_and_pins_pending(self):
        rec = tobs.FlightRecorder(capacity=4, rank=0, world=1, generation=0)
        ev = rec.begin("collective", "all_reduce", coll=0, site="x.py:1")
        for i in range(20):
            rec.record("store", f"ev{i}")
        evs = rec.snapshot()
        # the four newest plus the evicted pending span
        assert [e["seq"] for e in evs] == [0, 17, 18, 19, 20]
        assert evs[0]["outcome"] == "pending"
        rec.end(ev)
        assert all(e["outcome"] != "pending" for e in rec.snapshot())
        assert len(rec.snapshot()) == 4

    def test_capacity_env_and_last_position(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TPU_DIST_OBS_CAPACITY", "32")
        _arm(monkeypatch, tmp_path)
        assert tobs.get_recorder().capacity == 32
        rec = tobs.FlightRecorder(capacity=16, rank=2, world=4,
                                  generation=1)
        rec.end(rec.begin("collective", "broadcast", coll=5, site="t.py:9"))
        rec.record("beat", "beat", step=7)
        pos = rec.last_position()
        assert (pos["rank"], pos["generation"], pos["coll"], pos["op"],
                pos["outcome"]) == (2, 1, 5, "broadcast", "ok")

    def test_disarmed_is_a_shared_noop(self):
        assert not tobs.enabled() and tobs.get_recorder() is None
        ctx = thooks.collective_span("all_reduce")
        with ctx as ev:
            assert ev is None
        assert thooks.collective_span("broadcast") is ctx
        assert thooks.install_from_env() is None
        # counters are always on
        tobs.record_transport("send", "store", 10, 0.001)
        assert tobs.transport_counters()["send/store"]["calls"] == 1

    def test_spans_nesting_errors_and_p2p(self, monkeypatch, tmp_path):
        _arm(monkeypatch, tmp_path)
        with pytest.raises(RuntimeError):
            with thooks.collective_span("broadcast", src=0):
                with thooks.collective_span(
                        "ring_all_reduce", value=torch.zeros(4),
                        path="dataplane"):
                    raise RuntimeError("boom")
        with thooks.collective_span("send", dst=1, kind="p2p"):
            pass
        with thooks.collective_span("all_reduce",
                                    value=np.zeros(1024, np.float32),
                                    reduce_op="SUM") as ev:
            assert ev["outcome"] == "pending"
            tobs.record_transport("all_reduce", "store", 4096, 0.001)
        evs = tobs.get_recorder().snapshot()
        colls = [e for e in evs if e["kind"] == "collective"]
        assert [e["coll"] for e in colls] == [0, 1, 2]
        assert [e["outcome"] for e in colls[:2]] == ["error:RuntimeError"] * 2
        p2p = next(e for e in evs if e["kind"] == "p2p")
        assert "coll" not in p2p and p2p["dst"] == 1
        last = colls[-1]
        assert (last["reduce"], last["path"], last["bytes"]) == (
            "sum", "store", 4096)
        assert last["site"].startswith("test_torch_obs.py:")

    def test_tail_roundtrip_and_rank_lost_message(self, monkeypatch,
                                                  tmp_path):
        from tpu_dist_torch.dist.store import TCPStore
        from tpu_dist_torch.resilience import RankLostError
        _arm(monkeypatch, tmp_path)
        store = TCPStore(is_master=True)
        try:
            rec = tobs.FlightRecorder(capacity=16, rank=3, world=4,
                                      generation=2)
            rec.begin("collective", "all_reduce", coll=7, site="train.py:42")
            thooks.post_tail(store, rec)
            tail = thooks.fetch_tail(store, 2, 3)
            # either package's reader sees the same tail
            assert tail == jhooks.fetch_tail(store, 2, 3)
            assert tail["coll"] == 7 and tail["outcome"] == "pending"
            assert thooks.render_tail(tail) == jhooks.render_tail(tail)
            assert thooks.fetch_tail(store, 0, 3) is None
            err = RankLostError(1, 5.0, 3.0, last_payload=b"1:4:9",
                                obs_tail=tail)
            assert "last obs: collective #7" in str(err)
        finally:
            store.close()

    def test_signal_handlers_off_main_thread(self, monkeypatch, tmp_path):
        import signal
        _arm(monkeypatch, tmp_path)
        before = signal.getsignal(signal.SIGUSR1)
        errs = []

        def rank():
            try:
                thooks.install_signal_handlers()
            except Exception as e:  # a thread rank must not raise
                errs.append(e)

        t = threading.Thread(target=rank)
        t.start()
        t.join()
        assert not errs and signal.getsignal(signal.SIGUSR1) == before


# -- parity with the JAX recorder ---------------------------------------------


def _script(hooks, rec_mod, value, tree_tail):
    """One event sequence, driven through either package's hooks."""
    rec = rec_mod.get_recorder()
    with hooks.collective_span("all_reduce", value=value, reduce_op="sum"):
        hooks.note_algo("flat")
        rec_mod.record_transport("all_reduce", "dataplane", 4096, 0.01)
    with hooks.collective_span("broadcast", value=tree_tail, src=0):
        hooks.note_path("mesh")
    with hooks.collective_span("recv", src=1, kind="p2p"):
        pass
    rec.record("beat", "beat", step=3)
    rec.record("channel", "put", channel="traj", slot=4)
    with hooks.collective_span("all_gather", value=value, group="g0.1"):
        hooks.note_wire(128, "int8_block256", raw_bytes=512)
    rec.begin("collective", "reduce", coll=rec.next_coll(), site="s.py:1")


def _strip(doc):
    doc = {k: v for k, v in doc.items() if k not in _VOLATILE}
    doc["events"] = [{k: v for k, v in e.items() if k not in _EV_VOLATILE}
                     for e in doc["events"]]
    return doc


def test_same_events_give_equal_dumps(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("TPU_DIST_ROLE", "actor")
    monkeypatch.setenv("TPU_DIST_ROLE_RANK", "0")
    bf = np.arange(6, dtype=np.float32).reshape(2, 3)
    docs = {}
    for name, hooks, rec_mod, value, tail in (
            ("jax", jhooks, jrec, {"w": bf.astype(ml_dtypes.bfloat16),
                                   "b": np.zeros(4, np.int64)},
             [np.ones(3, np.float32), None]),
            ("port", thooks, trec, {"w": torch.tensor(bf, dtype=torch.bfloat16),
                                    "b": torch.zeros(4, dtype=torch.int64)},
             [torch.ones(3), None])):
        _script(hooks, rec_mod, value, tail)
        path = rec_mod.get_recorder().dump("test", dir=str(tmp_path / name))
        docs[name] = _strip(json.load(open(path)))
    assert docs["port"] == docs["jax"]
    assert docs["port"]["role"] == "actor" and docs["port"]["rank"] == 1
    assert any(e.get("digest") == "int64[4],bfloat16[2, 3]"
               for e in docs["port"]["events"])


@pytest.mark.parametrize("tree", [
    "scalars", "bf16", "nested", "many", "fp8"])
def test_digest_of_torch_tree_equals_jax_numpy(tree):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    if tree == "scalars":
        pair = (1.5, 2.5)
    elif tree == "bf16":
        pair = ({"x": a.astype(ml_dtypes.bfloat16), "y": a},
                {"x": torch.from_numpy(a).bfloat16(),
                 "y": torch.from_numpy(a)})
    elif tree == "nested":
        pair = ([np.arange(4), (a, None), {"k": np.bool_(True)}],
                [torch.arange(4), (torch.from_numpy(a), None),
                 {"k": np.bool_(True)}])
    elif tree == "many":
        pair = ([np.zeros(i + 1, np.int32) for i in range(20)],
                [torch.zeros(i + 1, dtype=torch.int32) for i in range(20)])
    else:
        pair = (a.astype(ml_dtypes.float8_e4m3fn),
                torch.from_numpy(a).to(torch.float8_e4m3fn))
    assert trec.digest(pair[1]) == jrec.digest(pair[0])


def _stall_dumps(rec_mod, out):
    """Two ranks' dumps of the straggler shape, plus a serve span and a
    store failover (the diagnosis reads both)."""
    for rank in (0, 1):
        rec = rec_mod.FlightRecorder(capacity=64, rank=rank, world=3,
                                     generation=0)
        for i in range(4):
            rec.end(rec.begin("collective", "all_reduce", coll=i,
                              site="train.py:10", reduce="sum"))
        if rank == 0:
            rec.begin("collective", "all_reduce", coll=4,
                      site="train.py:10", reduce="sum")
            rec.begin("serve", "request", req=7, prompt_len=5, slot=1,
                      site="serve.py:3")
            rec.record("store", "failover", key="h:2", old="h:1", epoch=1)
        rec.dump("signal:10", dir=str(out))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_tools_read_each_others_dumps(tmp_path, writer):
    _stall_dumps(jrec if writer == "jax" else trec, tmp_path)
    jd, td = jobs.read_dumps(str(tmp_path)), tobs.read_dumps(str(tmp_path))
    assert jd == td
    diag = tobs.diagnose(td)
    assert diag == jobs.diagnose(jd)
    assert (diag["verdict"], diag["straggler"], diag["stuck_coll"],
            diag["missing_ranks"]) == ("straggler", 1, 4, [2])
    assert diag["stuck_requests"][0]["req"] == 7
    assert diag["store_failovers"][0]["leader"] == "h:2"
    assert tobs.render_diagnosis(diag) == jobs.render_diagnosis(diag)
    assert tobs.merge_trace(td) == jobs.merge_trace(jd)


def test_serve_request_spans(monkeypatch, tmp_path):
    """The engine's request span: opened at submit, stamped at admission,
    closed with the outcome, the JAX engine's fields."""
    from tpu_dist_torch.serve.engine import Request, SlotEngine
    _arm(monkeypatch, tmp_path)
    req = Request(np.array([1, 2, 3]), 4)
    SlotEngine.obs_open(req)
    span = req.obs_span
    assert (span["kind"], span["op"], span["prompt_len"],
            span["max_new_tokens"], span["outcome"]) == (
        "serve", "request", 3, 4, "pending")
    d = tobs.diagnose([{"rank": 0, "world": 1, "events":
                        tobs.get_recorder().snapshot()}])
    assert d["stuck_requests"][0]["phase"] == "queued"
    req.t_admit = req.t_submit + 0.5
    SlotEngine._obs_admit(None, req, 2, req.t_admit + 0.25)
    SlotEngine._obs_end(None, req, "ok", reason="length")
    ev = tobs.get_recorder().snapshot()[-1]
    assert (ev["slot"], ev["queue_ns"], ev["prefill_ns"], ev["outcome"],
            ev["reason"]) == (2, 500_000_000, 250_000_000, "ok", "length")
    assert {"tokens", "decode_ns"} <= set(ev)


# -- world 2 through the port's launcher: the stalled rank --------------------

_STALL_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import tpu_dist_torch.dist as dist
    from tpu_dist_torch import collectives as C
    from tpu_dist_torch import resilience

    ckpt = sys.argv[1]
    pg = dist.init_process_group(init_method="env://", device="cpu")
    # monitor=False: the launcher's watchdog is under test
    with resilience.TrainState(ckpt, save_every=0, heartbeat_interval=0.2,
                               monitor=False) as ts:
        state, start = ts.resume({"x": np.zeros(1)})
        for step in range(start, 10):
            g = np.full(256, float(step), np.float32)
            C.all_reduce_host(g, group=pg, op="sum")  # the hang site
            ts.end_step(state, step)
    dist.destroy_process_group()
""")


def _obs_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.multiprocess
def test_world2_stalled_rank_yields_named_diagnosis(tmp_path):
    """Rank 1 stalls (sleep, frozen heartbeat and tail) at step 3 while
    rank 0 enters step 4's all_reduce and waits: the launcher names the
    lost rank with its last obs position and prints the positions table,
    and the dumps diagnose rank 1 behind, collective #4, at the worker's
    line — with the port's tools and the JAX package's alike."""
    script = tmp_path / "stall_worker.py"
    script.write_text(_STALL_WORKER)
    obs_dir = tmp_path / "obsdumps"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TPU_DIST_CHAOS"] = "stall:rank=1,step=3"
    env["TPU_DIST_OBS_DIR"] = str(obs_dir)
    env.pop("TPU_DIST_OBS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--nproc_per_node=2",
         "--master_port=0", "--heartbeat_timeout=3", "--flight-recorder",
         str(script), str(tmp_path / "ckpt")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "RankLostError" in r.stderr and "rank 1" in r.stderr, r.stderr
    assert "last obs:" in r.stderr and "all_reduce" in r.stderr
    assert "last known positions" in r.stderr
    assert "flight-recorder dumps in" in r.stderr

    dumps = tobs.read_dumps(str(obs_dir))
    assert {d["rank"] for d in dumps} == {0, 1}, r.stderr
    diag = tobs.diagnose(dumps)
    assert diag == jobs.diagnose(jobs.read_dumps(str(obs_dir)))
    assert (diag["verdict"], diag["straggler"], diag["straggler_last_coll"],
            diag["stuck_coll"]) == ("straggler", 1, 3, 4), diag
    assert "stall_worker.py" in (diag["stuck_site"] or ""), diag
    p = _obs_cli("diagnose", "--dir", str(obs_dir))
    assert p.returncode == 3 and "rank 1" in p.stdout and "#4" in p.stdout
    out = tmp_path / "trace.json"
    m = _obs_cli("merge", "--dir", str(obs_dir), "--out", str(out))
    assert m.returncode == 0, m.stderr
    tracks = {e["pid"] for e in json.load(open(out))["traceEvents"]
              if e.get("ph") == "X"}
    assert tracks == {0, 1}
    assert _obs_cli("diagnose", "--dir",
                    str(tmp_path / "none")).returncode == 1
