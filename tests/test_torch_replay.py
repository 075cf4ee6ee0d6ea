"""The port's offline trace replay (``tpu_dist_torch.analysis.replay``)
against the JAX package's.

The synthetic dumps of tests/test_replay.py — lockstep divergence (TD110),
store-key lifecycle (TD111), channel cursors (TD112/TD113), serve plan
pairing (TD114), the hang verdict (TD115) — go through both replays, which
must give identical findings and diagnoses.  Then dumps the port's own
recorder wrote: a world-2 gloo job under the port's launcher whose rank 1
stalls (``TPU_DIST_CHAOS``), replayed by both packages (TD115 names rank
1), whose ``replay --format json`` diagnosis is the port's ``obs diagnose
--json``, and whose ranks checked ``utils.collective_counters`` against
the recorder's counters after their store-routed all_reduces; and a live
multi-consumer Channel's orphaned claim.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from tpu_dist import obs as jobs
from tpu_dist.analysis import replay as jreplay
from tpu_dist.analysis.__main__ import main as jmain
from tpu_dist_torch import obs as tobs
from tpu_dist_torch.analysis import replay as treplay
from tpu_dist_torch.analysis.__main__ import main as tmain
from tpu_dist_torch.obs.__main__ import main as tobs_main

pytestmark = [pytest.mark.analysis]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- synthetic dumps (tests/test_replay.py's builders) ------------------------


def _dump(rank, events, world=2, gen=0, reason="exit"):
    return {"version": 1, "rank": rank, "world": world, "generation": gen,
            "reason": reason, "events": list(events)}


def _coll(i, op="all_reduce", outcome="ok", **kw):
    ev = {"kind": "collective", "op": op, "coll": i, "outcome": outcome,
          "site": "worker.py:10"}
    if op == "all_reduce":
        ev.setdefault("reduce", "sum")
    ev.update(kw)
    return ev


def _lockstep(n, **kw):
    return [_coll(i, **kw) for i in range(n)]


def _ch(op, slot, channel="work"):
    return {"kind": "channel", "op": op, "slot": slot, "channel": channel}


def _plan(op, **kw):
    return dict({"kind": "plan", "op": op}, **kw)


_MEMBER = _coll(0, group="grp1[0, 1]")

DUMPS = {
    "healthy": [_dump(0, _lockstep(3)), _dump(1, _lockstep(3))],
    "empty": [],
    "op_mismatch": [_dump(0, _lockstep(2) + [_coll(2, op="broadcast")]),
                    _dump(1, _lockstep(3))],
    "reduce_mismatch": [_dump(0, [_coll(0, reduce="sum")]),
                        _dump(1, [_coll(0, reduce="max")])],
    "digest_mismatch": [_dump(0, [_coll(0, digest="256xf32")]),
                        _dump(1, [_coll(0, digest="128xf32")])],
    "single_rank_seq": [_dump(0, _lockstep(3)), _dump(1, _lockstep(2))],
    "cross_generation": [_dump(0, _lockstep(1) + [
        {"kind": "store", "op": "set", "key": "tpu_dist/g0/ch/x"}], gen=2),
        _dump(1, _lockstep(1), gen=2)],
    "write_after_reap": [_dump(0, _lockstep(1) + [
        {"kind": "store", "op": "delete_prefix",
         "key": "tpu_dist/g0/ch/work"},
        {"kind": "store", "op": "set", "key": "tpu_dist/g0/ch/work/m/3"}]),
        _dump(1, _lockstep(1))],
    "non_member_key": [_dump(0, [_MEMBER], world=3),
                       _dump(1, [_MEMBER], world=3),
                       _dump(2, [_coll(0), {"kind": "store", "op": "add",
                                            "key": "tpu_dist/g0/grp1/seq"}],
                             world=3)],
    "failover": [_dump(0, _lockstep(2) + [
        {"kind": "store", "op": "failover", "key": "127.0.0.1:9102",
         "old": "127.0.0.1:9101", "epoch": 1}]), _dump(1, _lockstep(2))],
    "clean_cursor": [
        _dump(1, _lockstep(1) + [_ch("put", 0), _ch("put", 1)]),
        _dump(0, _lockstep(1) + [_ch("claim", 0), _ch("ack", 0),
                                 _ch("claim", 1), _ch("consume", 1)])],
    "orphaned_claim": [_dump(1, [_coll(0), _ch("put", 0)]),
                       _dump(0, [_coll(0), _ch("claim", 0)])],
    "returned_claim": [_dump(0, [_coll(0), _ch("claim", 0),
                                 _ch("claim-return", 0)])],
    "double_ack": [_dump(0, [_coll(0), _ch("claim", 2), _ch("ack", 2)]),
                   _dump(3, [_coll(0), _ch("inherit", 2), _ch("consume", 2)],
                         world=4)],
    "hole_with_write": [_dump(1, [_coll(0), _ch("put", 5)]),
                        _dump(0, [_coll(0), _ch("hole-skip", 5)])],
    "hole_healed": [_dump(0, [_coll(0), _ch("hole-skip", 5)])],
    "plan_gap": [_dump(1, [_coll(0)] + [
        _plan("apply", plan_seq=s, plan="decode") for s in (1, 2, 4, 5)])],
    "plan_contiguous": [_dump(1, [_coll(0)] + [
        _plan("apply", plan_seq=s, plan="decode") for s in (1, 2, 3)])],
    "dispatch_no_arrival": [
        _dump(0, [_coll(0), _plan("dispatch", req=7)]),
        _dump(1, [_coll(0), _plan("dispatch", req=8),
                  _plan("arrive", req=8, outcome="ok")])],
    "straggler": [_dump(0, _lockstep(4) + [_coll(4, outcome="pending")]),
                  _dump(1, _lockstep(4))],
    "missing_rank": [_dump(0, _lockstep(2), world=3),
                     _dump(1, _lockstep(2), world=3)],
}


def _shape(report):
    return [(f.rule, f.severity, f.path, f.line, f.col, f.message)
            for f in report.findings]


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_both_replays_give_the_same_report(name):
    jr = jreplay.replay_dumps(json.loads(json.dumps(DUMPS[name])), "/d")
    tr = treplay.replay_dumps(json.loads(json.dumps(DUMPS[name])), "/d")
    assert _shape(tr) == _shape(jr)
    assert tr.to_json() == jr.to_json()


def test_the_matrix_exercises_every_rule():
    rules = {f.rule for dumps in DUMPS.values()
             for f in treplay.replay_dumps(dumps).findings}
    assert rules == {"TD110", "TD111", "TD112", "TD113", "TD114", "TD115"}


def _write_dumps(dir_path, dumps):
    os.makedirs(dir_path, exist_ok=True)
    for d in dumps:
        name = f"obs_g{d['generation']}_r{d['rank']}.json"
        with open(os.path.join(dir_path, name), "w") as f:
            json.dump(d, f)


def test_replay_dir_picks_the_same_generation(tmp_path):
    _write_dumps(str(tmp_path), [_dump(0, _lockstep(1), gen=0),
                                 _dump(0, _lockstep(3), gen=1, world=1)])
    for gen in (None, 0):
        t = treplay.replay_dir(str(tmp_path), generation=gen)
        j = jreplay.replay_dir(str(tmp_path), generation=gen)
        assert t.to_json() == j.to_json()
    assert treplay.replay_dir(str(tmp_path)).generation == 1


@pytest.mark.parametrize("case,argv", [
    ("straggler", []), ("straggler", ["--format", "json"]),
    ("healthy", []), ("healthy", ["--fail-on", "never"]),
    ("missing_rank", ["--fail-on", "error"]), ("empty", []),
    ("healthy", ["--list-rules"])])
def test_replay_cli_alike(tmp_path, capsys, case, argv):
    _write_dumps(str(tmp_path), DUMPS[case])
    rc_port = tmain(["replay", str(tmp_path)] + argv)
    port = capsys.readouterr()
    rc_jax = jmain(["replay", str(tmp_path)] + argv)
    jax = capsys.readouterr()
    assert rc_port == rc_jax
    assert (port.out, port.err) == (jax.out, jax.err)


# -- dumps of the port's own recorder: a stalled gloo world of two -----------

_STALL_WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import tpu_dist_torch.dist as dist
    from tpu_dist_torch import collectives as C
    from tpu_dist_torch import obs, resilience, utils

    ckpt, out = sys.argv[1], sys.argv[2]
    pg = dist.init_process_group(init_method="env://", device="cpu")
    # monitor=False: the launcher's watchdog names the stalled rank
    with resilience.TrainState(ckpt, save_every=0, heartbeat_interval=0.2,
                               monitor=False) as ts:
        state, start = ts.resume({"x": np.zeros(1)})
        for step in range(start, 10):
            g = np.full(256, float(step), np.float32)
            C.all_reduce_host(g, group=pg, op="sum")  # the hang site
            if step == 1:
                with open(os.path.join(out, f"counters_r{pg.rank}.json"),
                          "w") as f:
                    json.dump({"utils": utils.collective_counters(),
                               "recorder": obs.transport_counters()}, f)
            ts.end_step(state, step)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def stalled_world(tmp_path_factory):
    """A world-2 gloo job under the port's launcher with the flight
    recorder armed; rank 1 stalls at step 3 and the launcher's heartbeat
    watchdog tears the world down, leaving both ranks' dumps."""
    tmp = tmp_path_factory.mktemp("stall")
    script = tmp / "stall_worker.py"
    script.write_text(_STALL_WORKER)
    obs_dir = tmp / "obsdumps"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TPU_DIST_CHAOS="stall:rank=1,step=3",
               TPU_DIST_OBS_DIR=str(obs_dir))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPU_DIST_OBS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--nproc_per_node=2",
         "--master_port=0", "--heartbeat_timeout=3", "--flight-recorder",
         str(script), str(tmp / "ckpt"), str(tmp)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return tmp, obs_dir, r


@pytest.mark.multiprocess
def test_port_dumps_replay_alike_naming_the_stalled_rank(stalled_world):
    _, obs_dir, r = stalled_world
    tr, jr = treplay.replay_dir(str(obs_dir)), jreplay.replay_dir(
        str(obs_dir))
    assert tr.ranks == [0, 1], r.stderr
    assert tr.to_json() == jr.to_json()
    assert "TD110" not in [f.rule for f in tr.findings]
    td115 = [f for f in tr.findings if f.rule == "TD115"]
    assert len(td115) == 1 and td115[0].severity == "error"
    diag = tr.diagnosis
    assert (diag["verdict"], diag["straggler"], diag["stuck_coll"]) == \
        ("straggler", 1, 4), diag
    assert "rank 1" in td115[0].message
    assert f"collective #{diag['stuck_coll']}" in td115[0].message
    assert diag == tobs.diagnose(tobs.read_dumps(str(obs_dir)))
    assert diag == jobs.diagnose(jobs.read_dumps(str(obs_dir)))


@pytest.mark.multiprocess
def test_replay_json_diagnosis_is_obs_diagnose_json(stalled_world, capsys):
    _, obs_dir, _ = stalled_world
    assert tmain(["replay", str(obs_dir), "--format", "json"]) == 1
    replay_doc = json.loads(capsys.readouterr().out)
    assert tobs_main(["diagnose", "--dir", str(obs_dir), "--json"]) == 3
    diag_doc = json.loads(capsys.readouterr().out)
    assert replay_doc["diagnosis"] == diag_doc["diagnosis"]
    assert (replay_doc["generation"], replay_doc["ranks"]) == \
        (diag_doc["generation"], diag_doc["ranks"])


@pytest.mark.multiprocess
def test_collective_counters_after_gloo_all_reduce_equal_the_recorders(
        stalled_world):
    tmp, _, r = stalled_world
    for rank in (0, 1):
        with open(tmp / f"counters_r{rank}.json") as f:
            doc = json.load(f)
        assert doc["utils"] == doc["recorder"], r.stderr
        # two store-routed all_reduces of 256 float32 by step 1
        (key,) = [k for k in doc["utils"] if k.startswith("all_reduce/")]
        assert doc["utils"][key]["calls"] == 2
        assert doc["utils"][key]["bytes"] == 2 * 256 * 4


# -- a live orphaned claim: a real port Channel under an armed recorder -------


@pytest.mark.roles
def test_live_multi_consumer_orphaned_claim_is_named(monkeypatch, tmp_path):
    """A multi-consumer port Channel claims a slot no producer writes; its
    get() deadline abandons the claim.  Both replays of the port's dump
    name the orphaned claim on that channel and slot."""
    from tpu_dist_torch.dist.store import TCPStore
    from tpu_dist_torch.roles.channel import Channel, ChannelTimeoutError
    from tpu_dist_torch.roles.graph import ChannelSpec

    monkeypatch.setenv("TPU_DIST_OBS", "1")
    monkeypatch.setenv("TPU_DIST_OBS_DIR", str(tmp_path))
    tobs.reset()
    store = TCPStore(is_master=True)
    try:
        spec = ChannelSpec("work", src="prod", dst="pool", depth=4)
        cons = Channel(spec, store, rank=0, role="pool",
                       src_span=[2], dst_span=[0, 1], generation=0,
                       graph_world=3)
        with pytest.raises(ChannelTimeoutError):
            cons.get(timeout=0.5)
        tobs.get_recorder().dump("test", dir=str(tmp_path))
    finally:
        store.close()
        tobs.reset()
    tr = treplay.replay_dir(str(tmp_path))
    assert tr.ranks, "no dump written"
    assert tr.to_json() == jreplay.replay_dir(str(tmp_path)).to_json()
    td112 = [f for f in tr.findings if f.rule == "TD112"]
    assert td112 and "orphaned claim" in td112[0].message
    assert "'work'" in td112[0].message and "slot 0" in td112[0].message
