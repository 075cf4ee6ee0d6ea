"""The port's role graphs (``tpu_dist_torch.roles``) against the JAX
package's (``tpu_dist.roles``), after ``tests/test_roles.py``.

- Graphs: parsing, validation and ``to_json`` byte-equal to JAX's (the
  launcher publishes it and both packages read it).
- Channels over one in-process store (endpoints with explicit ranks, as
  the JAX tests build them): FIFO, MPMC claims, the latest register,
  deadlines, EOF, peer death, abandoned claims and holes, the data-plane
  path; numeric leaves come back as torch CPU tensors.
- Mixed channels: a JAX producer feeds a port consumer and the other way
  round on the store path, and a JAX producer feeds a port consumer over
  the data plane (the JAX ``_DPRef`` read as the port's).
- ``spawn_graph``: solo and gang restart routing on small scripts.
- The ``actor_learner`` and ``param_server`` twins with a worker kill,
  one run each on the CPU at the JAX e2e tests' sizes, and the
  ``bench_roles`` twin's ``--smoke``.

Payload comparisons are exact."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from tpu_dist.roles import graph as jgraph
from tpu_dist_torch.collectives.transport import DataPlane, FrameCorruptError
from tpu_dist_torch.dist.store import TCPStore
from tpu_dist_torch.roles import (Channel, ChannelClosedError, ChannelError,
                                  ChannelPeerGoneError, ChannelSpec,
                                  ChannelTimeoutError, Role, RoleGraph,
                                  RoleGraphError, parse_roles_spec,
                                  spawn_graph)
from tpu_dist_torch.roles.graph import down_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- graphs -------------------------------------------------------------------

_SPECS = ["learner:1,actor:4:solo", "server:1,worker:4:solo@1",
          "a:2,b:1:gang,c:3:solo@0", "model-shard:1"]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_and_to_json_byte_equal_to_jax(spec):
    tg, jg = parse_roles_spec(spec), jgraph.parse_roles_spec(spec)
    assert tg.to_json() == jg.to_json()
    assert tg.spec_string() == jg.spec_string()
    assert [tg.label(r) for r in range(tg.world)] == \
        [jg.label(r) for r in range(jg.world)]
    # each package reads the other's published map
    assert RoleGraph.from_json(jg.to_json()).to_json() == tg.to_json()
    assert jgraph.RoleGraph.from_json(tg.to_json()).to_json() == jg.to_json()


def test_graph_with_channels_json_and_accessors():
    kw = dict(depth=3, payload_bytes=1 << 20, credits=2)
    tg = RoleGraph([Role("a", 2), Role("b", 1, restart="solo")],
                   [ChannelSpec("c", "a", "b", **kw),
                    ChannelSpec("p", "b", "a", kind="latest")])
    jg = jgraph.RoleGraph([jgraph.Role("a", 2),
                           jgraph.Role("b", 1, restart="solo")],
                          [jgraph.ChannelSpec("c", "a", "b", **kw),
                           jgraph.ChannelSpec("p", "b", "a", kind="latest")])
    assert tg.to_json() == jg.to_json()
    assert list(tg.span("a")) == [0, 1] and tg.role_of(2) == ("b", 0)
    sg = tg.subgroup("a", 1)
    assert sg.members == (0, 1) and sg.rank == 1
    assert sg.group_id.endswith(".role-a")
    assert tg.subgroup("a", 2).rank is None
    tg.check_against(RoleGraph.from_json(jg.to_json()))
    with pytest.raises(RoleGraphError, match="disagrees"):
        tg.check_against(RoleGraph([Role("a", 3), Role("b", 1)]))


@pytest.mark.parametrize("bad", ["", "a", "a:x", "a:1:often", "a:0",
                                 "a:1,,b:1", "a:1:solo:extra", "a:b:1",
                                 "a:1@x"])
def test_bad_specs_raise_as_jax_does(bad):
    with pytest.raises(RoleGraphError) as te:
        parse_roles_spec(bad)
    with pytest.raises(jgraph.RoleGraphError) as je:
        jgraph.parse_roles_spec(bad)
    assert str(te.value) == str(je.value)


def test_graph_validation_named():
    with pytest.raises(RoleGraphError, match="duplicate role name"):
        RoleGraph([Role("a", 1), Role("a", 2)])
    with pytest.raises(RoleGraphError, match="dangling endpoint"):
        RoleGraph([Role("a", 1)], [ChannelSpec("c", "a", "nope")])
    with pytest.raises(RoleGraphError, match="duplicate channel"):
        RoleGraph([Role("a", 1), Role("b", 1)],
                  [ChannelSpec("c", "a", "b"), ChannelSpec("c", "b", "a")])
    with pytest.raises(RoleGraphError, match="not a valid token"):
        Role("a:b", 1)


# -- channels -----------------------------------------------------------------


@pytest.fixture
def store():
    s = TCPStore(is_master=True)
    yield s
    s.close()


def _pair(store, name="ch", depth=4, gen=0, src=(1, 2), dst=(0,),
          dp_pair=None, kind="queue", mods=(None, None)):
    """A producer and a consumer endpoint; ``mods`` picks each side's
    package (None: the port)."""
    def make(mod, rank, role, dp):
        m_spec = (mod.ChannelSpec if mod else ChannelSpec)(
            name, src="prod", dst="cons", depth=depth, kind=kind)
        return (mod.Channel if mod else Channel)(
            m_spec, store, rank=rank, role=role, src_span=list(src),
            dst_span=list(dst), generation=gen, graph_world=3,
            dp=dp if dp is not None else False)
    prod = make(mods[0], src[0], "prod", dp_pair[0] if dp_pair else None)
    cons = make(mods[1], dst[0], "cons", dp_pair[1] if dp_pair else None)
    return prod, cons


class TestChannel:
    def test_tree_roundtrip_fifo_and_tensor_leaves(self, store):
        prod, cons = _pair(store)
        prod.put({"x": torch.arange(5), "h": torch.ones(2, dtype=torch.
                                                        bfloat16),
                  "a": np.arange(3), "n": 7, "s": "hi", "z": None},
                 timeout=10)
        prod.put([np.ones(3)], timeout=10)
        out = cons.get(timeout=10)
        assert out["n"] == 7 and out["s"] == "hi" and out["z"] is None
        assert torch.equal(out["x"], torch.arange(5))
        assert out["h"].dtype == torch.bfloat16
        assert torch.equal(out["h"], torch.ones(2, dtype=torch.bfloat16))
        assert isinstance(out["a"], torch.Tensor)
        assert torch.equal(cons.get(timeout=10)[0],
                           torch.ones(3, dtype=torch.float64))
        assert cons.qsize() == 0

    def test_backpressure_bounded_depth(self, store):
        prod, cons = _pair(store, depth=2)
        prod.put(0, timeout=5)
        prod.put(1, timeout=5)
        landed = []
        t = threading.Thread(
            target=lambda: (prod.put(2, timeout=20), landed.append(1)))
        t.start()
        time.sleep(0.3)
        assert not landed, "the 3rd put must block at depth 2"
        assert cons.get(timeout=5) == 0
        t.join(10)
        assert landed and cons.get(timeout=5) == 1
        assert cons.get(timeout=5) == 2

    def test_deadlines_named_and_claim_released(self, store):
        prod, cons = _pair(store, depth=1)
        with pytest.raises(ChannelTimeoutError, match="ch.*get.*prod"):
            cons.get(timeout=0.3)
        prod.put("late", timeout=5)
        with pytest.raises(ChannelTimeoutError, match="backpressured"):
            prod.put("more", timeout=0.3)
        assert cons.get(timeout=5) == "late"   # the claim was released

    def test_eof_and_closed_consumer(self, store):
        prod, cons = _pair(store, src=(1,))
        prod.put("a", timeout=5)
        prod.close()
        assert cons.get(timeout=5) == "a"
        with pytest.raises(ChannelClosedError, match="drained"):
            cons.get(timeout=5)
        prod2, cons2 = _pair(store, name="c2")
        cons2.close()
        with pytest.raises(ChannelClosedError, match="no reader"):
            prod2.put(1, timeout=5)

    def test_peer_death_named(self, store):
        prod, cons = _pair(store)
        prod.close()                      # rank 1 closed cleanly
        store.set(down_key(0, 2), b"1")   # rank 2 died
        with pytest.raises(ChannelPeerGoneError) as ei:
            cons.get(timeout=20)
        assert ei.value.role == "prod" and ei.value.ranks == [2]

    def test_latest_register_versions(self, store):
        prod, cons = _pair(store, kind="latest")
        assert cons.poll_latest(0) is None
        assert prod.put_latest({"w": torch.tensor([1.0])}) == 1
        assert prod.put_latest({"w": torch.tensor([2.0])}) == 2
        tree, ver = cons.get_latest(0, timeout=5)
        assert ver == 2 and torch.equal(tree["w"], torch.tensor([2.0]))
        assert cons.poll_latest(ver) is None
        with pytest.raises(ChannelTimeoutError):
            cons.get_latest(ver, timeout=0.3)

    def test_generation_fencing_and_registration(self, store):
        old, _ = _pair(store, name="g", gen=3)
        _, new = _pair(store, name="g", gen=4)
        old.put("stale", timeout=5)
        with pytest.raises(ChannelTimeoutError):
            new.get(timeout=0.4)
        spec2 = ChannelSpec("g", src="prod", dst="cons", depth=9)
        with pytest.raises(ChannelError, match="does not match"):
            Channel(spec2, store, rank=1, role="prod", src_span=[1, 2],
                    dst_span=[0], generation=3, graph_world=3, dp=False)
        with pytest.raises(RoleGraphError, match="no endpoint"):
            Channel(spec2, store, rank=0, role="bystander", src_span=[1],
                    dst_span=[0], generation=0, graph_world=2, dp=False)

    def test_corrupt_payload_named_and_slot_acked(self, store):
        prod, cons = _pair(store, name="crc", depth=2)
        prod.put("bad", timeout=5)
        prod.put("good", timeout=5)
        key = "tpu_dist/g0/roles/ch/crc/m/0"
        raw = bytearray(store.get(key))
        raw[len(raw) // 2] ^= 0x20
        store.set(key, bytes(raw))
        with pytest.raises(FrameCorruptError):
            cons.get(timeout=5)
        prod.put("after", timeout=2)   # the window was not shrunk
        assert cons.get(timeout=5) == "good"
        assert cons.get(timeout=5) == "after" and cons.qsize() == 0

    def test_hole_skipped_after_settle(self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_CH_HOLE_SETTLE", "0.2")
        prod, cons = _pair(store, name="hx")
        store.add("tpu_dist/g0/roles/ch/hx/head", 1)  # claimed, never written
        with pytest.raises(ChannelTimeoutError, match="slot 0"):
            cons.get(timeout=0.3)
        time.sleep(0.35)
        with pytest.raises(ChannelTimeoutError, match="skipped a hole"):
            cons.get(timeout=0.3)
        prod.put("after", timeout=5)
        assert cons.get(timeout=5) == "after" and cons.qsize() == 0

    def test_multiconsumer_abandoned_claims_heal_and_are_inherited(
            self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_CH_HOLE_SETTLE", "0.2")
        prod, cons = _pair(store, name="mc", src=(1,), dst=(0, 2))
        base = "tpu_dist/g0/roles/ch/mc"
        store.add(f"{base}/head", 1)        # slot 0 claimed, never written
        with pytest.raises(ChannelTimeoutError):
            cons.get(timeout=0.3)           # abandoned, not yet acked
        assert json.loads(store.get(f"{base}/claims/0").decode()) == [0]
        # a respawned consumer inherits the claim from the ledger
        cons2 = Channel(prod.spec, store, rank=0, role="cons",
                        src_span=[1], dst_span=[0, 2], generation=0,
                        graph_world=3, dp=False)
        assert 0 in cons2._abandoned
        store.set(f"{base}/m/0", prod._encode("late", 0))
        assert cons2.get(timeout=5) == "late"
        store.add(f"{base}/head", 1)        # slot 1: a true hole
        with pytest.raises(ChannelTimeoutError):
            cons2.get(timeout=0.3)
        time.sleep(0.35)
        prod.put("live", timeout=5)
        assert cons2.get(timeout=5) == "live"
        assert cons2.qsize() == 0

    def test_consumer_killed_mid_get_claim_rewound(self, store):
        prod, cons = _pair(store, name="cr", src=(1,))
        prod.put("survives", timeout=5)
        store.add("tpu_dist/g0/roles/ch/cr/rtail", 1)  # died mid-get
        cons2 = Channel(cons.spec, store, rank=0, role="cons",
                        src_span=[1], dst_span=[0], generation=0,
                        graph_world=3, dp=False)
        assert cons2.get(timeout=5) == "survives" and cons2.qsize() == 0

    def test_crash_unwind_posts_no_eof_marker(self, store):
        spec = ChannelSpec("cw", src="prod", dst="cons")
        prod = Channel(spec, store, rank=1, role="prod", src_span=[1],
                       dst_span=[0], generation=0, graph_world=2, dp=False)
        with pytest.raises(RuntimeError):
            with prod:
                raise RuntimeError("crash")
        assert not store.check("tpu_dist/g0/roles/ch/cw/closed/1")

    def test_dataplane_path_roundtrip_and_stats(self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_DP_THRESHOLD", str(16 * 1024))
        dps = [DataPlane(store, 1, 3), DataPlane(store, 0, 3)]
        try:
            prod, cons = _pair(store, name="dp", src=(1,),
                               dp_pair=(dps[0], dps[1]))
            big = torch.randn(50_000, generator=torch.Generator()
                              .manual_seed(0))
            prod.put({"big": big, "h": big[:20_000].bfloat16(),
                      "small": np.arange(4), "m": "x"}, timeout=15)
            out = cons.get(timeout=15)
            assert torch.equal(out["big"], big) and out["m"] == "x"
            assert torch.equal(out["h"], big[:20_000].bfloat16())
            assert prod.stats["dp_leaves"] == 2
            assert cons.stats["dp_msgs"] == 1
        finally:
            for dp in dps:
                dp.close()


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_mixed_channel_store_path(store, direction):
    """A channel whose producer is one package and consumer the other,
    on the store path, both ways, with the queue and the register."""
    import tpu_dist.roles as jroles
    mods = (jroles, None) if direction == "jax->port" else (None, jroles)
    a = np.random.default_rng(1).standard_normal(100).astype(np.float32)
    prod, cons = _pair(store, name="mx", mods=mods)
    first = a if mods[0] else torch.from_numpy(a)
    prod.put({"a": first, "k": [1, "two", None]}, timeout=10)
    prod.put(np.arange(6), timeout=10)
    got = cons.get(timeout=10)
    got_a = got["a"].numpy() if isinstance(got["a"], torch.Tensor) \
        else got["a"]
    assert np.array_equal(got_a, a) and got["k"] == [1, "two", None]
    assert np.array_equal(np.asarray(cons.get(timeout=10)), np.arange(6))
    lp, lc = _pair(store, name="mxl", kind="latest", mods=mods)
    lp.put_latest({"v": 3})
    assert lc.get_latest(0, timeout=5) == ({"v": 3}, 1)


def test_mixed_channel_dataplane_jax_producer(store, monkeypatch):
    """A JAX producer's data-plane leaves reach a port consumer: the port
    reads the JAX placeholder class as its own."""
    import tpu_dist.roles as jroles
    from tpu_dist.collectives.transport import DataPlane as JDataPlane
    monkeypatch.setenv("TPU_DIST_DP_THRESHOLD", str(16 * 1024))
    jdp, tdp = JDataPlane(store, 1, 3), DataPlane(store, 0, 3)
    try:
        prod, cons = _pair(store, name="mxdp", src=(1,), dp_pair=(jdp, tdp),
                           mods=(jroles, None))
        big = np.random.default_rng(2).standard_normal(40_000).astype(
            np.float32)
        prod.put({"big": big, "n": 1}, timeout=15)
        out = cons.get(timeout=15)
        assert torch.equal(out["big"], torch.from_numpy(big))
        assert prod.stats["dp_msgs"] == 1 and cons.stats["dp_msgs"] == 1
    finally:
        jdp.close()
        tdp.close()


def test_jax_class_in_payload_refused_by_name(store):
    import pickle

    from tpu_dist_torch.collectives.eager import _seal
    prod, cons = _pair(store, name="ref")
    # an envelope holding a class of the JAX package
    payload = pickle.dumps(({"src": 1}, jgraph.Role("a", 1)))
    store.add("tpu_dist/g0/roles/ch/ref/head", 1)
    store.set("tpu_dist/g0/roles/ch/ref/m/0", _seal(payload))
    with pytest.raises(ChannelError, match="tpu_dist.roles.graph.Role"):
        cons.get(timeout=5)


# -- spawn_graph restart routing ----------------------------------------------

_POLICY_WORKER = textwrap.dedent("""
    import os, sys
    out, mode = sys.argv[1], sys.argv[2]
    rank = os.environ["RANK"]; role = os.environ["TPU_DIST_ROLE"]
    gen = os.environ["TPU_DIST_RESTART_COUNT"]
    inc = os.environ["TPU_DIST_ROLE_INCARNATION"]
    with open(os.path.join(out, f"r{rank}_g{gen}_i{inc}"), "w") as f:
        f.write(role)
    if mode == "solo-crash" and role == "w" \\
            and os.environ["TPU_DIST_ROLE_RANK"] == "1" and inc == "0":
        sys.exit(3)
    if mode == "gang-crash" and role == "lead" and gen == "0":
        # fail once every rank of the round wrote its record: the gang
        # teardown must not race a sibling's start
        import time
        for _ in range(600):
            if sum(n.endswith("_g0_i0") for n in os.listdir(out)) >= 3:
                break
            time.sleep(0.05)
        sys.exit(5)
""")


@pytest.mark.parametrize("mode,kw,want_rc", [
    ("solo-crash", {"solo_restarts": 2}, 0),
    ("gang-crash", {"max_restarts": 1}, 0),
    ("solo-crash", {"solo_restarts": 0, "max_restarts": 0}, 3)])
def test_spawn_graph_restart_routing(tmp_path, mode, kw, want_rc):
    script = tmp_path / "worker.py"
    script.write_text(_POLICY_WORKER)
    out = tmp_path / "out"
    out.mkdir()
    g = RoleGraph([Role("lead", 1), Role("w", 2, restart="solo")])
    rc = spawn_graph(g, [sys.executable, str(script), str(out), mode],
                     restart_backoff=0.05, **kw)
    runs = sorted(p.name for p in out.iterdir())
    assert rc == want_rc
    if mode == "solo-crash" and want_rc == 0:
        # rank 2 (w[1]) ran twice in generation 0, nobody else re-ran
        assert runs == ["r0_g0_i0", "r1_g0_i0", "r2_g0_i0", "r2_g0_i1"]
    elif mode == "gang-crash":
        # every rank ran in both generations
        assert set(runs) == {f"r{i}_g{gen}_i0" for i in range(3)
                             for gen in (0, 1)}


# -- the example twins with a worker kill, and the bench twin ------------------


def _launch(tmp_path, roles, module, extra, env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TPU_DIST_CHAOS"] = "kill:rank=2,step=3"
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--roles", roles, "--solo_restarts", "2", "-m", module, *extra,
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=420)


@pytest.mark.multiprocess
def test_actor_learner_twin_solo_restart_and_loss_decrease(tmp_path):
    """4 actors + 1 learner; chaos kills actor[1] (rank 2) at its 3rd
    batch; only that rank restarts, in generation 0, its batches reach the
    learner through the same queue, and the loss falls by the JAX test's
    margin.  The dumps hold the channel's put, claim and ack events."""
    obs_dir = tmp_path / "obs"
    # the actors' throttle keeps the learner's 100 steps longer than a
    # respawn's start: on a quiet machine the learner can finish first
    # (the JAX e2e test meets that race)
    r = _launch(tmp_path, "learner:1,actor:4:solo",
                "tpu_dist_torch.examples.actor_learner",
                ["--actors", "4", "--max-steps", "100",
                 "--actor-throttle", "0.4"],
                {"TPU_DIST_OBS": "1", "TPU_DIST_OBS_DIR": str(obs_dir)})
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "role-solo-restart rank=2" in r.stderr, r.stderr
    assert "gang restart" not in r.stderr
    learner = json.load(open(tmp_path / "learner.json"))
    assert learner["generation"] == 0 and learner["steps"] == 100
    i1 = json.load(open(tmp_path / "actor1_i1.json"))
    assert i1["incarnation"] == 1 and i1["produced"] >= 1
    assert 1 in learner["seen_incarnations"]["1"], learner
    assert not (tmp_path / "actor0_i1.json").exists()
    losses = learner["losses"]
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    assert tail < head - 1.0, (head, tail)
    assert learner["traj_stats"]["dp_msgs"] > 0, learner["traj_stats"]
    from tpu_dist_torch import obs
    dumps = obs.read_dumps(str(obs_dir))
    ops = {e.get("op") for d in dumps for e in d["events"]
           if e.get("kind") == "channel"}
    assert {"put", "claim", "ack"} <= ops, ops
    assert all(d["role"] in ("learner", "actor") for d in dumps)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.multiprocess
def test_actor_learner_across_two_launchers(tmp_path):
    """``--roles learner:1,actor:4:solo@1`` under two launchers
    (``--nnodes=2``, one store hosted by node 0): node 0 supervises the
    learner, node 1 the four actors.  Chaos kills actor[1] (rank 2) at its
    3rd batch; node 1's launcher respawns it alone in generation 0, and the
    learner — on the other node — takes its batches through the same
    queue.  A pin past the cluster is refused by ``validate_placement`` on
    every launcher, as the JAX launcher refuses it."""
    master, store_port = _free_port(), _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TPU_DIST_CHAOS="kill:rank=2,step=3")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("TPU_DIST_STORE_ADDR", "MASTER_PORT", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--nnodes=2",
         f"--node_rank={n}", f"--master_port={master}",
         f"--store_port={store_port}", "--roles",
         "learner:1,actor:4:solo@1", "--solo_restarts", "2", "-m",
         "tpu_dist_torch.examples.actor_learner", "--actors", "4",
         "--max-steps", "100", "--actor-throttle", "0.4", "--device", "cpu",
         "--out", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in (0, 1)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], errs
    # the actors' launcher respawned the killed actor; node 0 did not
    assert "role-solo-restart rank=2" in errs[1], errs[1]
    assert "role-solo-restart" not in errs[0], errs[0]
    assert "gang restart" not in errs[0] + errs[1]
    learner = json.load(open(tmp_path / "learner.json"))
    assert learner["generation"] == 0 and learner["steps"] == 100
    assert 1 in learner["seen_incarnations"]["1"], learner
    assert set(learner["seen_incarnations"]) == {"0", "1", "2", "3"}
    assert json.load(open(tmp_path / "actor1_i1.json"))["incarnation"] == 1
    losses = learner["losses"]
    assert sum(losses[-10:]) / 10 < sum(losses[:10]) / 10 - 1.0
    # a pin past the cluster: both launchers of both packages refuse it
    from tpu_dist.launch import cli as jcli
    from tpu_dist_torch.launch import cli as tcli
    for cli in (tcli, jcli):
        for node in (0, 1):
            rc = cli.main(["--nnodes=2", f"--node_rank={node}",
                           f"--master_port={master}", "--roles",
                           "learner:1,actor:2:solo@2", "worker.py"])
            assert rc == 2


@pytest.mark.multiprocess
def test_param_server_twin_solo_restart_and_loss_decrease(tmp_path):
    r = _launch(tmp_path, "server:1,worker:4:solo",
                "tpu_dist_torch.examples.param_server",
                ["--workers", "4", "--max-steps", "48"], {})
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "role-solo-restart rank=2" in r.stderr, r.stderr
    assert "gang restart" not in r.stderr
    server = json.load(open(tmp_path / "server.json"))
    assert server["generation"] == 0 and server["steps"] == 48
    i1 = json.load(open(tmp_path / "worker1_i1.json"))
    assert i1["incarnation"] == 1 and i1["pushed"] >= 1
    assert 1 in server["seen_incarnations"]["1"]
    assert set(server["seen_incarnations"]) == {"0", "1", "2", "3"}
    assert not (tmp_path / "worker0_i1.json").exists()
    losses = server["losses"]
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    assert tail < head - 0.8, (head, tail)
    assert server["grads_stats"]["dp_msgs"] > 0, server["grads_stats"]


@pytest.mark.multiprocess
def test_bench_roles_twin_smoke():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_roles",
         "--device", "cpu", "--smoke"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    rows = [json.loads(l) for l in r.stdout.splitlines() if l.strip()]
    cells = [x for x in rows if x["metric"] == "roles_channel_mb_s"]
    assert {c["path"] for c in cells} == {"store", "dataplane"}
    assert all(c["value"] > 0 and c["payload_equal"] for c in cells)
