"""The port's cluster control plane (``tpu_dist_torch.cluster``) against
the JAX package's (``tpu_dist.cluster``): a twin of every test in
tests/test_cluster.py on the port's own classes — the endpoints file,
snapshot-then-tail replication, a lagged replay of a generation reap,
re-snapshot on a truncated log, a blocked waiter re-armed on the promoted
follower, at-most-once ADD across a leader kill, the election (with a
stale-leased candidate), the node partition cell, membership and the
elastic plan — and the mixed-package cells that prove one wire: followers
of either package tail leaders of the other to the same kv and sequence,
clients of either package ride the other's promotion, and ``elastic_plan``
and ``validate_placement`` equal the JAX functions over a seeded sweep.
Threads stand for nodes; every wait has a timeout."""

import json
import os
import struct
import threading
import time

import numpy as np
import pytest

from tpu_dist import cluster as jcluster
from tpu_dist.dist import store as jstore
from tpu_dist_torch.cluster import (NodeAgent, StoreFollower, elastic_plan,
                                    leader_addr, live_nodes, publish_lease,
                                    read_endpoints, read_nodes,
                                    register_node, validate_placement,
                                    write_endpoints)
from tpu_dist_torch.cluster import membership as tmb
from tpu_dist_torch.cluster.endpoints import ENDPOINTS_ENV
from tpu_dist_torch.cluster.membership import (gather_elastic_counts,
                                               lease_key,
                                               publish_elastic_counts,
                                               read_leases, replica_key)
from tpu_dist_torch.dist.store import (PyTCPStoreServer, StoreFailoverError,
                                       TCPStore)
from tpu_dist_torch.resilience import netchaos

pytestmark = pytest.mark.cluster


@pytest.fixture(autouse=True)
def _no_netchaos():
    yield
    netchaos.uninstall()


@pytest.fixture
def leader(monkeypatch, tmp_path):
    """A replicating leader server and an endpoints file armed in the env:
    the client-side configuration of every cluster process."""
    monkeypatch.setenv("TPU_DIST_STORE_LOG_MAX", "10000")
    srv = PyTCPStoreServer(0, replicate=True)
    path = str(tmp_path / "ep.json")
    write_endpoints(path, f"127.0.0.1:{srv.port}", 0)
    monkeypatch.setenv(ENDPOINTS_ENV, path)
    yield srv, path
    srv.stop()


def _client(port, pkg=None):
    return (pkg or TCPStore)("127.0.0.1", port, timeout=20.0)


# -- the endpoints file ---------------------------------------------------------


class TestEndpoints:
    def test_roundtrip_and_atomicity(self, tmp_path):
        p = str(tmp_path / "ep.json")
        assert read_endpoints(p) is None           # missing file
        write_endpoints(p, "10.0.0.1:29501", 2,
                        candidates={0: "10.0.0.1:29501",
                                    1: "10.0.0.2:31044"})
        doc = read_endpoints(p)
        assert doc["leader"] == "10.0.0.1:29501"
        assert doc["epoch"] == 2
        assert doc["candidates"]["1"] == "10.0.0.2:31044"
        assert leader_addr(p) == ("10.0.0.1", 29501)
        # the same JSON as the JAX writer's
        q = str(tmp_path / "jep.json")
        jcluster.write_endpoints(q, "10.0.0.1:29501", 2,
                                 candidates={0: "10.0.0.1:29501",
                                             1: "10.0.0.2:31044"})
        assert open(p).read() == open(q).read()
        assert jcluster.read_endpoints(p) == doc

    def test_torn_or_invalid_reads_as_none(self, tmp_path):
        p = str(tmp_path / "ep.json")
        with open(p, "w") as f:
            f.write('{"leader": "10.0.0.1:2')   # torn mid-write
        assert read_endpoints(p) is None
        with open(p, "w") as f:
            json.dump({"epoch": 3}, f)          # no leader
        assert read_endpoints(p) is None
        assert leader_addr(p) is None


# -- follower replication ---------------------------------------------------------


class TestReplication:
    def test_snapshot_then_tail_converges(self, leader):
        srv, _ = leader
        c = _client(srv.port)
        c.set("tpu_dist/cluster/pre", b"before-follower")
        with StoreFollower("127.0.0.1", srv.port) as fo:
            assert fo.wait_caught_up(srv.replication_seq())
            assert fo.server.snapshot_items("")["tpu_dist/cluster/pre"] \
                == b"before-follower"
            c.set("tpu_dist/cluster/post", b"tailed")
            c.add("tpu_dist/cluster/ctr", 5)    # replicated as SET-of-result
            assert fo.wait_caught_up(srv.replication_seq())
            kv = fo.server.snapshot_items("")
            assert kv["tpu_dist/cluster/post"] == b"tailed"
            assert kv["tpu_dist/cluster/ctr"] == struct.pack("<q", 5)
        c.close()

    def test_lagged_follower_replays_generation_reap_in_order(self, leader):
        # paused across a generation reap (DELETE_PREFIX of g0 and the g1
        # bootstrap writes), the follower replays in the leader's order on
        # resume and never resurrects a g0 key
        srv, _ = leader
        c = _client(srv.port)
        for r in range(4):
            c.set(f"tpu_dist/g0/coll/ar/0/{r}", b"x")
        with StoreFollower("127.0.0.1", srv.port) as fo:
            assert fo.wait_caught_up(srv.replication_seq())
            fo.pause()
            c.delete_prefix("tpu_dist/g0/")     # the generation reap
            c.set("tpu_dist/generation", b"1")
            c.set("tpu_dist/g1/coll/ar/0/0", b"y")
            assert len(fo.server.snapshot_items("tpu_dist/g0/")) == 4
            fo.resume()
            assert fo.wait_caught_up(srv.replication_seq())
            assert fo.server.snapshot_items("tpu_dist/g0/") == {}
            kv = fo.server.snapshot_items("")
            assert kv["tpu_dist/generation"] == b"1"
            assert kv["tpu_dist/g1/coll/ar/0/0"] == b"y"
        c.close()

    def test_truncated_log_triggers_resnapshot(self, leader, monkeypatch):
        monkeypatch.setenv("TPU_DIST_STORE_LOG_MAX", "8")
        monkeypatch.delenv(ENDPOINTS_ENV)
        monkeypatch.setenv("TPU_DIST_STORE_REPLICATE", "1")
        small = PyTCPStoreServer(0, replicate=True)
        try:
            c = _client(small.port)
            c.set("seed", b"0")
            with StoreFollower("127.0.0.1", small.port) as fo:
                assert fo.wait_caught_up(small.replication_seq())
                fo.pause()
                for i in range(32):             # 4x the log bound
                    c.set(f"k/{i}", str(i).encode())
                fo.resume()
                assert fo.wait_caught_up(small.replication_seq())
                kv = fo.server.snapshot_items("k/")
                assert len(kv) == 32 and kv["k/31"] == b"31"
            c.close()
        finally:
            small.stop()


# -- failover as clients see it ---------------------------------------------------


def _blocked_get(c, key):
    got = {}
    t = threading.Thread(target=lambda: got.update(v=c.get(key)),
                         daemon=True)
    t.start()
    return t, got


class TestClientFailover:
    def test_blocked_waiter_rearms_on_promoted_follower(self, leader):
        srv, path = leader
        fo = StoreFollower("127.0.0.1", srv.port).start()
        try:
            c = _client(srv.port)
            t, got = _blocked_get(c, "late/key")
            time.sleep(0.3)                     # GET is blocked server-side
            host, port = fo.promote()
            write_endpoints(path, f"{host}:{port}", 1)
            srv.stop()                          # wakes the waiter: status 1
            admin = _client(port)               # follows endpoints -> new
            admin.set("late/key", b"after-failover")
            t.join(timeout=15)
            assert got.get("v") == b"after-failover"
            c.close()
            admin.close()
        finally:
            fo.stop()

    def test_at_most_once_add_across_leader_kill(self, leader):
        srv, path = leader
        fo = StoreFollower("127.0.0.1", srv.port).start()
        try:
            c = _client(srv.port)
            assert c.add("tpu_dist/cluster/ctr", 1) == 1
            assert fo.wait_caught_up(srv.replication_seq())
            host, port = fo.promote()
            write_endpoints(path, f"{host}:{port}", 1)
            srv.stop()
            # an in-process stop leaves established connections on their
            # handler threads: sever the wire the way a SIGKILL would
            netchaos.install("conn-reset:surface=store,frame=1")
            with pytest.raises(StoreFailoverError) as ei:
                c.add("tpu_dist/cluster/ctr", 1)
            netchaos.uninstall()
            assert ei.value.epoch == 1
            assert ei.value.new_leader.endswith(str(port))
            assert ei.value.old_leader != ei.value.new_leader
            # read first, then re-issue: not double-applied
            assert c.get("tpu_dist/cluster/ctr") == struct.pack("<q", 1)
            assert c.add("tpu_dist/cluster/ctr", 1) == 2
            c.close()
        finally:
            fo.stop()

    def test_failover_is_recorded_for_diagnose(self, leader, monkeypatch,
                                               tmp_path):
        # the recorder's store/failover event, which obs.diagnose lists
        from tpu_dist_torch.obs import recorder
        from tpu_dist_torch.obs.trace import diagnose
        monkeypatch.setenv("TPU_DIST_OBS", "1")
        monkeypatch.setenv("TPU_DIST_OBS_DIR", str(tmp_path))
        recorder.reset()
        srv, path = leader
        fo = StoreFollower("127.0.0.1", srv.port).start()
        try:
            c = _client(srv.port)
            t, got = _blocked_get(c, "late/key")
            time.sleep(0.3)
            host, port = fo.promote()
            write_endpoints(path, f"{host}:{port}", 1)
            srv.stop()
            admin = _client(port)
            admin.set("late/key", b"v")
            t.join(timeout=15)
            assert got.get("v") == b"v"
            evs = [e for e in recorder.get_recorder().snapshot()
                   if e["kind"] == "store" and e["op"] == "failover"]
            assert evs and evs[0]["epoch"] == 1
            assert evs[0]["key"] == f"127.0.0.1:{port}"
            path_dump = recorder.get_recorder().dump(reason="test")
            diag = diagnose([json.load(open(path_dump))])
            assert diag["store_failovers"], diag
            c.close()
            admin.close()
        finally:
            fo.stop()
            recorder.reset()


# -- the election (real NodeAgents, in-process) ------------------------------------


class TestElection:
    def test_lowest_live_node_promotes_and_peers_follow(self, leader):
        srv, path = leader
        fo1 = StoreFollower("127.0.0.1", srv.port, down_after=0.6).start()
        fo2 = StoreFollower("127.0.0.1", srv.port, down_after=0.6).start()
        a1 = NodeAgent(1, path, follower=fo1, nproc=2,
                       lease_interval=0.1, lease_ttl=0.8).start()
        a2 = NodeAgent(2, path, follower=fo2, nproc=2,
                       lease_interval=0.1, lease_ttl=0.8).start()
        try:
            c = _client(srv.port)
            c.wait([replica_key(1), replica_key(2)], timeout=10)
            c.set("survives", b"the-failover")
            seq = srv.replication_seq()
            assert fo1.wait_caught_up(seq) and fo2.wait_caught_up(seq)
            c.close()
            srv.stop()                          # the leader dies
            assert a1.is_leader.wait(timeout=15), "node 1 never promoted"
            doc = read_endpoints(path)
            assert doc["epoch"] == 1
            assert doc["leader"].endswith(str(fo1.port))
            time.sleep(0.5)
            assert not a2.is_leader.is_set()    # node 2 followed
            c2 = _client(fo1.port)
            assert c2.get("survives") == b"the-failover"
            c2.close()
        finally:
            a1.stop()
            a2.stop()
            fo1.stop()
            fo2.stop()

    def test_election_skips_stale_leased_candidate(self, leader):
        srv, path = leader
        fo2 = StoreFollower("127.0.0.1", srv.port, down_after=0.6).start()
        try:
            c = _client(srv.port)
            # a phantom node-1 candidate whose lease is an hour old
            c.set(replica_key(1), b"127.0.0.1:1")
            c.set(lease_key(1),
                  json.dumps({"node": 1, "t": time.time() - 3600}).encode())
            a2 = NodeAgent(2, path, follower=fo2, nproc=2,
                           lease_interval=0.1, lease_ttl=0.8).start()
            c.wait([replica_key(2)], timeout=10)
            assert fo2.wait_caught_up(srv.replication_seq())
            c.close()
            srv.stop()
            assert a2.is_leader.wait(timeout=15), "node 2 never promoted"
            assert read_endpoints(path)["leader"].endswith(str(fo2.port))
            a2.stop()
        finally:
            fo2.stop()


# -- the node-granularity store partition -----------------------------------------


class TestNodePartition:
    def test_partition_cell_scoped_to_one_node(self, leader, monkeypatch):
        srv, _ = leader
        spec = "partition:surface=store,node=1"
        c = _client(srv.port)
        c.set("cell", b"up")
        monkeypatch.setenv("NODE_RANK", "1")
        netchaos.install(spec)
        with pytest.raises(ConnectionError, match="injected store "
                                                  "partition"):
            c.get("cell")
        netchaos.uninstall()
        monkeypatch.setenv("NODE_RANK", "0")    # another node
        netchaos.install(spec)
        assert c.get("cell") == b"up"
        netchaos.uninstall()
        monkeypatch.delenv("NODE_RANK", raising=False)
        monkeypatch.delenv("TPU_DIST_NODE_ID", raising=False)
        netchaos.install(spec)                  # no node identity at all
        assert c.get("cell") == b"up"           # stays disarmed
        c.close()


# -- membership and the cluster's elastic plan -------------------------------------


class TestMembership:
    def test_register_lease_live(self, leader, monkeypatch):
        srv, _ = leader
        c = _client(srv.port)
        monkeypatch.setenv("TPU_DIST_NODE_CLASS", "h100")
        rec = register_node(c, 0, nproc=4)
        register_node(c, 1, nproc=4, node_class="cpu")
        nodes = read_nodes(c, nnodes=3)         # node 2 never registered
        assert set(nodes) == {0, 1}
        assert nodes[0]["class"] == "h100" and nodes[1]["class"] == "cpu"
        assert nodes[0]["host"] == rec["host"]
        # the JAX reader reads the port's records
        assert jcluster.read_nodes(c, nnodes=3) == nodes
        publish_lease(c, 0)
        publish_lease(c, 1)
        leases = read_leases(
            {k: c.get(k) for k in (lease_key(0), lease_key(1))})
        assert set(leases) == {0, 1}
        c.close()

    def test_live_nodes_is_relative_freshness(self):
        now = 1_000_000.0
        leases = {0: now, 1: now - 0.5, 2: now - 30.0}
        assert live_nodes(leases, ttl=5.0) == {0, 1}
        assert live_nodes({}, ttl=5.0) == set()

    def test_elastic_counts_roundtrip(self, leader):
        srv, _ = leader
        c = _client(srv.port)
        publish_elastic_counts(c, 3, 0, nproc=4, full_nproc=4,
                               preempted=0, grow=False)
        publish_elastic_counts(c, 3, 1, nproc=4, full_nproc=4,
                               preempted=2, grow=False)
        counts = gather_elastic_counts(c, 3, nnodes=2, timeout=5)
        assert counts[1]["preempted"] == 2 and counts[0]["nproc"] == 4
        from tpu_dist.cluster import membership as jmb
        assert jmb.gather_elastic_counts(c, 3, nnodes=2, timeout=5) == counts
        c.close()


class TestElasticPlan:
    RECORDS = {0: {"host": "hostA"}, 1: {"host": "hostB"}}

    def test_shrink_drops_the_preempted_nodes_ranks(self):
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 0},
                  1: {"nproc": 4, "full_nproc": 4, "preempted": 2}}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=8) \
            == {0: (0, 4), 1: (4, 2)}

    def test_a_node_may_drop_to_zero_and_idle(self):
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 0},
                  1: {"nproc": 4, "full_nproc": 4, "preempted": 4}}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=8) \
            == {0: (0, 4), 1: (4, 0)}

    def test_grow_returns_to_capacity_clamped(self):
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 0,
                      "grow": True},
                  1: {"nproc": 0, "full_nproc": 4, "preempted": 0}}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=8) \
            == {0: (0, 4), 1: (4, 4)}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=6) \
            == {0: (0, 4), 1: (4, 2)}

    def test_none_when_below_floor_or_unchanged(self):
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 3},
                  1: {"nproc": 4, "full_nproc": 4, "preempted": 4}}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=8) is None
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 0},
                  1: {"nproc": 4, "full_nproc": 4, "preempted": 0}}
        assert elastic_plan(counts, self.RECORDS, lo=2, hi=8) is None

    def test_host_fingerprint_order_decides_base_ranks(self):
        records = {0: {"host": "zzz"}, 1: {"host": "aaa"}}
        counts = {0: {"nproc": 4, "full_nproc": 4, "preempted": 1},
                  1: {"nproc": 4, "full_nproc": 4, "preempted": 0}}
        assert elastic_plan(counts, records, lo=2, hi=8) \
            == {1: (0, 4), 0: (4, 3)}
        assert elastic_plan(counts, {}, lo=2, hi=8) == {0: (0, 3), 1: (3, 4)}

    def test_placement_pins_validated_against_cluster_size(self):
        from tpu_dist_torch.roles import Role, RoleGraph
        g = RoleGraph([Role("learner", 1), Role("actor", 3, node=1)])
        validate_placement(g, nnodes=2)         # fits
        with pytest.raises(ValueError, match="actor"):
            validate_placement(g, nnodes=1)

    def test_chip_cell_plans_match_jax(self):
        # the cluster_elastic chip cell: one host, so ties go by node id
        rec = {n: {"host": "h"} for n in (0, 1)}
        shrink = {0: {"nproc": 1, "full_nproc": 1, "preempted": 0},
                  1: {"nproc": 1, "full_nproc": 1, "preempted": 1}}
        grow = {0: {"nproc": 1, "full_nproc": 1, "preempted": 0,
                    "grow": True},
                1: {"nproc": 0, "full_nproc": 1, "preempted": 0}}
        for counts, want in ((shrink, {0: (0, 1), 1: (1, 0)}),
                             (grow, {0: (0, 1), 1: (1, 1)})):
            assert elastic_plan(counts, rec, 1, 2) == want
            assert jcluster.elastic_plan(counts, rec, 1, 2) == want


# -- the mixed-package cells: one wire ---------------------------------------------


@pytest.mark.parametrize("leader_pkg,follower_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_followers_tail_across_packages(leader_pkg, follower_pkg,
                                        monkeypatch):
    monkeypatch.delenv(ENDPOINTS_ENV, raising=False)
    monkeypatch.setenv("TPU_DIST_STORE_LOG_MAX", "16")
    srv_cls = {"port": PyTCPStoreServer, "jax": jstore.PyTCPStoreServer}
    fol_cls = {"port": StoreFollower, "jax": jcluster.StoreFollower}
    srv = srv_cls[leader_pkg](0, replicate=True)
    try:
        c = _client(srv.port)
        c.set("pre", b"snapshot")
        c.add("ctr", 3)
        with fol_cls[follower_pkg]("127.0.0.1", srv.port) as fo:
            assert fo.wait_caught_up(srv.replication_seq())
            c.set("tpu_dist/g0/x", b"1")
            c.delete_prefix("tpu_dist/g0/")
            c.add("ctr", 4)
            c.delete_key("pre")
            c.set("post", bytes(range(256)))
            assert fo.wait_caught_up(srv.replication_seq())
            assert fo.seq == srv.replication_seq()
            assert fo.server.snapshot_items("") == srv.snapshot_items("")
            fo.pause()
            for i in range(40):                 # past the 16-entry log
                c.set(f"k/{i}", str(i).encode())
            fo.resume()
            assert fo.wait_caught_up(srv.replication_seq())
            assert fo.server.snapshot_items("") == srv.snapshot_items("")
            assert fo.seq == srv.replication_seq()
        c.close()
    finally:
        srv.stop()


def test_snapshot_and_log_replies_are_byte_identical(monkeypatch):
    # ops 9-10 of the two Python servers, fed the same mutations
    from tpu_dist_torch.dist import store as tstore
    monkeypatch.setenv("TPU_DIST_STORE_LOG_MAX", "6")
    servers = [tstore.PyTCPStoreServer(0, replicate=True),
               jstore.PyTCPStoreServer(0, replicate=True)]
    try:
        replies = []
        for srv in servers:
            c = tstore._PyClient("127.0.0.1", srv.port, 10.0,
                                 follow_endpoints=False)
            c.request(tstore._OP_SET, "a", b"1")
            c.request(tstore._OP_ADD, "n", struct.pack("<q", 7))
            c.request(tstore._OP_DELETE_PREFIX, "a")
            c.request(tstore._OP_DELETE, "none")
            out = [c.request(tstore._OP_SNAPSHOT, ""),
                   c.request(tstore._OP_LOG_SINCE, "",
                             struct.pack("<q", 1))]
            for i in range(8):
                c.request(tstore._OP_SET, f"k{i}", b"v" * i)
            out += [c.request(tstore._OP_LOG_SINCE, "",
                              struct.pack("<q", 1)),   # truncated: flag 1
                    c.request(tstore._OP_LOG_SINCE, "",
                              struct.pack("<q", 10))]
            replies.append(out)
            c.close()
        assert replies[0] == replies[1]
        assert replies[0][2] == b"\x01"
    finally:
        for srv in servers:
            srv.stop()


def _promotion_cell(agent_pkg, client_store_cls, path):
    """A leader and a node-1 follower and agent of ``agent_pkg``; a client
    of the other package, armed with the endpoints file, blocks on a key;
    the leader dies, node 1 promotes itself, and the key set on the new
    leader reaches the blocked client."""
    pk = {"port": (PyTCPStoreServer, StoreFollower, NodeAgent),
          "jax": (jstore.PyTCPStoreServer, jcluster.StoreFollower,
                  jcluster.NodeAgent)}[agent_pkg]
    srv = pk[0](0, replicate=True)
    write_endpoints(path, f"127.0.0.1:{srv.port}", 0)
    fo = pk[1]("127.0.0.1", srv.port, down_after=0.6).start()
    agent = pk[2](1, path, follower=fo, nproc=1, lease_interval=0.1,
                  lease_ttl=0.8).start()
    try:
        c = client_store_cls("127.0.0.1", srv.port, timeout=20.0)
        c.wait([replica_key(1)], timeout=10)
        c.set("before", b"kept")
        assert fo.wait_caught_up(srv.replication_seq())
        t, got = _blocked_get(c, "after")
        time.sleep(0.3)
        srv.stop()
        assert agent.is_leader.wait(timeout=15), "node 1 never promoted"
        doc = read_endpoints(path)
        assert doc["epoch"] == 1 and doc["leader"] == f"127.0.0.1:{fo.port}"
        admin = client_store_cls("127.0.0.1", fo.port, timeout=10.0)
        admin.set("after", b"on-the-new-leader")
        t.join(timeout=20)
        assert got.get("v") == b"on-the-new-leader"
        assert c.get("before") == b"kept"
        admin.close()
        c.close()
    finally:
        agent.stop()
        fo.stop()
        srv.stop()


@pytest.mark.parametrize("agent_pkg", ["port", "jax"])
def test_clients_ride_the_other_packages_promotion(agent_pkg, monkeypatch,
                                                   tmp_path):
    path = str(tmp_path / "ep.json")
    monkeypatch.setenv(ENDPOINTS_ENV, path)
    client = jstore.TCPStore if agent_pkg == "port" else TCPStore
    _promotion_cell(agent_pkg, client, path)


def test_elastic_plan_and_placement_equal_jax_over_a_sweep():
    from tpu_dist import roles as jroles
    from tpu_dist_torch import roles as troles
    rng = np.random.default_rng(15)
    hosts = ["hA", "hB", "hC"]
    for _ in range(400):
        nnodes = int(rng.integers(1, 5))
        counts, records = {}, {}
        for n in range(nnodes):
            full = int(rng.integers(0, 5))
            nproc = int(rng.integers(0, full + 1))
            counts[n] = {"nproc": nproc, "full_nproc": full,
                         "preempted": int(rng.integers(0, nproc + 1))
                         if rng.random() < 0.5 else 0,
                         "grow": bool(rng.random() < 0.3)}
            if rng.random() < 0.8:
                records[n] = {"host": hosts[int(rng.integers(0, 3))]}
        lo = int(rng.integers(1, 4))
        hi = lo + int(rng.integers(0, 8))
        assert elastic_plan(counts, records, lo, hi) == \
            jcluster.elastic_plan(counts, records, lo, hi)
        pins = [None if rng.random() < 0.4 else int(rng.integers(-1, 5))
                for _ in range(3)]
        specs = [("a", 1), ("b", 2), ("c", 1)]
        outcome = []
        for pkg in (troles, jroles):
            roles_ = [pkg.Role(n, w, node=p if p is None or p >= 0 else 0)
                      for (n, w), p in zip(specs, pins)]
            g = pkg.RoleGraph(roles_)
            fn = validate_placement if pkg is troles \
                else jcluster.validate_placement
            try:
                fn(g, nnodes)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
