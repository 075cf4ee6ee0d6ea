"""The port's shared-memory lanes, topology, data-plane sub-groups, the
hierarchical ring and the algorithm selection
(``tpu_dist_torch/collectives/{shm,topology}.py``) against the JAX
package's ``tpu_dist/collectives/{shm,topology}.py``.  The hierarchical
ring is held bit for bit to the flat ring and to the JAX hierarchical ring;
host layouts are simulated per rank with ``TPU_DIST_HOST_ID_R{rank}``, as
the JAX tests' rigs simulate them."""

import os
import threading

import numpy as np
import pytest

from tpu_dist.collectives import ring as JR
from tpu_dist.collectives import topology as JTo
from tpu_dist.collectives import transport as JT
from tpu_dist_torch.collectives import ring as TR
from tpu_dist_torch.collectives import shm as TS
from tpu_dist_torch.collectives import topology as TTo
from tpu_dist_torch.collectives import transport as TT
from tpu_dist_torch.dist.store import TCPStore

pytestmark = pytest.mark.collectives


@pytest.fixture
def store():
    s = TCPStore(is_master=True, timeout=30)
    yield s
    s.close()


@pytest.fixture
def hosts(monkeypatch):
    def set_hosts(layout):
        for r, h in layout.items():
            monkeypatch.setenv(f"TPU_DIST_HOST_ID_R{r}", h)
    monkeypatch.delenv("TPU_DIST_HOST_ID", raising=False)
    monkeypatch.setenv("TPU_DIST_ALGO_CORES", "8")
    return set_hosts


def run_world(store, n, fn, kind="t", timeout=120):
    P = TT if kind == "t" else JT
    dps, out, errs = [], [None] * n, []
    try:
        for r in range(n):
            dps.append(P.DataPlane(store, r, n))

        def run(r):
            try:
                out[r] = fn(dps[r], r)
            except Exception as e:  # surfaced below
                errs.append((r, repr(e)))

        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        shm = [any(dp.shm_active(p) for p in range(n) if p != dp.rank)
               for dp in dps]
    finally:
        for dp in dps:
            dp.close()
    assert not errs, errs
    return out, shm


def _lanes_left():
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(f"tpdp_g0_{os.getpid()}_"))
    except OSError:
        return []


def test_lane_roundtrip_wraparound_and_resume():
    tx = TS.ShmLane(create=True, capacity=4096)
    try:
        rx = TS.ShmLane(name=tx.name, capacity=tx.capacity)
        assert tx.name.startswith(f"tpdp_g0_{os.getpid()}_")
        data = np.random.default_rng(0).integers(0, 255, 10000).astype(
            np.uint8)
        got = bytearray(data.size)
        t = threading.Thread(target=lambda: rx.read_into(got, timeout=30))
        t.start()
        tx.write(data, timeout=30)          # bigger than the ring: resumes
        t.join(30)
        assert bytes(got) == data.tobytes()
        with pytest.raises(TimeoutError):
            rx.read_into(bytearray(8), timeout=0.2)
        with pytest.raises(ConnectionError, match="peer went"):
            rx.read_into(bytearray(8), timeout=30,
                         abort_check=lambda: "peer went")
        rx.close()
    finally:
        tx.close()
        tx.unlink()
    assert TS.ring_capacity() == 8 << 20


def test_frames_ride_lanes_when_colocated_and_tcp_otherwise(
        store, hosts, monkeypatch):
    a = np.arange(300001, dtype=np.float32)

    def send(dp, r):
        if r == 0:
            dp.send_array(1, "t", a)
            return None
        return dp.recv_array(0, "t", timeout=30)

    hosts({0: "hX", 1: "hX"})
    out, shm = run_world(store, 2, send)
    np.testing.assert_array_equal(out[1], a)
    assert shm[0], "a co-located pair takes a lane"
    hosts({0: "hX", 1: "hY"})
    out, shm = run_world(store, 2, send)
    np.testing.assert_array_equal(out[1], a)
    assert not shm[0]
    hosts({0: "hX", 1: "hX"})
    monkeypatch.setenv("TPU_DIST_SHM", "0")
    out, shm = run_world(store, 2, send)
    np.testing.assert_array_equal(out[1], a)
    assert not shm[0]
    assert _lanes_left() == []      # the receiver unlinked at attach


@pytest.mark.parametrize("wire", [None, "int8_block256"])
@pytest.mark.parametrize("world,layout", [
    (2, {0: "a", 1: "a"}),
    (3, {0: "a", 1: "a", 2: "b"}),
    (4, {0: "a", 1: "a", 2: "b", 3: "b"}),
    (4, {0: "a", 1: "b", 2: "a", 3: "b"}),
], ids=["w2", "w3", "w4", "w4-interleaved"])
def test_hier_equals_flat_and_the_jax_hier(store, hosts, world, layout,
                                           wire):
    hosts(layout)

    def fn(T, R):
        def body(dp, r):
            x = np.random.default_rng(20 + r).standard_normal(10007) \
                .astype(np.float32)
            topo = T.detect_topology(dp)
            h = T.hier_all_reduce(dp, x, op="avg", tag="h",
                                  comm_dtype=wire)
            f = R.ring_all_reduce(dp, x, op="avg", tag="f", comm_dtype=wire)
            return h.tobytes(), f.tobytes(), topo.host_major_order()
        return body

    port, shm = run_world(store, world, fn(TTo, TR))
    jax_, _ = run_world(store, world, fn(JTo, JR), kind="j")
    assert port == jax_
    assert len({o[0] for o in port}) == 1
    if sorted(layout.values()) == list(layout.values()):   # host-contiguous
        assert all(o[0] == o[1] for o in port)
        assert port[0][2] == list(range(world))
    else:
        assert port[0][2] == [0, 2, 1, 3]
    assert any(shm)


@pytest.mark.parametrize("env,nbytes,hosts_,cores,want", [
    ({}, 8 << 20, "aabb", None, None),
    ({}, 1024, "aabb", None, None),
    ({}, 8 << 20, "abcd", None, None),
    ({"TPU_DIST_ALGO_CORES": "2"}, 8 << 20, "aaaa", None, None),
    ({"TPU_DIST_ALGO_CORES": ""}, 8 << 20, "aabb", [1, 1, 16, 16], None),
    ({"TPU_DIST_ALGO_CORES": ""}, 8 << 20, "aabb", [16] * 4, None),
    ({"TPU_DIST_ALGO": "flat"}, 8 << 20, "aabb", None, None),
    ({"TPU_DIST_ALGO": "hier"}, 1024, "aabb", None, None),
    ({"TPU_DIST_ALGO": "store"}, 1024, "aabb", None, None),
    ({"TPU_DIST_ALGO": "bogus"}, 1024, "aabb", None, ValueError),
    ({"TPU_DIST_HIER_THRESHOLD": "100"}, 1024, "aabb", None, None),
])
def test_select_algo_matches_jax(monkeypatch, env, nbytes, hosts_, cores,
                                 want):
    monkeypatch.setenv("TPU_DIST_ALGO_CORES", "8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for T in (TTo, JTo):
        topo = T.Topology(list(hosts_), cores)
        if want is ValueError:
            with pytest.raises(ValueError, match="TPU_DIST_ALGO"):
                T.select_algo(nbytes, topo=topo)
            continue
        got.append((T.select_algo(nbytes, topo=topo), T.algo_mode(),
                    topo.min_cores, topo.host_major_order(), topo.nhosts,
                    topo.colocated))
    assert want is ValueError or got[0] == got[1]


def test_host_records_and_fingerprints_match_jax(monkeypatch):
    monkeypatch.setenv("TPU_DIST_HOST_ID_R3", "rack3")
    monkeypatch.setenv("TPU_DIST_HOST_ID", "boxA")
    for r in (None, 3, 4):
        assert TTo.host_fingerprint(r) == JTo.host_fingerprint(r)
    monkeypatch.delenv("TPU_DIST_HOST_ID")
    assert TTo.host_fingerprint(0) == JTo.host_fingerprint(0)
    assert TTo.host_key(2, 5) == JTo.host_key(2, 5)
    for raw in (b'{"host": "h", "cores": 8}', b"legacy-fingerprint"):
        assert TTo.parse_host_record(raw) == JTo.parse_host_record(raw)
    TTo.reset_algo_counters()
    TTo.record_algo("all_reduce", "hier")
    TTo.record_algo("all_reduce", "hier")
    assert TTo.algo_counters(reset=True) == {"all_reduce/hier": 2}
    assert TTo.algo_counters() == {}


def test_subgroups_match_jax_and_scope_the_ring(store, hosts):
    hosts({r: "a" for r in range(4)})
    for members, parent in (((2, 0, 3), 3), ((1, 2), 0)):
        t = TTo.SubGroup(members, parent, 4, instance=1)
        j = JTo.SubGroup(members, parent, 4, instance=1)
        assert (t.group_id, t.member_hash, t.set_scope, t.rank,
                t.num_processes, t.describe()) == \
            (j.group_id, j.member_hash, j.set_scope, j.rank,
             j.num_processes, j.describe())
    outsider = TTo.SubGroup((1, 2), 0, 4, instance=0)
    with pytest.raises(TTo.GroupMembershipError, match="not a member"):
        outsider.require_member()
    with pytest.raises(ValueError, match="duplicate"):
        TTo.SubGroup((1, 1), 0, 4, instance=0)

    class _World:
        rank, num_processes = 0, 4

    g0 = TTo.new_group([0, 1], group=_World())
    g1 = TTo.new_group([0, 1], group=_World())
    assert g0.group_id != g1.group_id      # a creation counter apart

    def fn(T, R):
        def body(dp, r):
            # every rank creates both groups in the same order; each ring
            # runs in its own group with its own tags
            groups = [T.SubGroup(m, r, 4, instance=0)
                      for m in ((0, 1), (3, 2))]
            mine = groups[0] if r in (0, 1) else groups[1]
            x = np.full(5000, float(r + 1), np.float32)
            return R.ring_all_reduce(mine.view(dp), x, op="sum",
                                     comm_dtype="int8_block256",
                                     tag="g").tobytes()
        return body

    port, _ = run_world(store, 4, fn(TTo, TR))
    jax_, _ = run_world(store, 4, fn(JTo, JR), kind="j")
    assert port == jax_
    assert np.frombuffer(port[0], np.float32)[0] == 3.0
    assert np.frombuffer(port[2], np.float32)[0] == 7.0
