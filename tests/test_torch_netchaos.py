"""The port's network chaos layer (``tpu_dist_torch.resilience.netchaos``)
against the JAX package's: a twin of every test in tests/test_netchaos.py
on the port's data plane, store client and serve wire — every fault kind
(partition, delay, conn-reset, truncate, corrupt, slow-drip) on every
surface (TCP frame, SHM lane, store op, serve wire) ends in its named error
(``FrameCorruptError`` with src, tag and offset, ``CollectiveTimeoutError``
naming the stalled hop, ``PeerGoneError``) or in a degraded path that
completes bit for bit, within its deadline.  The twin of the absent-peer
watchdog case is tests/test_torch_transport.py's
``test_watchdog_names_the_stalled_hop``.

Mixed-package cells: ``parse`` gives the JAX faults, ``corrupt_parts``
flips the JAX bits, a mixed JAX/port ring under
``corrupt:surface=tcp,rank=1,frame=2`` names the same src, tag and offset
whichever package receives, and the port's serve stack meets the JAX
tests/test_serve.py corrupt-submit cell.  Thread ranks, one ``DataPlane``
each over one store, as in the JAX file; every join has a timeout."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tpu_dist.collectives import ring as jring
from tpu_dist.collectives import transport as jtransport
from tpu_dist.resilience import netchaos as jnetchaos
from tpu_dist_torch.collectives import ring
from tpu_dist_torch.collectives.transport import (CollectiveTimeoutError,
                                                  DataPlane,
                                                  FrameCorruptError,
                                                  PeerGoneError,
                                                  frame_checksum)
from tpu_dist_torch.resilience import netchaos

pytestmark = [pytest.mark.netchaos]


@pytest.fixture(autouse=True)
def _fast_deadlines(monkeypatch):
    monkeypatch.setenv("TPU_DIST_DP_TIMEOUT", "15")
    netchaos.uninstall()
    jnetchaos.uninstall()
    yield
    netchaos.uninstall()
    jnetchaos.uninstall()


@pytest.fixture
def store():
    from tpu_dist_torch.dist.store import TCPStore
    s = TCPStore(is_master=True)
    yield s
    s.close()


def _run_world(store, n, fn, timeout=60, planes=None):
    mods = planes or [None] * n
    dps = [(m or DataPlane)(store, r, n) for r, m in enumerate(mods)]
    out, errs = [None] * n, []

    def run(r):
        try:
            out[r] = fn(dps[r], r)
        except Exception as e:
            errs.append((r, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    hung = [t for t in threads if t.is_alive()]
    for dp in dps:
        dp.close()
    assert not hung, "a fault case HUNG past its deadline"
    return out, errs, time.monotonic() - t0


def _all_reduce(tag):
    def fn(dp, r):
        x = np.arange(60000, dtype=np.float32) + r
        red = ring if isinstance(dp, DataPlane) else jring
        return red.ring_all_reduce(dp, x, tag=tag)

    return fn


# -- the spec grammar ----------------------------------------------------------


class TestSpec:
    SPEC = ("corrupt:surface=tcp,rank=1,frame=3,flips=2,seed=7;"
            "delay:surface=serve,delay=0.05;partition:rank=0,peer=1")

    def test_parse_roundtrip(self):
        faults = netchaos.parse(self.SPEC)
        assert [f.kind for f in faults] == ["corrupt", "delay", "partition"]
        assert faults[0].flips == 2 and faults[0].seed == 7
        assert faults[1].surface == "serve" and faults[1].delay == 0.05
        assert faults[2].peer == 1

    @pytest.mark.parametrize("spec", [
        SPEC, "slow-drip:surface=shm,rate=5e7,frame=3",
        "partition:surface=store,node=1",
        " conn-reset : surface = TCP , rank = 0 ; truncate"])
    def test_parse_equals_jax(self, spec):
        mine = [dataclasses.asdict(f) for f in netchaos.parse(spec)]
        theirs = [dataclasses.asdict(f) for f in jnetchaos.parse(spec)]
        assert mine == theirs

    @pytest.mark.parametrize("bad", [
        "", "explode:frame=1", "corrupt:surface=wifi",
        "delay:surface=tcp",              # delay needs delay=
        "slow-drip:surface=tcp",          # slow-drip needs rate=
        "corrupt:frame=0",                # frame is 1-based
        "corrupt:oops",                   # not key=value
        "corrupt:banana=1",               # unknown param
    ])
    def test_bad_specs_raise(self, bad):
        with pytest.raises(ValueError):
            netchaos.parse(bad)
        with pytest.raises(ValueError):
            jnetchaos.parse(bad)

    def test_one_shot_vs_persistent_counting(self):
        nc = netchaos.NetChaos(netchaos.parse(
            "corrupt:surface=tcp,frame=2;partition:surface=shm,frame=2"))
        assert nc.plan("tcp", src=0, dst=1) is None       # frame 1
        assert nc.plan("tcp", src=0, dst=1).kind == "corrupt"
        assert nc.plan("tcp", src=0, dst=1) is None       # one-shot: done
        assert nc.plan("shm", src=0, dst=1) is None
        assert nc.plan("shm", src=0, dst=1).kind == "partition"
        assert nc.plan("shm", src=0, dst=1).kind == "partition"

    def test_scope_matching(self):
        nc = netchaos.NetChaos(netchaos.parse("delay:rank=1,peer=0,delay=1"))
        assert nc.plan("tcp", src=0, dst=1) is None   # wrong direction
        assert nc.plan("tcp", src=1, dst=0).kind == "delay"

    def test_corrupt_parts_deterministic_and_copying(self):
        f = netchaos.parse("corrupt:flips=3,seed=5")[0]
        src = np.arange(1000, dtype=np.float32)
        orig = src.copy()
        out1 = netchaos.NetChaos.corrupt_parts(f, (src,))
        out2 = netchaos.NetChaos.corrupt_parts(f, (src,))
        np.testing.assert_array_equal(src, orig)  # the caller's untouched
        assert bytes(out1[0]) == bytes(out2[0])   # seeded: reproducible
        assert bytes(out1[0]) != src.tobytes()

    @pytest.mark.parametrize("seed,flips", [(0, 1), (5, 3), (11, 64)])
    def test_corrupt_parts_flips_the_jax_bits(self, seed, flips):
        spec = f"corrupt:flips={flips},seed={seed}"
        parts = (np.arange(777, dtype=np.float32),
                 np.arange(33, dtype=np.int8), b"header-ish")
        mine = netchaos.NetChaos.corrupt_parts(netchaos.parse(spec)[0],
                                               parts)
        theirs = jnetchaos.NetChaos.corrupt_parts(jnetchaos.parse(spec)[0],
                                                  parts)
        assert [bytes(m) for m in mine] == [bytes(t) for t in theirs]
        flipped = sum(bin(a ^ b).count("1")
                      for m, p in zip(mine, parts)
                      for a, b in zip(bytes(m), memoryview(p).cast("B")))
        assert flipped == flips


# -- the bounded-backoff helper (the shared reconnect shape) -----------------------


class TestBackoff:
    def test_retries_then_succeeds(self):
        from tpu_dist_torch.utils.backoff import retry_call
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionRefusedError("not up yet")
            return "ok"

        assert retry_call(flaky, timeout=5.0, base=0.001) == "ok"
        assert len(calls) == 3

    def test_deadline_is_named_and_bounded(self):
        from tpu_dist_torch.utils.backoff import (BackoffDeadlineError,
                                                  retry_call)
        t0 = time.monotonic()
        with pytest.raises(BackoffDeadlineError) as ei:
            retry_call(lambda: (_ for _ in ()).throw(OSError("down")),
                       timeout=0.3, what="dial the thing", base=0.01)
        assert time.monotonic() - t0 < 2.0
        assert "dial the thing" in str(ei.value)
        assert isinstance(ei.value.last, OSError)

    def test_non_retryable_propagates_immediately(self):
        from tpu_dist_torch.utils.backoff import retry_call
        with pytest.raises(ValueError):
            retry_call(lambda: (_ for _ in ()).throw(ValueError("logic")),
                       timeout=5.0)


# -- the TCP frame surface: the whole fault matrix ---------------------------------


class TestTcpSurface:
    @pytest.fixture(autouse=True)
    def _tcp_only(self, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SHM", "0")

    def test_partition_raises_collective_timeout_naming_hop(self, store,
                                                            monkeypatch):
        monkeypatch.setenv("TPU_DIST_COLL_TIMEOUT", "1.5")
        netchaos.install("partition:rank=0,peer=1,surface=tcp")
        out, errs, dt = _run_world(store, 2, _all_reduce("part"))
        assert dt < 10.0
        assert errs and all(isinstance(e, CollectiveTimeoutError)
                            for _, e in errs), errs
        msg = str(errs[0][1])
        assert "stalled hop" in msg and "TPU_DIST_COLL_TIMEOUT" in msg

    def test_corrupt_raises_frame_corrupt_naming_src_tag_offset(self,
                                                                store):
        netchaos.install("corrupt:surface=tcp,rank=1,frame=2")
        out, errs, _ = _run_world(store, 2, _all_reduce("corr"))
        named = [e for _, e in errs if isinstance(e, FrameCorruptError)]
        assert named, errs
        e = named[0]
        assert e.peer == 1 and "corr" in e.tag and e.offset >= 0
        assert e.expected != e.got

    def test_conn_reset_names_peer_gone_on_both_sides(self, store):
        netchaos.install("conn-reset:surface=tcp,rank=0,frame=1")
        out, errs, _ = _run_world(store, 2, _all_reduce("rst"))
        assert errs and all(isinstance(e, ConnectionError) for _, e in errs)
        assert any(isinstance(e, PeerGoneError) for _, e in errs), errs

    def test_truncate_is_a_named_connection_error(self, store):
        netchaos.install("truncate:surface=tcp,rank=0,frame=1")
        out, errs, _ = _run_world(store, 2, _all_reduce("trunc"))
        assert errs and all(isinstance(e, ConnectionError) for _, e in errs)

    def test_delay_and_slow_drip_complete_correctly(self, store):
        ref, errs, _ = _run_world(store, 2, _all_reduce("ref"))
        assert not errs
        netchaos.install("delay:surface=tcp,delay=0.005")
        out, errs, _ = _run_world(store, 2, _all_reduce("dly"))
        assert not errs
        np.testing.assert_array_equal(out[0], ref[0])
        netchaos.install("slow-drip:surface=tcp,rate=20000000")
        out, errs, _ = _run_world(store, 2, _all_reduce("drip"))
        assert not errs
        np.testing.assert_array_equal(out[1], ref[1])

    def test_corrupt_without_crc_is_the_documented_hazard(self, store,
                                                          monkeypatch):
        # checksums off: a flipped bit folds silently into the sum — the
        # pathology TPU_DIST_FRAME_CRC (default on) removes
        monkeypatch.setenv("TPU_DIST_FRAME_CRC", "0")
        ref, errs, _ = _run_world(store, 2, _all_reduce("nref"))
        assert not errs
        netchaos.install("corrupt:surface=tcp,rank=1,frame=2")
        out, errs, _ = _run_world(store, 2, _all_reduce("ncorr"))
        assert not errs
        assert not np.array_equal(out[0], ref[0])

    def test_mixed_ring_names_the_same_corrupt_frame(self, store):
        """A JAX and a port rank in one ring, rank 1 flipping its second
        frame: whichever package receives names the same src, tag and
        offset, as an all-port and an all-JAX ring do."""
        spec = "corrupt:surface=tcp,rank=1,frame=2"
        named = {}
        for kinds in ("tt", "jj", "tj", "jt"):
            netchaos.install(spec)
            jnetchaos.install(spec)
            planes = [DataPlane if k == "t" else jtransport.DataPlane
                      for k in kinds]
            out, errs, _ = _run_world(store, 2, _all_reduce("mixc"),
                                      planes=planes)
            got = [e for _, e in errs
                   if isinstance(e, (FrameCorruptError,
                                     jtransport.FrameCorruptError))]
            assert got, (kinds, errs)
            named[kinds] = {(e.peer, e.tag, e.offset, e.nbytes)
                            for e in got}
            assert all(e.expected != e.got for e in got)
        assert len({frozenset(v) for v in named.values()}) == 1, named
        (peer, tag, off, _), = named["tt"]
        assert peer == 1 and "mixc" in tag and off >= 0


# -- the SHM lane surface: named errors or a degradation to TCP ---------------------


class TestShmSurface:
    @pytest.fixture(autouse=True)
    def _shm_on(self, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SHM", "auto")

    def test_lane_break_degrades_to_tcp_bitwise(self, store):
        ref, errs, _ = _run_world(store, 2, _all_reduce("sref"))
        assert not errs
        for kind in ("conn-reset", "truncate"):
            netchaos.install(f"{kind}:surface=shm,rank=0,frame=2")

            def fn(dp, r, _k=kind):
                out = _all_reduce(f"sd-{_k}")(dp, r)
                if r == 0:
                    # the faulted destination stays on inline TCP
                    assert not dp.shm_active(1)
                return out

            out, errs, _ = _run_world(store, 2, fn)
            assert not errs, (kind, errs)
            np.testing.assert_array_equal(out[0], ref[0])
            np.testing.assert_array_equal(out[1], ref[1])

    def test_corrupt_in_lane_raises_frame_corrupt(self, store):
        netchaos.install("corrupt:surface=shm,rank=1,frame=1")
        out, errs, _ = _run_world(store, 2, _all_reduce("scorr"))
        assert any(isinstance(e, FrameCorruptError) for _, e in errs), errs

    def test_partition_is_bounded_by_the_watchdog(self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_COLL_TIMEOUT", "1.5")
        netchaos.install("partition:surface=shm,rank=0,peer=1")
        out, errs, dt = _run_world(store, 2, _all_reduce("spart"))
        assert dt < 10.0
        assert errs and all(isinstance(e, CollectiveTimeoutError)
                            for _, e in errs), errs

    def test_delay_and_slow_drip_complete_over_the_lane(self, store):
        ref, errs, _ = _run_world(store, 2, _all_reduce("sref2"))
        assert not errs
        netchaos.install("delay:surface=shm,delay=0.005;"
                         "slow-drip:surface=shm,rate=50000000,frame=3")
        out, errs, _ = _run_world(store, 2, _all_reduce("sdly"))
        assert not errs
        np.testing.assert_array_equal(out[0], ref[0])


# -- the store surface (the pure-Python client) ------------------------------------


@pytest.fixture
def py_store(monkeypatch):
    monkeypatch.setenv("TPU_DIST_PURE_PYTHON_STORE", "1")
    from tpu_dist_torch.dist import store as store_mod
    store_mod._load_native.reset()
    s = store_mod.TCPStore(is_master=True)
    yield s
    s.close()
    store_mod._load_native.reset()


class TestStoreSurface:
    def test_partition_raises_named_connection_error(self, py_store):
        py_store.set("nc/a", b"1")
        netchaos.install("partition:surface=store,frame=1")
        with pytest.raises(ConnectionError, match="injected store "
                                                  "partition"):
            py_store.get("nc/a")

    def test_conn_reset_is_transparent_for_idempotent_ops(self, py_store):
        py_store.set("nc/b", b"2")
        netchaos.install("conn-reset:surface=store,frame=1")
        assert py_store.get("nc/b") == b"2"  # reconnect-and-replay class

    def test_delay_completes(self, py_store):
        netchaos.install("delay:surface=store,delay=0.01")
        py_store.set("nc/c", b"3")
        assert py_store.get("nc/c") == b"3"

    def test_corrupt_store_payload_fails_loudly_at_the_consumer(self):
        from tpu_dist_torch.collectives.eager import _seal, _unseal
        sealed = bytearray(_seal(b"\x80\x04payload-bytes"))
        assert _unseal(bytes(sealed), "t") == b"\x80\x04payload-bytes"
        sealed[10] ^= 0x40
        with pytest.raises(FrameCorruptError, match="store"):
            _unseal(bytes(sealed), "t")

    def test_corrupt_fault_on_sealed_set_roundtrip(self, py_store):
        from tpu_dist_torch.collectives.eager import _seal, _unseal
        body = b"\x80\x04" + bytes(range(256)) * 8
        raw = _seal(body)
        netchaos.install("corrupt:surface=store,frame=1")
        py_store.set("nc/d", raw)       # the payload flipped on the wire
        netchaos.uninstall()
        with pytest.raises(FrameCorruptError):
            _unseal(py_store.get("nc/d"), "nc/d")


# -- the serve wire surface --------------------------------------------------------


class TestServeWire:
    def _pair(self):
        a, b = socket.socketpair()
        a.settimeout(10.0)
        b.settimeout(10.0)
        return a, b

    def test_frame_roundtrip_is_checksummed(self):
        from tpu_dist_torch.serve.frontend import read_frame, send_frame
        a, b = self._pair()
        try:
            send_frame(a, {"type": "submit", "id": 7, "prompt": [1, 2]})
            got = read_frame(b)
            assert got["id"] == 7 and got["prompt"] == [1, 2]
        finally:
            a.close()
            b.close()

    def test_corrupt_raises_frame_corrupt(self):
        from tpu_dist_torch.serve._wire import FrameCorruptError as SFCE
        from tpu_dist_torch.serve.frontend import read_frame, send_frame
        netchaos.install("corrupt:surface=serve,frame=1")
        a, b = self._pair()
        try:
            send_frame(a, {"type": "token", "id": 1, "t": 42})
            with pytest.raises(SFCE):
                read_frame(b)
        finally:
            a.close()
            b.close()

    def test_truncate_and_reset_are_named_connection_errors(self):
        from tpu_dist_torch.serve.frontend import read_frame, send_frame
        for kind in ("truncate", "conn-reset"):
            netchaos.install(f"{kind}:surface=serve,frame=1")
            a, b = self._pair()
            try:
                with pytest.raises(ConnectionError):
                    send_frame(a, {"type": "token", "id": 1, "t": 1})
                if kind == "truncate":
                    with pytest.raises((ConnectionError, socket.timeout)):
                        read_frame(b)
            finally:
                a.close()
                b.close()

    def test_partition_blackholes_but_waits_stay_bounded(self):
        from tpu_dist_torch.serve.frontend import read_frame, send_frame
        netchaos.install("partition:surface=serve")
        a, b = self._pair()
        b.settimeout(0.5)
        try:
            send_frame(a, {"type": "token", "id": 1, "t": 1})  # never leaves
            with pytest.raises((socket.timeout, ConnectionError)):
                read_frame(b)
        finally:
            a.close()
            b.close()

    def test_delay_completes(self):
        from tpu_dist_torch.serve.frontend import read_frame, send_frame
        netchaos.install("delay:surface=serve,delay=0.01")
        a, b = self._pair()
        try:
            send_frame(a, {"type": "done", "id": 3, "reason": "eos",
                           "n": 2})
            assert read_frame(b)["reason"] == "eos"
        finally:
            a.close()
            b.close()

    def test_a_corrupt_port_frame_fails_the_jax_reader_alike(self):
        # the checksum comes before the fault, so the JAX reader catches the
        # port's flipped frame with its own named error
        from tpu_dist.serve.frontend import read_frame as jread
        from tpu_dist_torch.serve.frontend import send_frame
        netchaos.install("corrupt:surface=serve,frame=1,seed=3")
        a, b = self._pair()
        try:
            send_frame(a, {"type": "token", "id": 1, "t": 42})
            with pytest.raises(jtransport.FrameCorruptError):
                jread(b)
        finally:
            a.close()
            b.close()


class TestServeStack:
    """The port's twin of the JAX tests/test_serve.py TestServeNetchaos
    cells, on the full stack: engine, scheduler, frontend and client."""

    CFG = dict(vocab_size=61, dim=32, depth=1, num_heads=2, max_seq_len=32)

    @pytest.fixture
    def stack(self):
        from tpu_dist_torch import serve
        from tpu_dist_torch.models import TransformerLM
        torch.manual_seed(0)
        model = TransformerLM(**self.CFG, device="cpu")
        sched = serve.Scheduler(serve.SlotEngine(model, num_slots=2,
                                                 device="cpu"),
                                batch_window=0.0)
        fe = serve.Frontend(sched, port=0)
        yield serve, model, fe
        fe.close()
        sched.close()

    def test_corrupt_submit_fails_bounded_and_named(self, stack):
        serve, _, fe = stack
        cli = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10)
        try:
            netchaos.install("corrupt:surface=serve,frame=1")
            h = cli.submit(list(range(4)), max_new_tokens=4)
            with pytest.raises((serve.ServerGoneError,
                                serve.RequestFailedError)):
                h.wait_done(15.0)
        finally:
            netchaos.uninstall()
            cli.close()

    def test_delayed_wire_still_completes(self, stack):
        serve, model, fe = stack
        cli = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10)
        try:
            netchaos.install("delay:surface=serve,delay=0.002")
            prompt = np.arange(5, dtype=np.int64)
            got = cli.generate(prompt.tolist(), max_new_tokens=4,
                               timeout=60.0)
            ref = model.generate(torch.as_tensor(prompt)[None], 4)
            assert got == ref[0, 5:].tolist()
        finally:
            netchaos.uninstall()
            cli.close()


# -- the collective watchdog ------------------------------------------------------


class TestWatchdog:
    def test_watchdog_error_carries_obs_position_when_armed(
            self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SHM", "0")
        monkeypatch.setenv("TPU_DIST_COLL_TIMEOUT", "1.0")
        monkeypatch.setenv("TPU_DIST_OBS", "1")
        from tpu_dist_torch.obs import recorder as rec_mod
        rec_mod.reset()
        try:
            def fn(dp, r):
                if r == 1:
                    return None
                return _all_reduce("owedge")(dp, r)

            out, errs, _ = _run_world(store, 2, fn)
            assert errs and "flight recorder" in str(errs[0][1])
        finally:
            rec_mod.reset()

    def test_disabled_watchdog_defers_to_dp_timeout(self, store,
                                                    monkeypatch):
        monkeypatch.setenv("TPU_DIST_SHM", "0")
        monkeypatch.setenv("TPU_DIST_DP_TIMEOUT", "1.0")
        monkeypatch.delenv("TPU_DIST_COLL_TIMEOUT", raising=False)

        def fn(dp, r):
            if r == 1:
                return None
            return _all_reduce("dwedge")(dp, r)

        out, errs, dt = _run_world(store, 2, fn)
        assert dt < 10.0
        assert len(errs) == 1 and isinstance(errs[0][1], TimeoutError)


# -- frame-checksum interop --------------------------------------------------------


class TestFrameCrc:
    def test_checksum_streaming_matches_whole(self):
        a = np.random.default_rng(3).integers(0, 255, 10000, dtype=np.uint8)
        assert frame_checksum((a,)) == frame_checksum((a[:1234], a[1234:]))

    def test_one_sided_arming_interoperates(self, store, monkeypatch):
        monkeypatch.setenv("TPU_DIST_SHM", "0")
        ref, errs, _ = _run_world(store, 2, _all_reduce("cref"))
        assert not errs
        monkeypatch.setenv("TPU_DIST_FRAME_CRC", "0")
        out, errs, _ = _run_world(store, 2, _all_reduce("coff"))
        assert not errs
        np.testing.assert_array_equal(out[0], ref[0])
