"""The port's host data plane transport
(``tpu_dist_torch/collectives/transport.py``) against the JAX package's
``tpu_dist/collectives/transport.py``: frames and their checksums, the
named errors, the generation fence, the ring's watchdog, and a JAX
``DataPlane`` and a port ``DataPlane`` over one store exchanging every
frame kind both ways.

The rigs are the JAX tests' own: fake ranks in threads, a ``DataPlane``
each over one ``TCPStore`` bound to port 0; every plane is closed in a
``finally`` and every wait has a timeout."""

import contextlib
import socket
import struct

import numpy as np
import pytest

import ml_dtypes
from tpu_dist.collectives import quant as JQ
from tpu_dist.collectives import transport as JT
from tpu_dist_torch.collectives import _lowp
from tpu_dist_torch.collectives import quant as TQ
from tpu_dist_torch.collectives import ring as TR
from tpu_dist_torch.collectives import transport as TT
from tpu_dist_torch.dist.store import TCPStore

pytestmark = pytest.mark.collectives


@pytest.fixture
def store():
    s = TCPStore(is_master=True, timeout=30)
    yield s
    s.close()


@contextlib.contextmanager
def planes(store, kinds):
    """One DataPlane per rank, ``kinds[r]`` = "t" (port) or "j" (JAX)."""
    dps = []
    try:
        for r, k in enumerate(kinds):
            dps.append((TT if k == "t" else JT).DataPlane(store, r,
                                                          len(kinds)))
        yield dps
    finally:
        for dp in dps:
            dp.close()


def _raw_peer(dp, rank, generation):
    """A raw socket to ``dp``'s listener, past the hello."""
    host, _, port = dp.addr.rpartition(":")
    s = socket.create_connection((host, int(port)), timeout=10)
    s.sendall(TT._HELLO.pack(TT._MAGIC, rank, generation))
    return s


def test_frames_roundtrip_every_dtype_and_shape(store):
    with planes(store, "tt") as (dp0, dp1):
        cases = [np.arange(12, dtype=np.int32).reshape(3, 4),
                 np.linspace(0, 1, 7, dtype=np.float32),
                 _lowp.cast(np.linspace(-2, 2, 12, dtype=np.float32),
                            _lowp.LOWP["bfloat16"]).reshape(2, 3, 2),
                 np.array([], dtype=np.float64),
                 np.array(3.5, dtype=np.float32),
                 np.array([True, False])]
        for arr in cases:
            assert dp0.send_array(1, "t", arr) == arr.nbytes
            got = dp1.recv_array(0, "t", timeout=30)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            np.testing.assert_array_equal(
                got.reshape(-1).view(np.uint8),
                np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        # FIFO per tag, tags apart
        for i in range(3):
            dp0.send_array(1, "a", np.array([i]))
        dp0.send_array(1, "b", np.array([99]))
        assert dp1.recv_array(0, "b", timeout=30)[0] == 99
        assert [int(dp1.recv_array(0, "a", timeout=30)[0])
                for _ in range(3)] == [0, 1, 2]
        assert dp1.try_recv_array(0, "a") is None
        with pytest.raises(TimeoutError, match="rank 0.*tag 'nothing'"):
            dp1.recv_array(0, "nothing", timeout=0.2)
        with pytest.raises(ValueError, match="self"):
            dp0.send_array(0, "t", np.zeros(1))


def test_checksum_and_keys_are_the_jax_packages():
    parts = (b"tpu_dist", np.arange(1000, dtype=np.float32))
    assert TT.frame_checksum(parts) == JT.frame_checksum(parts)
    assert TT.dp_addr_key(3, 7) == JT.dp_addr_key(3, 7)
    assert TT._encode_frame_header(b"t", b"!float32", (2, 3), 24) == \
        JT._encode_frame_header(b"t", b"!float32", (2, 3), 24)

    class _S:
        host, port = "127.0.0.1", 1

    assert TT.store_routed_host(_S()) == JT.store_routed_host(_S())


def test_flipped_byte_raises_frame_corrupt_error(store):
    with planes(store, "tt") as (dp0, dp1):
        payload = np.arange(64, dtype=np.float32)
        raw = payload.tobytes()
        crc = TT.frame_checksum((raw,))
        bad = bytearray(raw)
        bad[17] ^= 0x10
        s = _raw_peer(dp1, 0, dp1.generation)
        try:
            s.sendall(TT._encode_frame_header(b"x", b"!float32", (64,),
                                              len(raw))
                      + struct.pack("<I", crc) + bytes(bad))
            with pytest.raises(TT.FrameCorruptError) as ei:
                dp1.recv_array(0, "x", timeout=30)
        finally:
            s.close()
        e = ei.value
        assert (e.peer, e.tag, e.expected, e.offset) == (0, "x", crc, 0)
        assert e.got == TT.frame_checksum((bytes(bad),)) != crc


def test_closed_peer_raises_peer_gone_naming_it(store):
    with planes(store, "tt") as (dp0, dp1):
        dp0.send_array(1, "x", np.zeros(4))
        dp1.recv_array(0, "x", timeout=30)
        dp0.close()
        with pytest.raises(TT.PeerGoneError) as ei:
            dp1.recv_array(0, "y", timeout=30)
        assert ei.value.peer == 0 and "rank 0" in str(ei.value)


def test_stale_generation_hello_is_refused(store):
    with planes(store, "tt") as (dp0, dp1):
        s = _raw_peer(dp1, 0, dp1.generation + 3)
        try:
            s.sendall(TT._encode_frame_header(b"x", b"float32", (1,), 4)
                      + np.float32(1).tobytes())
            # the reader closes the stale connection without queueing
            s.settimeout(10)
            try:
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
        finally:
            s.close()
        assert dp1.try_recv_array(0, "x") is None
        assert dp1.peer_gone(0) is None     # not dead in this generation


def test_watchdog_names_the_stalled_hop(store, monkeypatch):
    monkeypatch.setenv("TPU_DIST_COLL_TIMEOUT", "0.5")
    assert TT.coll_timeout() == 0.5
    with planes(store, "tt") as (dp0, dp1):
        # rank 1 never joins: rank 0's first wait names the hop 1->0
        with pytest.raises(TT.CollectiveTimeoutError,
                           match=r"stalled hop 1->0"):
            TR.ring_all_reduce(dp0, np.ones(1000, np.float32))
    monkeypatch.setenv("TPU_DIST_COLL_TIMEOUT", "x")
    assert TT.coll_timeout() == 0.0


def test_a_jax_plane_and_a_port_plane_exchange_every_frame(store):
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    bf_port = _lowp.cast(x, _lowp.LOWP["bfloat16"])
    bf_jax = x.astype(ml_dtypes.bfloat16)
    qt = TQ.QuantChunk(*TQ.quantize(x, TQ.QuantScheme(256)),
                       TQ.QuantScheme(256))
    qj = JQ.QuantChunk(*JQ.quantize(x, JQ.QuantScheme(256)),
                       JQ.QuantScheme(256))
    for order in ("jt", "tj"):
        with planes(store, order) as dps:
            port = dps[order.index("t")]
            jax_ = dps[order.index("j")]
            pr, jr = port.rank, jax_.rank
            # float32 both ways
            port.send_array(jr, "f", x)
            jax_.send_array(pr, "f", x)
            np.testing.assert_array_equal(jax_.recv_array(pr, "f", 30), x)
            np.testing.assert_array_equal(port.recv_array(jr, "f", 30), x)
            # bfloat16: bit patterns under the ml_dtypes name
            port.send_array(jr, "b", bf_port)
            jax_.send_array(pr, "b", bf_jax)
            got_j = jax_.recv_array(pr, "b", 30)
            got_t = port.recv_array(jr, "b", 30)
            assert got_j.dtype == np.dtype(ml_dtypes.bfloat16)
            assert got_t.dtype == _lowp.LOWP["bfloat16"]
            np.testing.assert_array_equal(got_j.view(np.uint16),
                                          bf_jax.view(np.uint16))
            np.testing.assert_array_equal(got_t.view(np.uint16),
                                          bf_jax.view(np.uint16))
            # q8b256 frames
            port.send_quant(jr, "q", qt)
            jax_.send_quant(pr, "q", qj)
            for got in (jax_.recv_array(pr, "q", 30),
                        port.recv_array(jr, "q", 30)):
                np.testing.assert_array_equal(got.q, qj.q)
                np.testing.assert_array_equal(got.scales.view(np.uint32),
                                              qj.scales.view(np.uint32))
                assert got.scheme.block == 256


def test_get_data_plane_is_one_a_process(store, monkeypatch):
    import importlib
    rendezvous = importlib.import_module("tpu_dist_torch.dist.rendezvous")
    monkeypatch.setattr(rendezvous, "_store", store)
    assert TT.get_data_plane(None, 0, 2) is None
    assert TT.get_data_plane(store, 0, 1) is None
    try:
        dp = TT.get_data_plane(store, 0, 2)
        assert TT.get_data_plane(store, 0, 2) is dp
        assert store.get(TT.dp_addr_key(0, 0)).decode() == dp.addr
        monkeypatch.setenv("TPU_DIST_NO_DATAPLANE", "1")
        assert TT.get_data_plane(store, 0, 2) is None
    finally:
        TT.close_data_plane()
    assert not store.check(TT.dp_addr_key(0, 0))
