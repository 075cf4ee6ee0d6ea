"""The port's control-plane store (``tpu_dist_torch.dist.store``) against the
JAX package's (``tpu_dist.dist.store``): the wire's eight ops (SET, GET,
ADD, CHECK, DELETE, NUMKEYS, WAIT_GE, DELETE_PREFIX) from every client to
every server — the port's and the JAX package's, native (C++ through
ctypes) and pure Python — the store API on each of the port's servers
(``barrier``, blocking ``get``/``wait_value_ge``), the Python client's
reconnect rules, the two native libraries in one process, and
``FileStore``.  Every blocking wait has a timeout of its own."""

import ctypes
import struct
import threading
import time

import pytest

from tpu_dist.dist import store as jstore
from tpu_dist_torch.dist import store as tstore
from tpu_dist_torch.ops import _build

_PKGS = {"port": tstore, "jax": jstore}


def _use(pkg, native: bool, monkeypatch):
    """Make ``pkg``'s next TCPStore native or pure Python."""
    if native:
        monkeypatch.delenv("TPU_DIST_PURE_PYTHON_STORE", raising=False)
    else:
        monkeypatch.setenv("TPU_DIST_PURE_PYTHON_STORE", "1")
    pkg._load_native.reset()


@pytest.fixture(autouse=True)
def _fresh_native():
    yield
    tstore._load_native.reset()
    jstore._load_native.reset()


def _all_ops(c) -> None:
    """Every op of the wire through client ``c``, with its answer."""
    c.set("a/b", b"x\x00y")                                   # SET
    assert c.get("a/b") == b"x\x00y"                          # GET
    assert c.add("ctr", 5) == 5 and c.add("ctr", -2) == 3     # ADD
    assert c.check("a/b") and not c.check("nope")             # CHECK
    c.set("p/1", b"1")
    c.set("p/2", "2")
    assert c.num_keys() == 4                                  # NUMKEYS
    assert c.delete_prefix("p/") == 2                         # DELETE_PREFIX
    assert c.delete_key("a/b") and not c.delete_key("a/b")    # DELETE
    assert c.num_keys() == 1
    c.wait_value_ge("ctr", 3)                                 # WAIT_GE


@pytest.mark.parametrize("server", ["port-native", "port-python",
                                    "jax-native", "jax-python"])
@pytest.mark.parametrize("client", ["port-native", "port-python",
                                    "jax-native", "jax-python"])
def test_every_client_against_every_server(server, client, monkeypatch):
    spkg, simpl = server.split("-")
    cpkg, cimpl = client.split("-")
    _use(_PKGS[spkg], simpl == "native", monkeypatch)
    srv = _PKGS[spkg].TCPStore(is_master=True, timeout=10)
    try:
        assert srv.native == (simpl == "native")
        _use(_PKGS[cpkg], cimpl == "native", monkeypatch)
        cli = _PKGS[cpkg].TCPStore("127.0.0.1", srv.port, timeout=10)
        try:
            assert cli.native == (cimpl == "native")
            _all_ops(cli)
            # a blocked GET and WAIT_GE wake when another client writes
            got = {}
            t = threading.Thread(target=lambda: got.update(
                v=cli.get("late"), w=cli.wait_value_ge("gate", 2)))
            t.start()
            time.sleep(0.1)
            assert t.is_alive()
            srv.set("late", b"now")
            srv.add("gate", 2)
            t.join(timeout=10)
            assert not t.is_alive() and got["v"] == b"now"
        finally:
            cli.close()
    finally:
        srv.close()


@pytest.fixture(params=["native", "python"])
def store(request, monkeypatch):
    _use(tstore, request.param == "native", monkeypatch)
    s = tstore.TCPStore(is_master=True, timeout=10)
    assert s.native == (request.param == "native")
    yield s
    s.close()


class TestStoreAPI:
    def test_barrier_two_clients_reusable(self, store):
        other = tstore.TCPStore(store.host, store.port, timeout=10)
        done = []

        def peer():
            for _ in range(3):
                other.barrier(2, tag="t", timeout=10)
                done.append(1)

        t = threading.Thread(target=peer)
        t.start()
        for i in range(3):
            time.sleep(0.05)
            store.barrier(2, tag="t", timeout=10)
        t.join(timeout=10)
        assert len(done) == 3
        assert store.add("__barrier__/t", 0) == 6
        other.close()

    def test_barrier_times_out_naming_the_key(self, store):
        with pytest.raises(TimeoutError, match="__barrier__/lonely"):
            store.barrier(2, tag="lonely", timeout=0.3)

    def test_wait_names_the_missing_key(self, store):
        with pytest.raises(TimeoutError, match="missing-key"):
            store.wait(["missing-key"], timeout=0.2)

    def test_binary_values_and_str_coercion(self, store):
        payload = bytes(range(256)) * 4
        store.set("bin", payload)
        store.set("s", "text")
        assert store.get("bin") == payload and store.get("s") == b"text"

    def test_port_zero_picks_a_free_port_and_closes(self, store):
        other = tstore.TCPStore(is_master=True, timeout=10)
        assert other.port not in (0, store.port)
        client = tstore.TCPStore("127.0.0.1", other.port, timeout=10)
        other.close()
        # the server is gone: a blocking read answers "stopping" or finds
        # the connection shut (the freed port itself may be reused at once
        # by another process, so it is not dialled again)
        with pytest.raises((RuntimeError, ConnectionError)):
            client.get("never-set")
        client.close()

    def test_refuses_later_items_by_name(self, monkeypatch, tmp_path):
        # the variables once refused: the replication log and the endpoints
        # file take the Python wire on both sides, whose server answers
        # ops 9-10, and TPU_DIST_NETCHAOS arms the client's store surface
        from tpu_dist_torch.cluster import replica, write_endpoints
        from tpu_dist_torch.resilience import netchaos
        ep = str(tmp_path / "ep.json")
        for var, val in (("TPU_DIST_STORE_REPLICATE", "1"),
                         ("TPU_DIST_STORE_ENDPOINTS", ep)):
            monkeypatch.setenv(var, val)
            s = tstore.TCPStore(is_master=True)
            write_endpoints(ep, f"127.0.0.1:{s.port}", 0)
            assert not s.native and s._server._replicate == (
                var == "TPU_DIST_STORE_REPLICATE")
            c = tstore.TCPStore("127.0.0.1", s.port, timeout=10)
            assert not c.native
            c.set("k", b"v")
            assert c.add("n", 2) == 2
            seq, kv = replica.parse_snapshot(
                c._client.request(tstore._OP_SNAPSHOT, ""))
            assert kv == {"k": b"v", "n": struct.pack("<q", 2)}
            assert seq == 2
            c.close()
            s.close()
            monkeypatch.delenv(var)
        srv = tstore.PyTCPStoreServer(replicate=True)
        c = tstore._PyClient("127.0.0.1", srv.port, 10.0)
        c.request(tstore._OP_DELETE_PREFIX, "none/")
        log = replica.parse_log(c.request(tstore._OP_LOG_SINCE, "",
                                          struct.pack("<q", 0)))
        assert log == (1, [(1, tstore._OP_DELETE_PREFIX, "none/", b"")])
        c.close()
        srv.stop()
        monkeypatch.setenv("TPU_DIST_NETCHAOS",
                           "delay:surface=store,delay=0.01")
        monkeypatch.setenv("TPU_DIST_PURE_PYTHON_STORE", "1")
        tstore._load_native.reset()
        try:
            s = tstore.TCPStore(is_master=True)
            t0 = time.monotonic()
            s.set("slow", b"1")
            assert time.monotonic() - t0 >= 0.01 and s.get("slow") == b"1"
            s.close()
        finally:
            netchaos.uninstall()
            monkeypatch.delenv("TPU_DIST_NETCHAOS")
            monkeypatch.delenv("TPU_DIST_PURE_PYTHON_STORE")
            tstore._load_native.reset()
        # TPU_DIST_OBS, once refused, arms the client's op events: one
        # kind="store" event a request, none for the polling CHECK
        from tpu_dist_torch.obs import recorder
        monkeypatch.setenv("TPU_DIST_OBS", "1")
        recorder.reset()
        try:
            s = tstore.TCPStore(is_master=True)
            s.set("k", b"vv")
            assert s.get("k") == b"vv" and s.check("k")
            assert s.add("n", 3) == 3
            s.delete_key("k")
            s.close()
            evs = [e for e in recorder.get_recorder().snapshot()
                   if e["kind"] == "store"]
            assert [(e["op"], e["key"], e["outcome"]) for e in evs] == [
                ("set", "k", "ok"), ("get", "k", "ok"), ("add", "n", "ok"),
                ("delete", "k", "ok")]
            assert evs[0]["bytes"] == 2 and evs[2]["bytes"] == 8
        finally:
            monkeypatch.delenv("TPU_DIST_OBS")
            recorder.reset()


class TestReconnect:
    """The pure-Python client: bounded reconnect for the idempotent ops,
    at-most-once for writes, a named error (not a hang) when the server
    is gone — as the JAX package's client does."""

    @pytest.fixture
    def py_store(self, monkeypatch):
        _use(tstore, False, monkeypatch)
        s = tstore.TCPStore(is_master=True, timeout=10)
        yield s
        s.close()

    @pytest.mark.parametrize("op", ["get", "check", "delete_prefix"])
    def test_idempotent_op_survives_a_dropped_connection(self, py_store, op):
        py_store.set("k", b"v")
        py_store._client._sock.close()  # a simulated ECONNRESET
        want = {"get": b"v", "check": True, "delete_prefix": 1}[op]
        assert getattr(py_store, op)("k") == want

    @pytest.mark.parametrize("op", ["set", "add", "delete_key"])
    def test_write_is_not_replayed_but_the_next_request_works(self, py_store,
                                                              op):
        py_store.set("n", struct.pack("<q", 1))
        py_store._client._sock.close()
        args = {"set": ("n", b"x"), "add": ("n", 1),
                "delete_key": ("n",)}[op]
        with pytest.raises(ConnectionError):
            getattr(py_store, op)(*args)
        # nothing was applied, and the next request has a fresh socket
        assert py_store.get("n") == struct.pack("<q", 1)

    def test_server_death_mid_wait_raises_not_hangs(self, py_store):
        client = tstore.TCPStore(py_store.host, py_store.port, timeout=10)
        errs = []

        def waiter():
            try:
                client.wait_value_ge("never", 5)
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.2)
        py_store.close()
        t.join(timeout=30)
        assert not t.is_alive(), "client hung after server death"
        assert errs and isinstance(errs[0], (ConnectionError, RuntimeError))
        client.close()


def test_both_native_libraries_in_one_process(monkeypatch):
    """The port's library and the JAX package's, loaded side by side,
    each serving its own package: their C symbols differ, and ctypes
    opens both RTLD_LOCAL."""
    _use(tstore, True, monkeypatch)
    _use(jstore, True, monkeypatch)
    ours = tstore._load_native()
    theirs = jstore._load_native()
    assert ours is not None and theirs is not None
    assert hasattr(ours, "tdt_store_set")
    with pytest.raises(AttributeError):
        ours.tpudist_store_set
    with pytest.raises(AttributeError):
        theirs.tdt_store_set
    a = tstore.TCPStore(is_master=True, timeout=10)
    b = jstore.TCPStore(is_master=True, timeout=10)
    try:
        a.set("k", b"port")
        b.set("k", b"jax")
        assert a.get("k") == b"port" and b.get("k") == b"jax"
        assert a.native and b.native
    finally:
        a.close()
        b.close()


def test_host_build_is_cached_by_digest():
    so = _build.build_host("tcpstore")
    assert so.parent.name == "_build" and so.exists()
    assert _build.build_host("tcpstore") == so
    lib = ctypes.CDLL(str(so))
    assert lib.tdt_store_server_start


class TestFileStore:
    def test_roundtrip_against_the_jax_file_store(self, tmp_path):
        ours = tstore.FileStore(str(tmp_path / "s"))
        theirs = jstore.FileStore(str(tmp_path / "s"))
        ours.set("k/with/slash", b"v")
        assert theirs.get("k/with/slash") == b"v"
        assert ours.add("c", 2) == 2 and theirs.add("c", 2) == 4
        theirs.set("p/1", b"1")
        assert ours.num_keys() == theirs.num_keys() == 3
        assert ours.delete_prefix("p/") == 1
        assert ours.delete_key("c") and not theirs.check("c")
        assert ours.num_keys() == 1

    def test_concurrent_add(self, tmp_path):
        s = tstore.FileStore(str(tmp_path / "s"))
        threads = [threading.Thread(target=lambda: [s.add("n", 1)
                                                    for _ in range(20)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert s.add("n", 0) == 80
