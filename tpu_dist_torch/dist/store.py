"""Key-value stores for the control plane — counterpart of
``tpu_dist/dist/store.py`` (c10d Store parity), on the same wire.

- :class:`TCPStore`: a C++ server and client (``csrc/tcpstore.cpp``, built
  with g++ at first use) speaking a length-prefixed protocol, and a
  pure-Python server and client of the *same* protocol, taken when the
  library cannot be built or ``TPU_DIST_PURE_PYTHON_STORE=1``.  Every pair
  interoperates, with each other and with the JAX package's servers and
  clients: the launchers, workers and gateways of both packages meet in
  one store.
- :class:`FileStore`: a shared-filesystem store for one host.

API (torch Store parity): ``set/get/add/wait/check/delete_key/num_keys``,
``delete_prefix`` (the restart-time reaper), and ``barrier(world_size)``
built on ``add`` and a server-side blocking WAIT_GE.  ``get`` blocks until
the key exists, the property rendezvous relies on.

With the flight recorder armed (``TPU_DIST_OBS``), every client request
but the polling ones (``check``, ``num_keys``) leaves one ``kind="store"``
event.  Not in the port yet, each refused by name: the replication log and
leader failover (ops 9-10, ``TPU_DIST_STORE_ENDPOINTS``/
``TPU_DIST_STORE_REPLICATE``: ROADMAP A9.2b) and network fault injection
(``TPU_DIST_NETCHAOS``: A9.4).
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time
from typing import List, Optional

__all__ = ["Store", "TCPStore", "FileStore", "PyTCPStoreServer"]

# Wire protocol op codes (must match csrc/tcpstore.cpp)
(_OP_SET, _OP_GET, _OP_ADD, _OP_CHECK, _OP_DELETE, _OP_NUMKEYS, _OP_WAIT_GE,
 _OP_DELETE_PREFIX) = range(1, 9)


def _armed(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def _refuse_later_items() -> None:
    """Raise for an environment that asks for store machinery the port does
    not have yet, naming the ROADMAP item that brings it."""
    if _armed("TPU_DIST_STORE_ENDPOINTS") or _armed("TPU_DIST_STORE_REPLICATE"):
        raise NotImplementedError(
            "store replication and leader failover (TPU_DIST_STORE_ENDPOINTS"
            ", TPU_DIST_STORE_REPLICATE, wire ops 9-10) come with the "
            "control plane's cluster half, ROADMAP A9.2b")
    if _armed("TPU_DIST_NETCHAOS"):
        raise NotImplementedError(
            "network fault injection on the store (TPU_DIST_NETCHAOS) "
            "comes with ROADMAP A9.4")


class Store:
    """Abstract store interface (torch.distributed.Store parity)."""

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """Blocks until ``key`` exists, then returns its value."""
        raise NotImplementedError

    def add(self, key: str, delta: int) -> int:
        raise NotImplementedError

    def check(self, key: str) -> bool:
        raise NotImplementedError

    def delete_key(self, key: str) -> bool:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        """Delete every key starting with ``prefix``; returns the count (the
        launcher's restart-time reaper of a crashed generation's keys)."""
        raise NotImplementedError

    def num_keys(self) -> int:
        raise NotImplementedError

    def wait(self, keys: List[str], timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for k in keys:
            while not self.check(k):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"wait timed out on key {k!r}")
                time.sleep(0.01)

    def barrier(self, world_size: int, tag: str = "default",
                timeout: Optional[float] = None) -> None:
        """All ``world_size`` callers block until everyone arrives.

        Reusable with the same tag: the arrival counter only grows, and each
        caller waits for the next full multiple of ``world_size`` (the
        generation scheme of c10d's store barrier)."""
        key = f"__barrier__/{tag}"
        n = self.add(key, 1)
        generation = (n - 1) // world_size
        self.wait_value_ge(key, (generation + 1) * world_size,
                           timeout=timeout)

    def wait_value_ge(self, key: str, target: int,
                      timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.add(key, 0) < target:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"wait_value_ge timed out on {key!r}")
            time.sleep(0.01)


def _i64(b: bytes) -> int:
    return struct.unpack("<q", b[:8].ljust(8, b"\0"))[0]


def _recv_all(conn, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class PyTCPStoreServer:
    """The pure-Python server of the wire (ops 1-8), one thread a
    connection.  Taken when the native library cannot be built or
    ``TPU_DIST_PURE_PYTHON_STORE=1``; serves the native and Python clients
    of either package alike."""

    def __init__(self, port: int = 0, replicate: bool = False):
        if replicate or _armed("TPU_DIST_STORE_REPLICATE"):
            raise NotImplementedError(
                "the store's replication log (wire ops 9-10) comes with the "
                "control plane's cluster half, ROADMAP A9.2b")
        self._kv = {}
        self._mu = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stopping = False
        self._accept = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="tpu_dist_torch-store-accept")
        self._accept.start()

    def _accept_loop(self):
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._handle, args=(conn,), daemon=True,
                             name="tpu_dist_torch-store-conn").start()

    def _handle(self, conn):
        try:
            while not self._stopping:
                hdr = _recv_all(conn, 5)
                if hdr is None:
                    return
                op, klen = hdr[0], struct.unpack("<I", hdr[1:])[0]
                key = _recv_all(conn, klen) if klen else b""
                raw = _recv_all(conn, 4)
                if key is None or raw is None:
                    return
                (plen,) = struct.unpack("<I", raw)
                payload = _recv_all(conn, plen) if plen else b""
                if payload is None:
                    return
                self._dispatch(conn, op, key.decode(), payload)
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _reply(conn, status: int, data: bytes = b""):
        conn.sendall(struct.pack("<II", status, len(data)) + data)

    def _dispatch(self, conn, op, key, payload):
        if op == _OP_SET:
            with self._mu:
                self._kv[key] = payload
                self._mu.notify_all()
            self._reply(conn, 0)
        elif op == _OP_GET:
            with self._mu:
                while key not in self._kv and not self._stopping:
                    self._mu.wait(0.1)
                if self._stopping:
                    self._reply(conn, 1)
                    return
                val = self._kv[key]
            self._reply(conn, 0, val)
        elif op == _OP_ADD:
            with self._mu:
                nv = _i64(self._kv.get(key, b"")) + _i64(payload)
                self._kv[key] = struct.pack("<q", nv)
                self._mu.notify_all()
            self._reply(conn, 0, struct.pack("<q", nv))
        elif op == _OP_CHECK:
            with self._mu:
                ok = key in self._kv
            self._reply(conn, 0, b"1" if ok else b"0")
        elif op == _OP_DELETE:
            with self._mu:
                existed = self._kv.pop(key, None) is not None
            self._reply(conn, 0, b"1" if existed else b"0")
        elif op == _OP_DELETE_PREFIX:
            with self._mu:
                doomed = [k for k in self._kv if k.startswith(key)]
                for k in doomed:
                    del self._kv[k]
            self._reply(conn, 0, struct.pack("<q", len(doomed)))
        elif op == _OP_NUMKEYS:
            with self._mu:
                n = len(self._kv)
            self._reply(conn, 0, struct.pack("<I", n))
        elif op == _OP_WAIT_GE:
            target = _i64(payload)
            with self._mu:
                while (_i64(self._kv.get(key, b"")) < target
                       and not self._stopping):
                    self._mu.wait(0.1)
            self._reply(conn, 1 if self._stopping else 0)
        else:
            self._reply(conn, 2)

    def stop(self):
        self._stopping = True
        with self._mu:
            self._mu.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


# Reads (and the server-side blocking wait) are safe to replay after a lost
# connection; SET/ADD/DELETE are NOT — the server may have applied the op
# before the connection died, and a blind resend would double-apply (fatal
# for ADD-based barrier generations).  Those stay at-most-once.
# DELETE_PREFIX replays safely (re-deleting an already-swept prefix removes
# nothing more; only the returned count could differ), so it reconnects too.
_IDEMPOTENT_OPS = frozenset({_OP_GET, _OP_CHECK, _OP_NUMKEYS, _OP_WAIT_GE,
                             _OP_DELETE_PREFIX})
_RECONNECT_ATTEMPTS = 4
# Chaos fault hook (tpu_dist_torch.resilience.chaos): called as
# fn(client, op, key) at the top of every pure-Python client request; may
# close the client socket or sleep to inject deterministic connection
# faults.  None in production.
FAULT_HOOK = None
_RECONNECT_BACKOFF = 0.05  # doubles per attempt


def _connect(host: str, port: int, timeout: float):
    """Dial the store with bounded exponential backoff under an overall
    deadline: a store still coming up is a retry, one that never comes a
    named ``TimeoutError``."""
    from ..utils.backoff import BackoffDeadlineError, retry_call
    try:
        sock = retry_call(
            lambda: socket.create_connection((host, port), timeout=5),
            timeout=timeout, what=f"connect to store at {host}:{port}")
    except BackoffDeadlineError as e:
        raise TimeoutError(f"could not connect to store at {host}:{port}: "
                           f"{e.last}") from e
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)  # GET/WAIT_GE block indefinitely
    return sock


class _PyClient:
    """Pure-Python client of the wire.  A connection dropped mid-request
    (ECONNRESET, a server restart) is retried with bounded reconnect and
    backoff for the idempotent ops and surfaces as ``ConnectionError`` for
    the at-most-once ones (SET/ADD/DELETE, never replayed)."""

    def __init__(self, host: str, port: int, timeout: float):
        self._host, self._port = host, port
        self._sock = _connect(host, port, timeout)
        self._mu = threading.Lock()

    def _reconnect(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            self._sock = _connect(self._host, self._port, timeout=2.0)
        except (TimeoutError, OSError):
            pass  # the next send fails fast and consumes an attempt

    def request(self, op: int, key: str, payload: bytes = b"") -> bytes:
        if FAULT_HOOK is not None:
            FAULT_HOOK(self, op, key)  # once per logical request, not retry
        kb = key.encode()
        msg = (struct.pack("<BI", op, len(kb)) + kb
               + struct.pack("<I", len(payload)) + payload)
        with self._mu:
            attempt = 0
            while True:
                try:
                    self._sock.sendall(msg)
                    hdr = _recv_all(self._sock, 8)
                    if hdr is None:
                        raise ConnectionError("store connection closed")
                    status, dlen = struct.unpack("<II", hdr)
                    data = _recv_all(self._sock, dlen) if dlen else b""
                    if data is None:
                        raise ConnectionError("store connection closed")
                    break
                except OSError as e:  # ConnectionError/TimeoutError included
                    if op not in _IDEMPOTENT_OPS or attempt >= \
                            _RECONNECT_ATTEMPTS:
                        # a fresh socket, so that the NEXT request is not
                        # doomed by this one's dead connection (this op is
                        # not replayed: at-most-once)
                        self._reconnect()
                        raise ConnectionError(
                            f"store request op={op} failed after {attempt} "
                            f"reconnect attempt(s): {e}") from e
                    attempt += 1
                    time.sleep(_RECONNECT_BACKOFF * (2 ** (attempt - 1)))
                    self._reconnect()
        if status != 0:
            raise RuntimeError(f"store request op={op} failed (status "
                               f"{status})")
        return data

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class _NativeClient:
    """ctypes wrapper over the C++ client of ``csrc/tcpstore.cpp``."""

    def __init__(self, lib, host: str, port: int, timeout: float):
        self._lib = lib
        self._h = lib.tdt_store_client_connect(host.encode(), port,
                                               int(timeout * 1000))
        if not self._h:
            raise TimeoutError(f"could not connect to store at {host}:{port}")

    def request(self, op: int, key: str, payload: bytes = b"") -> bytes:
        lib, h, kb = self._lib, self._h, key.encode()
        if op == _OP_SET:
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload) \
                if payload else None
            if lib.tdt_store_set(h, kb, buf, len(payload)) != 0:
                raise RuntimeError("store set failed")
            return b""
        if op == _OP_GET:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = ctypes.c_int()
            if lib.tdt_store_get(h, kb, ctypes.byref(out),
                                 ctypes.byref(n)) != 0:
                raise RuntimeError("store get failed")
            data = ctypes.string_at(out, n.value) if n.value else b""
            if n.value:
                lib.tdt_store_free(out)
            return data
        if op == _OP_ADD:
            result = ctypes.c_longlong()
            if lib.tdt_store_add(h, kb, _i64(payload),
                                 ctypes.byref(result)) != 0:
                raise ConnectionError("store add failed")
            return struct.pack("<q", result.value)
        if op == _OP_CHECK:
            r = lib.tdt_store_check(h, kb)
            if r < 0:
                raise ConnectionError("store check failed")
            return b"1" if r == 1 else b"0"
        if op == _OP_DELETE:
            r = lib.tdt_store_delete(h, kb)
            if r < 0:
                raise ConnectionError("store delete failed")
            return b"1" if r == 1 else b"0"
        if op == _OP_NUMKEYS:
            r = lib.tdt_store_num_keys(h)
            if r < 0:
                raise ConnectionError("store num_keys failed")
            return struct.pack("<I", r)
        if op == _OP_WAIT_GE:
            if lib.tdt_store_wait_ge(h, kb, _i64(payload)) != 0:
                raise RuntimeError("store wait_ge failed")
            return b""
        if op == _OP_DELETE_PREFIX:
            result = ctypes.c_longlong()
            if lib.tdt_store_delete_prefix(h, kb, ctypes.byref(result)) != 0:
                raise ConnectionError("store delete_prefix failed")
            return struct.pack("<q", result.value)
        raise ValueError(f"bad op {op}")

    def close(self):
        if self._h:
            self._lib.tdt_store_client_close(self._h)
            self._h = None


def _bind(lib):
    c, vp, cp, i = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ll, u8p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "server_start": (vp, [i]), "server_port": (c, [vp]),
        "server_stop": (None, [vp]),
        "client_connect": (vp, [cp, i, i]), "client_close": (None, [vp]),
        "set": (c, [vp, cp, u8p, i]),
        "get": (c, [vp, cp, ctypes.POINTER(u8p), ctypes.POINTER(i)]),
        "add": (c, [vp, cp, ll, ctypes.POINTER(ll)]),
        "check": (c, [vp, cp]), "delete": (c, [vp, cp]),
        "num_keys": (c, [vp]), "wait_ge": (c, [vp, cp, ll]),
        "delete_prefix": (c, [vp, cp, ctypes.POINTER(ll)]),
        "free": (None, [u8p]),
    }
    for name, (res, args) in sigs.items():
        f = getattr(lib, f"tdt_store_{name}")
        f.restype, f.argtypes = res, args
    return lib


_NATIVE: dict = {}
_NATIVE_MU = threading.Lock()


def _load_native():
    """The bound native library, or None when ``TPU_DIST_PURE_PYTHON_STORE``
    is set or the library cannot be built (no g++) — then the Python
    server and client serve.  Decided once a process
    (:func:`_load_native.reset` makes the next call decide again)."""
    with _NATIVE_MU:
        if "lib" not in _NATIVE:
            lib = None
            if not os.environ.get("TPU_DIST_PURE_PYTHON_STORE"):
                try:
                    from ..ops._build import load_host_library
                    lib = _bind(load_host_library("tcpstore"))
                except Exception:
                    lib = None
            _NATIVE["lib"] = lib
        return _NATIVE["lib"]


_load_native.reset = _NATIVE.clear


# the ops the flight recorder records; CHECK and NUMKEYS are polling
# primitives (a blocked rank fires them at 10 ms cadence) and would only
# flood the ring buffer with what the pending collective span already says
_OBS_OP_NAMES = {_OP_SET: "set", _OP_GET: "get", _OP_ADD: "add",
                 _OP_DELETE: "delete", _OP_WAIT_GE: "wait_ge",
                 _OP_DELETE_PREFIX: "delete_prefix"}


class _ObservedClient:
    """Flight-recorder shim around a store client: one ``kind="store"``
    event per completed request (op name, key, payload bytes, outcome).
    Installed at :class:`TCPStore` construction only when the recorder is
    armed, so a disarmed store keeps the raw client."""

    def __init__(self, inner):
        self._inner = inner

    def request(self, op: int, key: str, payload: bytes = b"") -> bytes:
        t0 = time.monotonic_ns()
        try:
            out = self._inner.request(op, key, payload)
        except BaseException as e:
            self._rec(op, key, payload, t0, f"error:{type(e).__name__}")
            raise
        self._rec(op, key, payload, t0, "ok")
        return out

    @staticmethod
    def _rec(op, key, payload, t0, outcome):
        name = _OBS_OP_NAMES.get(op)
        if name is None:
            return
        try:  # diagnostics must never break a store op
            from ..obs.recorder import safe_record
        except Exception:
            return
        safe_record("store", name, t0=t0, key=key, bytes=len(payload),
                    outcome=outcome)

    def close(self):
        self._inner.close()


class TCPStore(Store):
    """TCP key-value store (c10d TCPStore parity).

    ``is_master=True`` also hosts the server (the native C++ one when the
    library builds, else the in-process Python one; :attr:`native` says
    which); every instance is a client.  ``port=0`` with ``is_master``
    picks a free port (see ``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 300.0):
        _refuse_later_items()
        lib = _load_native()
        self._server = None
        self._native_server = None
        if is_master:
            if lib is not None:
                self._native_server = lib.tdt_store_server_start(port)
                if not self._native_server:
                    raise OSError(f"could not bind store server on port "
                                  f"{port}")
                port = lib.tdt_store_server_port(self._native_server)
            else:
                self._server = PyTCPStoreServer(port)
                port = self._server.port
            host = "127.0.0.1" if host in ("0.0.0.0", "") else host
        self.host, self.port = host, port
        self.native = lib is not None
        self._lib = lib  # close() stops the server through the same library
        try:
            client = (_NativeClient(lib, host, port, timeout)
                      if lib is not None else _PyClient(host, port, timeout))
        except BaseException:
            self._stop_server()
            raise
        from ..obs import recorder as _obs_recorder
        if _obs_recorder.enabled():
            client = _ObservedClient(client)
        self._client = client

    # -- Store API -----------------------------------------------------------
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._client.request(_OP_SET, key, bytes(value))

    def get(self, key: str) -> bytes:
        return self._client.request(_OP_GET, key)

    def add(self, key: str, delta: int) -> int:
        out = self._client.request(_OP_ADD, key, struct.pack("<q", delta))
        return struct.unpack("<q", out)[0]

    def check(self, key: str) -> bool:
        return self._client.request(_OP_CHECK, key) == b"1"

    def delete_key(self, key: str) -> bool:
        return self._client.request(_OP_DELETE, key) == b"1"

    def delete_prefix(self, prefix: str) -> int:
        out = self._client.request(_OP_DELETE_PREFIX, prefix)
        return struct.unpack("<q", out)[0]

    def num_keys(self) -> int:
        return struct.unpack(
            "<I", self._client.request(_OP_NUMKEYS, ""))[0]

    def wait_value_ge(self, key: str, target: int,
                      timeout: Optional[float] = None) -> None:
        # a server-side blocking wait; with a timeout, polling
        if timeout is None:
            self._client.request(_OP_WAIT_GE, key, struct.pack("<q", target))
        else:
            super().wait_value_ge(key, target, timeout)

    def _stop_server(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._native_server:
            self._lib.tdt_store_server_stop(self._native_server)
            self._native_server = None

    def close(self) -> None:
        self._client.close()
        self._stop_server()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileStore(Store):
    """Shared-filesystem store — single-host testing convenience; the same
    file layout as the JAX package's, so the two read each other's keys."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "_slash_"))

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        tmp = self._file(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(bytes(value))
        os.replace(tmp, self._file(key))

    def get(self, key: str) -> bytes:
        while not os.path.exists(self._file(key)):
            time.sleep(0.01)
        with open(self._file(key), "rb") as f:
            return f.read()

    def _lock_file(self, key: str) -> str:
        # own namespace (a dot-dir): cannot collide with a key named
        # '<key>.lock', and num_keys/check never see it
        d = os.path.join(self.path, ".locks")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, os.path.basename(self._file(key)))

    def add(self, key: str, delta: int) -> int:
        # cross-process atomicity through flock on a persistent lock file:
        # the kernel releases the lock when its holder dies
        import fcntl

        fd = os.open(self._lock_file(key), os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            cur = 0
            if os.path.exists(self._file(key)):
                with open(self._file(key), "rb") as f:
                    cur = _i64(f.read())
            nv = cur + delta
            self.set(key, struct.pack("<q", nv))
            return nv
        finally:
            os.close(fd)  # releases the flock; the lock file stays

    def check(self, key: str) -> bool:
        return os.path.exists(self._file(key))

    def delete_key(self, key: str) -> bool:
        # lock files stay: unlinking one while a peer holds its flock would
        # let a third process take a fresh inode and enter concurrently
        try:
            os.unlink(self._file(key))
            return True
        except FileNotFoundError:
            return False

    def delete_prefix(self, prefix: str) -> int:
        safe = prefix.replace("/", "_slash_")
        n = 0
        for f in os.listdir(self.path):
            if f.startswith(".") or f.endswith(".tmp"):
                continue
            if f.startswith(safe):
                try:
                    os.unlink(os.path.join(self.path, f))
                    n += 1
                except FileNotFoundError:
                    pass
        return n

    def num_keys(self) -> int:
        return len([f for f in os.listdir(self.path)
                    if not f.startswith(".") and not f.endswith(".tmp")])
