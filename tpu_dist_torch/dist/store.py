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
event.

**The cluster half** (:mod:`tpu_dist_torch.cluster`): a Python server with
``replicate=True`` (or ``TPU_DIST_STORE_REPLICATE=1``) keeps a bounded
mutation log that follower replicas tail through wire ops 9-10
(``_OP_SNAPSHOT``, ``_OP_LOG_SINCE``, byte for byte the JAX package's
replies); a Python client under ``TPU_DIST_STORE_ENDPOINTS`` re-resolves
the leader from the endpoints file on every reconnect, so a leader
failover re-arms its blocked waiters on the promoted follower and turns an
at-most-once op caught across it into :class:`StoreFailoverError`.  Either
variable takes the Python wire on both sides: the native library has no
ops 9-10, and a process split across the two would split the brain.  The
Python client is also the ``store`` surface of the network chaos layer
(``TPU_DIST_NETCHAOS``, :mod:`tpu_dist_torch.resilience.netchaos`).
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import socket
import struct
import threading
import time
from typing import List, Optional

__all__ = ["Store", "TCPStore", "FileStore", "PyTCPStoreServer",
           "StoreFailoverError"]

# Wire protocol op codes (must match csrc/tcpstore.cpp)
(_OP_SET, _OP_GET, _OP_ADD, _OP_CHECK, _OP_DELETE, _OP_NUMKEYS, _OP_WAIT_GE,
 _OP_DELETE_PREFIX) = range(1, 9)
# replication ops: Python servers only (csrc/tcpstore.cpp has neither, so a
# cluster-armed process takes the Python wire: TCPStore.__init__)
(_OP_SNAPSHOT, _OP_LOG_SINCE) = (9, 10)


def _replicate_env() -> bool:
    return os.environ.get("TPU_DIST_STORE_REPLICATE", "") not in ("", "0")


class StoreFailoverError(ConnectionError):
    """An at-most-once store op (SET/ADD/DELETE) was in flight while the
    control-plane leader changed.  It is NOT replayed against the new
    leader: the old one may have applied it before dying, and a blind
    resend would double-apply (fatal for ADD-based barrier generations).
    Names both leaders and the new epoch, so the caller can decide whether
    its op is safe to re-issue (an idempotent re-publish: yes; a counter
    bump: read first)."""

    def __init__(self, msg: str, old: Optional[str] = None,
                 new: Optional[str] = None, epoch: Optional[int] = None):
        super().__init__(msg)
        self.old_leader = old
        self.new_leader = new
        self.epoch = epoch


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
    """The pure-Python server of the wire, one thread a connection.  Taken
    when the native library cannot be built, ``TPU_DIST_PURE_PYTHON_STORE=1``
    or the cluster layer is armed; serves the native and Python clients of
    either package alike.

    With ``replicate=True`` (or ``TPU_DIST_STORE_REPLICATE=1``) it also
    keeps a bounded in-memory mutation log that follower replicas
    (:class:`tpu_dist_torch.cluster.StoreFollower`) tail through
    ``_OP_SNAPSHOT``/``_OP_LOG_SINCE``:

    - every applied mutation gets the next sequence number; only
      SET/DELETE/DELETE_PREFIX are logged, ADD as a SET of its *result*,
      so replaying the log is idempotent (a replayed ADD would double
      count);
    - the log is bounded by entries (``TPU_DIST_STORE_LOG_MAX``, 65536) and
      bytes (``TPU_DIST_STORE_LOG_BYTES``, 64 MiB); a follower asking for a
      sequence older than the retained base is told to re-snapshot;
    - :meth:`install_snapshot` and :meth:`apply_mutation`, the follower's
      entry points, apply under the same condition variable and notify
      it, so a GET/WAIT_GE blocked on a *promoted* follower wakes as on
      the original leader: the waiter re-arm guarantee."""

    def __init__(self, port: int = 0, replicate: bool = False):
        self._kv = {}
        self._mu = threading.Condition()
        self._replicate = bool(replicate) or _replicate_env()
        self._seq = 0  # newest applied mutation's sequence number
        self._log = collections.deque()  # (seq, op, key, payload)
        self._log_bytes = 0
        self._log_max = int(os.environ.get("TPU_DIST_STORE_LOG_MAX",
                                           "65536"))
        self._log_max_bytes = int(os.environ.get("TPU_DIST_STORE_LOG_BYTES",
                                                 str(64 << 20)))
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

    # -- the replication log (the helpers run under self._mu) ---------------

    def _log_base(self) -> int:
        return self._log[0][0] if self._log else self._seq + 1

    def _log_append(self, seq: int, op: int, key: str,
                    payload: bytes) -> None:
        self._seq = seq
        if not self._replicate:
            return
        self._log.append((seq, op, key, payload))
        self._log_bytes += len(key) + len(payload) + 16
        while self._log and (len(self._log) > self._log_max
                             or self._log_bytes > self._log_max_bytes):
            old = self._log.popleft()
            self._log_bytes -= len(old[2]) + len(old[3]) + 16

    def _log_mut(self, op: int, key: str, payload: bytes) -> None:
        self._log_append(self._seq + 1, op, key, payload)

    # -- the follower's side (tpu_dist_torch/cluster/replica.py) ------------

    def replication_seq(self) -> int:
        with self._mu:
            return self._seq

    def snapshot_items(self, prefix: str = "") -> dict:
        """Copy of the kv map (keys starting with ``prefix``): the election
        reads the lease and candidate tables from its local replica through
        this, never over the (dead) wire."""
        with self._mu:
            return {k: v for k, v in self._kv.items()
                    if k.startswith(prefix)}

    def install_snapshot(self, seq: int, items) -> None:
        with self._mu:
            self._kv = dict(items)
            self._log.clear()
            self._log_bytes = 0
            self._seq = seq
            self._mu.notify_all()

    def apply_mutation(self, seq: int, op: int, key: str,
                       payload: bytes) -> None:
        with self._mu:
            if seq <= self._seq:
                return  # a duplicate tail poll: already applied
            if op == _OP_SET:
                self._kv[key] = payload
            elif op == _OP_DELETE:
                self._kv.pop(key, None)
            elif op == _OP_DELETE_PREFIX:
                for k in [k for k in self._kv if k.startswith(key)]:
                    del self._kv[k]
            else:
                raise ValueError(f"bad replicated op {op}")
            # the follower keeps its own log under the LEADER's sequence
            # numbers: after a promotion new mutations continue the same
            # sequence, and a later follower can tail this server in turn
            self._log_append(seq, op, key, payload)
            self._mu.notify_all()

    def _dispatch(self, conn, op, key, payload):
        if op == _OP_SET:
            with self._mu:
                self._kv[key] = payload
                self._log_mut(_OP_SET, key, payload)
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
                # logged as a SET of the RESULT: replay stays idempotent
                self._log_mut(_OP_SET, key, self._kv[key])
                self._mu.notify_all()
            self._reply(conn, 0, struct.pack("<q", nv))
        elif op == _OP_CHECK:
            with self._mu:
                ok = key in self._kv
            self._reply(conn, 0, b"1" if ok else b"0")
        elif op == _OP_DELETE:
            with self._mu:
                existed = self._kv.pop(key, None) is not None
                self._log_mut(_OP_DELETE, key, b"")
            self._reply(conn, 0, b"1" if existed else b"0")
        elif op == _OP_DELETE_PREFIX:
            with self._mu:
                doomed = [k for k in self._kv if k.startswith(key)]
                for k in doomed:
                    del self._kv[k]
                self._log_mut(_OP_DELETE_PREFIX, key, b"")
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
        elif op == _OP_SNAPSHOT:
            # an atomic kv image: <q seq> <I count>, then per entry
            # <I klen> key <I vlen> value
            with self._mu:
                parts = [struct.pack("<qI", self._seq, len(self._kv))]
                for k, v in self._kv.items():
                    kb = k.encode()
                    parts.append(struct.pack("<I", len(kb)) + kb
                                 + struct.pack("<I", len(v)) + v)
            self._reply(conn, 0, b"".join(parts))
        elif op == _OP_LOG_SINCE:
            # payload <q since> (the follower's applied seq).  Reply <B
            # flag>: 1 = the log was truncated past `since` (re-snapshot);
            # 0, then <q leader_seq> <I count> and per entry <q seq> <B op>
            # <I klen> key <I plen> payload
            since = _i64(payload)
            with self._mu:
                if since + 1 < self._log_base():
                    body = struct.pack("<B", 1)
                else:
                    ents = [e for e in self._log if e[0] > since]
                    parts = [struct.pack("<BqI", 0, self._seq, len(ents))]
                    for s, eop, ekey, epay in ents:
                        kb = ekey.encode()
                        parts.append(struct.pack("<qBI", s, eop, len(kb))
                                     + kb + struct.pack("<I", len(epay))
                                     + epay)
                    body = b"".join(parts)
            self._reply(conn, 0, body)
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


def _net_active():
    """The active network-fault injector, or None.  Guarded by
    ``sys.modules`` and the env var, so a process that never arms the
    network chaos layer never imports it: one global read a request.  A
    copy of the transport's probe (``collectives.transport._net_chaos``)
    rather than an import of it, so that a bare store client does not pull
    numpy in; keep the two in step."""
    import sys
    if "tpu_dist_torch.resilience.netchaos" not in sys.modules \
            and not os.environ.get("TPU_DIST_NETCHAOS"):
        return None
    from ..resilience import netchaos
    return netchaos.install_from_env()


def _net_store_fault(client, op: int, key: str, payload: bytes) -> bytes:
    """The ``store`` surface of the network chaos layer, consulted once a
    request (Python client only, like :data:`FAULT_HOOK`).  May sleep
    (``delay``, ``slow-drip``), close the socket (``conn-reset``,
    ``truncate``: the reconnect and at-most-once rules own the recovery),
    raise a named ``ConnectionError`` (``partition``: the server is
    unreachable) or return a bit-flipped payload (``corrupt``: the
    consumer's sealed-payload checksum catches it)."""
    nc = _net_active()
    if nc is None:
        return payload
    f = nc.plan("store")
    if f is None:
        return payload
    if f.kind in ("partition", "conn-reset", "truncate"):
        try:
            client._sock.close()
        except OSError:
            pass
    if f.kind == "partition":
        raise ConnectionError(
            f"netchaos: injected store partition — control-plane server "
            f"unreachable (op={op} key={key!r})")
    if f.kind == "delay":
        time.sleep(f.delay)
    elif f.kind == "slow-drip":
        time.sleep(len(payload) / max(1.0, f.rate))
    elif f.kind == "corrupt" and payload:
        return bytes(nc.corrupt_parts(f, (payload,))[0])
    return payload


def _read_endpoints(path: str):
    """Parse a cluster endpoints file into ``(host, port, epoch)``, or None.
    The file (written atomically by tpu_dist_torch/cluster/endpoints.py)
    names the store's current leader; a missing or torn file reads as
    None and the client keeps its address until the next attempt."""
    try:
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        host, _, port = str(d.get("leader") or "").rpartition(":")
        if not host:
            return None
        return host, int(port), int(d.get("epoch", 0))
    except (OSError, ValueError, TypeError, AttributeError):
        return None


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
    (ECONNRESET, a server restart, an injected fault) is retried with
    bounded reconnect and backoff for the idempotent ops and surfaces as
    ``ConnectionError`` for the at-most-once ones (SET/ADD/DELETE, never
    replayed).

    Under ``TPU_DIST_STORE_ENDPOINTS`` (and ``follow_endpoints`` left on)
    every reconnect first re-resolves the leader from the endpoints file,
    so the same bounded machinery that rides out a server restart rides
    out a leader *failover*: blocked GET/WAIT_GE re-arm on the promoted
    follower, and a failed at-most-once op that crossed a leader change
    raises :class:`StoreFailoverError` (still never replayed).  The
    reconnect budget (``TPU_DIST_STORE_RECONNECT_ATTEMPTS``) is then 8 by
    default, to cover an election."""

    def __init__(self, host: str, port: int, timeout: float,
                 follow_endpoints: bool = True):
        self._endpoints = (os.environ.get("TPU_DIST_STORE_ENDPOINTS") or None
                           if follow_endpoints else None)
        self._epoch = -1
        if self._endpoints:
            ep = _read_endpoints(self._endpoints)
            if ep is not None:
                host, port, self._epoch = ep
        env_attempts = os.environ.get("TPU_DIST_STORE_RECONNECT_ATTEMPTS")
        self._attempts = (int(env_attempts) if env_attempts
                          else 8 if self._endpoints else _RECONNECT_ATTEMPTS)
        self._host, self._port = host, port
        self._sock = _connect(host, port, timeout)
        self._mu = threading.Lock()

    def _refresh_endpoints(self) -> bool:
        """Re-resolve the leader from the endpoints file (if there is one);
        True when the address changed: a failover happened."""
        if not self._endpoints:
            return False
        ep = _read_endpoints(self._endpoints)
        if ep is None:
            return False
        host, port, epoch = ep
        if (host, port) == (self._host, self._port):
            self._epoch = max(self._epoch, epoch)
            return False
        old, new = f"{self._host}:{self._port}", f"{host}:{port}"
        self._host, self._port, self._epoch = host, port, epoch
        try:  # diagnostics must never break a store op
            from ..utils.logging import log_event
            log_event("store-failover", old=old, new=new, epoch=epoch)
            from ..obs.recorder import safe_record
            safe_record("store", "failover", key=new, old=old, epoch=epoch)
        except Exception:
            pass
        return True

    def _reconnect(self) -> None:
        """A fresh socket to the (re-resolved) leader."""
        self._refresh_endpoints()
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
        payload = _net_store_fault(self, op, key, payload)
        kb = key.encode()
        msg = (struct.pack("<BI", op, len(kb)) + kb
               + struct.pack("<I", len(payload)) + payload)
        with self._mu:
            attempt = 0
            epoch0 = self._epoch  # the leader's epoch when this op started
            old_addr = f"{self._host}:{self._port}"
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
                    if (status == 1 and self._endpoints
                            and op in (_OP_GET, _OP_WAIT_GE)):
                        # "server stopping" on a blocked op: under an
                        # endpoints file that is a leader going away, not
                        # an answer — retry, so the waiter re-arms on the
                        # promoted follower
                        raise ConnectionError(
                            "store stopping while blocked (leader "
                            "shutdown) — re-arming")
                    break
                except OSError as e:  # ConnectionError/TimeoutError included
                    if op not in _IDEMPOTENT_OPS or attempt >= \
                            self._attempts:
                        # a fresh socket (re-resolving the leader), so that
                        # the NEXT request is not doomed by this one's dead
                        # connection; this op is not replayed
                        self._reconnect()
                        if self._epoch != epoch0:
                            new = f"{self._host}:{self._port}"
                            raise StoreFailoverError(
                                f"store request op={op} was in flight "
                                f"across a leader failover ({old_addr} -> "
                                f"{new}, epoch {self._epoch}) and is not "
                                f"replayed: {e}", old=old_addr, new=new,
                                epoch=self._epoch) from e
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
        lib = _load_native()
        if os.environ.get("TPU_DIST_STORE_ENDPOINTS") or _replicate_env():
            # the failover re-resolution and the replication log live in
            # the Python wire only: a cluster-armed process must not split
            # its brain across the two
            lib = None
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
            # a hosting instance IS the leader: it never chases the
            # endpoints file away from its own server
            client = (_NativeClient(lib, host, port, timeout)
                      if lib is not None
                      else _PyClient(host, port, timeout,
                                     follow_endpoints=not is_master))
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
