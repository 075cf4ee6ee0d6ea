"""Socket frontend for the serving engine — counterpart of the engine-side
half of ``tpu_dist/serve/frontend.py``, byte-compatible with it.

Wire format (protocol v2): a fixed hello (magic ``TPSV`` + u16 version),
then checksummed length-prefixed JSON frames (``u32 length || u32 crc ||
utf-8 JSON``), sent with one vectored send and read with bounded reads — no
pickle; EOF at a frame boundary is a clean close, EOF mid-frame a named
``ConnectionError``, a payload that fails its checksum a named
:class:`~tpu_dist_torch.serve._wire.FrameCorruptError`.

Frames client → server::

    {"type": "submit", "id": <int>, "prompt": [ints],
     "max_new_tokens": N, "temperature": 0.0, "eos_id": null, "seed": 0,
     "deadline_ms": <float, optional>}
    {"type": "cancel", "id": <int>}
    {"type": "stats", "id": <int>}

Frames server → client (streamed per request, interleaved across requests
as the engine emits them)::

    {"type": "token", "id": <int>, "t": <int>}
    {"type": "done",  "id": <int>, "reason": "eos"|"length", "n": <int>}
    {"type": "error", "id": <int>, "error": "<ExceptionName>",
     "detail": "..."}
    {"type": "stats", "id": <int>, "stats": {...}}

The JAX package's ``ServeClient`` drives a :class:`Frontend` of the port
and the port's client drives the JAX package's.

Two roles live here, as in the JAX package:

- :class:`Frontend` — the engine-side listener, in the model rank's process
  beside the :class:`~tpu_dist_torch.serve.scheduler.Scheduler`.  Given a
  control-plane store it registers its address in the backend registry
  (:func:`register_backend`; the default name also under
  ``tpu_dist/serve/backend``), so the gateway finds it across restarts.
- :class:`Gateway` — the client-facing role that ``python -m
  tpu_dist_torch.launch --serve`` spawns beside the model ranks: one stable
  port in front of the registry's backends, least-outstanding routing,
  and, when a backend dies, a named ``BackendGoneError`` for each request
  it had in flight that no other live backend can take; the next submit
  reaches the restarted backend, on the client's same connection.

The keys and the registry's layout are the JAX package's, so either
package's gateway fronts either package's frontends.  Every outgoing frame
is the ``serve`` surface of the network chaos layer (``TPU_DIST_NETCHAOS``,
:mod:`tpu_dist_torch.resilience.netchaos`).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.backoff import BackoffDeadlineError, retry_call
from ._wire import (_JOIN_TIMEOUT, FrameCorruptError, _recv_exact, _sendv,
                    _shutdown, _tune_socket, frame_checksum)
from .scheduler import Scheduler

__all__ = ["Frontend", "Gateway", "BackendGoneError", "BACKEND_KEY",
           "GATEWAY_KEY", "BACKENDS_SEQ_KEY", "BACKENDS_REG_PREFIX",
           "ROLE_FRONTEND", "ROLE_MODEL_SHARD", "register_backend", "list_backends", "store_from_env",
           "connect_hello", "read_frame", "send_frame"]

_MAGIC = b"TPSV"
_HELLO = struct.Struct("<4sH")   # magic, protocol version
# v2: every frame carries a payload checksum (u32 length || u32 crc ||
# json) — a flipped bit on the request wire fails the connection with a
# named FrameCorruptError instead of decoding to silently wrong tokens
_VERSION = 2
_U32 = struct.Struct("<I")
_MAX_FRAME = 64 << 20

# cross-generation service-discovery keys (like tpu_dist/master_port):
# written by whichever incarnation owns the role, read by the other side on
# (re)connect — outside the g{gen} namespace, so a restarted backend's fresh
# address survives the launcher's generation reaper
BACKEND_KEY = "tpu_dist/serve/backend"
GATEWAY_KEY = "tpu_dist/serve/gateway"

# the backend REGISTRY: every backend appends an entry under an atomic
# sequence counter; the gateway folds the entries latest-wins per NAME, so a
# restarted incarnation's fresh address replaces its predecessor's and
# several backends coexist behind one port.  Entries are append-only (no
# read-modify-write races); stale ones are pruned by dial failure.
BACKENDS_SEQ_KEY = "tpu_dist/serve/backends/seq"
BACKENDS_REG_PREFIX = "tpu_dist/serve/backends/reg"

# the role names of the multi-rank serving split under a role graph: a
# tensor-parallel group's ranks are ``model-shard[r]`` in the role map, the
# obs dumps and the launcher's positions table (the JAX package's names)
ROLE_FRONTEND = "frontend"
ROLE_MODEL_SHARD = "model-shard"


def register_backend(store, name: str, addr: str) -> None:
    """Register (or re-register) backend ``name`` at ``addr``; the latest
    entry per name wins, which is the supervised-restart story."""
    i = store.add(BACKENDS_SEQ_KEY, 1)
    store.set(f"{BACKENDS_REG_PREFIX}/{i}",
              json.dumps({"name": str(name), "addr": str(addr)}).encode())


def list_backends(store) -> Dict[str, str]:
    """The registry folded latest-wins: ``{backend_name: addr}``.  The
    single-backend key (``tpu_dist/serve/backend``) appears as
    ``"default"`` when no registry entry superseded it."""
    out: Dict[str, str] = {}
    try:
        if store.check(BACKEND_KEY):
            out["default"] = store.get(BACKEND_KEY).decode()
    except Exception:
        pass
    try:
        n = int(store.add(BACKENDS_SEQ_KEY, 0))
    except Exception:
        return out
    for i in range(1, n + 1):
        key = f"{BACKENDS_REG_PREFIX}/{i}"
        try:
            if not store.check(key):
                continue
            e = json.loads(store.get(key).decode())
            out[str(e["name"])] = str(e["addr"])
        except Exception:
            continue
    return out


def _net_serve_fault(sock, payload: bytes) -> Optional[bytes]:
    """The ``serve`` surface of the network chaos layer
    (:mod:`tpu_dist_torch.resilience.netchaos`), consulted once an outgoing
    frame.  May sleep (``delay``), pace (``slow-drip``), return a
    bit-flipped payload (``corrupt``: the receiver's frame checksum catches
    it), break the socket mid-frame (``conn-reset``/``truncate``) or
    blackhole the frame (``partition``: the caller's bounded waits own the
    rest).  Returns the payload to send, or None for a blackholed frame.
    Called under the connection's send lock (:func:`send_frame`), so the
    raw truncate/reset writes never interleave with another writer's
    frame."""
    from ..collectives.transport import _net_chaos
    nc = _net_chaos()  # the shared sys.modules- and env-guarded probe
    if nc is None:
        return payload
    f = nc.plan("serve")
    if f is None:
        return payload
    if f.kind == "partition":
        return None
    if f.kind == "delay":
        time.sleep(f.delay)
    elif f.kind == "slow-drip":
        time.sleep(len(payload) / max(1.0, f.rate))
    elif f.kind == "corrupt":
        return bytes(nc.corrupt_parts(f, (payload,))[0])
    elif f.kind in ("conn-reset", "truncate"):
        try:
            if f.kind == "truncate":
                sock.sendall(_U32.pack(len(payload) + 1000))  # lies, then
                sock.shutdown(socket.SHUT_WR)                 # FIN
            sock.close()
        except OSError:
            pass
        raise ConnectionResetError(
            f"netchaos: injected serve-wire {f.kind}")
    return payload


def send_frame(sock, obj: dict, lock: Optional[threading.Lock] = None) -> None:
    """One checksummed length-prefixed JSON frame, vectored send (header +
    payload in one syscall).  ``lock`` serializes concurrent writers on a
    shared connection (token frames for different requests interleave);
    the fault injection runs under it too."""
    payload = json.dumps(obj).encode()
    # the checksum BEFORE the fault injection: netchaos `corrupt` flips
    # bits on the wire, which is what the receiver must catch
    header = _U32.pack(len(payload)) + _U32.pack(frame_checksum((payload,)))
    if lock is None:
        _send_frame_faulted(sock, header, payload)
    else:
        with lock:
            _send_frame_faulted(sock, header, payload)


def _send_frame_faulted(sock, header: bytes, payload: bytes) -> None:
    faulted = _net_serve_fault(sock, payload)
    if faulted is None:
        return  # netchaos partition: the frame never leaves
    _sendv(sock, header, faulted)


def read_frame(sock) -> Optional[dict]:
    """Next frame, or None on EOF at a frame boundary (clean close).
    Raises ``ConnectionError`` on a truncated frame or an oversized length
    prefix, and :class:`FrameCorruptError` when the payload fails its
    checksum."""
    raw = _recv_exact(sock, _U32.size)
    if raw is None:
        return None
    (n,) = _U32.unpack(bytes(raw))
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds the "
                              f"{_MAX_FRAME}-byte bound")
    (crc,) = _U32.unpack(bytes(_recv_exact_or_close(sock, _U32.size)))
    body = _recv_exact(sock, n)
    if body is None:
        raise ConnectionError("connection closed mid-frame")
    got = frame_checksum((body,))
    if got != crc:
        raise FrameCorruptError(None, "serve-frame", n, crc, got, 0)
    return json.loads(bytes(body).decode())


def _recv_exact_or_close(sock, n: int):
    raw = _recv_exact(sock, n)
    if raw is None:
        raise ConnectionError("connection closed mid-frame")
    return raw


def connect_hello(host: str, port: int, timeout: float = 10.0):
    """Open a serve-protocol connection: TCP connect + hello exchange.
    Returns the connected socket; raises ``ConnectionError`` on a
    version/magic mismatch (a non-serve listener on that port)."""
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    _tune_socket(sock)
    sock.settimeout(timeout)
    sock.sendall(_HELLO.pack(_MAGIC, _VERSION))
    raw = _recv_exact(sock, _HELLO.size)
    if raw is None:
        sock.close()
        raise ConnectionError("peer closed during serve hello")
    magic, ver = _HELLO.unpack(bytes(raw))
    if magic != _MAGIC or ver != _VERSION:
        sock.close()
        raise ConnectionError(f"not a tpu_dist.serve peer "
                              f"(magic={magic!r} version={ver})")
    sock.settimeout(None)
    return sock


class _Listener:
    """Accept-loop scaffolding shared by both roles: one thread per
    connection, all of them tracked so :meth:`close` can end them."""

    def __init__(self, host: str, port: int, name: str, backlog: int = 64):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(backlog)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._closing = False
        self._mu = threading.Lock()
        self._conns: Dict[socket.socket, threading.Thread] = {}
        self._name = name
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name=name)

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        """Stop accepting, end every open connection and join the threads.
        Where the JAX package only closes the listening socket, this shuts
        the sockets down first: on Linux a ``close`` does not wake a thread
        blocked in ``accept`` or ``recv`` on the same socket, and that
        thread would keep the role (and what it holds) alive."""
        with self._mu:
            self._closing = True
            conns = dict(self._conns)
        for sock in [self._sock, *conns]:
            _shutdown(sock)
        for t in [self._acceptor, *conns.values()]:
            if t.is_alive() and t is not threading.current_thread():
                t.join(_JOIN_TIMEOUT)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            _tune_socket(conn)
            t = threading.Thread(target=self._run_conn, args=(conn,),
                                 daemon=True, name=self._name + "-conn")
            with self._mu:
                if self._closing:
                    conn.close()
                    return
                self._conns[conn] = t
            t.start()

    def _run_conn(self, conn) -> None:
        try:
            self._serve_conn(conn)
        finally:
            with self._mu:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn(self, conn) -> None:  # pragma: no cover - overridden
        pass

    @staticmethod
    def _hello(conn, timeout: float = 10.0) -> bool:
        """Server side of the hello exchange; False on a non-serve peer."""
        conn.settimeout(timeout)
        try:
            raw = _recv_exact(conn, _HELLO.size)
            if raw is None:
                return False
            magic, ver = _HELLO.unpack(bytes(raw))
            if magic != _MAGIC or ver != _VERSION:
                return False
            conn.sendall(_HELLO.pack(_MAGIC, _VERSION))
        except (OSError, ConnectionError):
            return False
        conn.settimeout(None)
        return True


class Frontend(_Listener):
    """Engine-side frame server: accepts serve-protocol connections (one
    thread each) and feeds the scheduler; per-request tokens stream back as
    they are emitted.  A client that disconnects (or sends a ``cancel``
    frame) mid-decode has its in-flight requests cancelled: the engine
    frees their slots at the next iteration boundary.

    ``store`` (a control-plane store, or None): the frontend registers its
    address there under ``backend_name`` (:func:`register_backend`), and
    the default name also under :data:`BACKEND_KEY`, so a gateway resolves
    it — a restarted incarnation re-registers the same name.
    ``backend_name`` is also this backend's name in ``stats`` frames."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, store=None, backend_name: str = "default"):
        super().__init__(host, port, "tpu_dist_torch-serve-frontend")
        self.scheduler = scheduler
        self._store = store
        self.backend_name = str(backend_name)
        if store is not None:
            try:
                if self.backend_name == "default":
                    store.set(BACKEND_KEY, self.addr.encode())
                register_backend(store, self.backend_name, self.addr)
            except BaseException:
                self.close()
                raise
        self._acceptor.start()

    def _stats(self) -> dict:
        eng = self.scheduler.engine
        return dict(eng.stats(), scheduler=self.scheduler.snapshot(),
                    free_slots=eng.free_slots(), backend=self.backend_name)

    def _serve_conn(self, conn) -> None:
        if not self._hello(conn):
            return
        send_mu = threading.Lock()
        alive = [True]
        handles: Dict[object, object] = {}  # rid -> RequestHandle

        def _send(obj: dict) -> None:
            if not alive[0]:
                return
            try:
                send_frame(conn, obj, lock=send_mu)
            except (OSError, ConnectionError):
                alive[0] = False   # client gone: stop pushing its frames

        def _callbacks(rid):
            def on_token(req, t):
                _send({"type": "token", "id": rid, "t": t})

            def on_done(req, reason):
                handles.pop(rid, None)
                _send({"type": "done", "id": rid, "reason": reason,
                       "n": req.emitted})

            def on_error(req, exc):
                handles.pop(rid, None)
                _send({"type": "error", "id": rid,
                       "error": type(exc).__name__, "detail": str(exc)})

            return on_token, on_done, on_error

        try:
            while not self._closing:
                frame = read_frame(conn)
                if frame is None:
                    break
                kind = frame.get("type")
                if kind == "cancel":
                    # the slot frees at the next iteration boundary; the
                    # handle terminates with a RequestCancelledError frame
                    h = handles.get(frame.get("id"))
                    if h is not None:
                        h.cancel()
                    continue
                if kind == "stats":
                    _send({"type": "stats", "id": frame.get("id"),
                           "stats": self._stats()})
                    continue
                if kind != "submit":
                    _send({"type": "error", "id": frame.get("id"),
                           "error": "ProtocolError",
                           "detail": f"unknown frame type {kind!r}"})
                    continue
                rid = frame.get("id")
                on_token, on_done, on_error = _callbacks(rid)
                try:
                    dl = frame.get("deadline_ms")
                    handles[rid] = self.scheduler.submit(
                        frame["prompt"],
                        max_new_tokens=int(frame.get("max_new_tokens", 16)),
                        temperature=float(frame.get("temperature", 0.0)),
                        eos_id=frame.get("eos_id"),
                        seed=int(frame.get("seed", 0)),
                        deadline_ms=None if dl is None else float(dl),
                        req_id=rid, on_token=on_token, on_done=on_done,
                        on_error=on_error)
                    if handles[rid].done:
                        # terminal callback raced the assignment: its pop
                        # was a no-op, so reap here instead of leaking
                        handles.pop(rid, None)
                except Exception as e:
                    _send({"type": "error", "id": rid,
                           "error": type(e).__name__, "detail": str(e)})
        except (OSError, ConnectionError):
            pass
        finally:
            alive[0] = False
            # client gone: cancel everything it still had in flight — the
            # engine frees the slots at the next iteration boundary
            # instead of decoding to max_new_tokens into a dead socket
            for h in list(handles.values()):
                try:
                    h.cancel()
                except Exception:
                    pass


class BackendGoneError(ConnectionError):
    """A gateway backend link died with requests in flight that no other
    backend could take; each such request was failed with an error frame
    naming this class."""


def _store_routed_host(store) -> str:
    """The local interface that routes toward the control-plane store —
    the address a process on another host reaches this one on (a UDP
    ``connect`` resolves the route without sending anything); loopback
    when the store is local or absent.  The port's copy of the JAX
    package's ``collectives.transport.store_routed_host``."""
    target = getattr(store, "host", None)
    if not target or target in ("127.0.0.1", "localhost", "0.0.0.0", ""):
        return "127.0.0.1"
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect((target, int(getattr(store, "port", 1))))
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        return "127.0.0.1"


class _Forward:
    """One client request's routing record while in flight on a backend
    link: the session and client-side id, the ORIGINAL submit frame (a
    failover replays it verbatim: decode is deterministic), how many tokens
    the client already has (the replay suppresses that prefix), and the
    retry budget."""

    __slots__ = ("sess", "cid", "frame", "delivered", "skip", "retries",
                 "cancelled", "stats_ev", "stats_out")

    def __init__(self, sess, cid, frame):
        self.sess = sess
        self.cid = cid
        self.frame = frame
        self.delivered = 0   # tokens forwarded to the client so far
        self.skip = 0        # replayed tokens to suppress after failover
        self.retries = 0
        self.cancelled = False  # the client sent a cancel: never replay
        self.stats_ev = None   # set on stats probes instead of a session
        self.stats_out = None


class _BackendLink:
    """One live connection to a backend, SHARED by every client session: a
    send lock, a pump thread forwarding frames to their sessions, and the
    in-flight table that routing and the no-silent-drop sweep key on."""

    def __init__(self, gw: "Gateway", name: str, addr: str):
        host, _, port = addr.rpartition(":")
        self.sock = connect_hello(host, int(port), timeout=5.0)
        self.gw = gw
        self.name = name
        self.addr = addr
        self.send_mu = threading.Lock()
        self.inflight: Dict[int, _Forward] = {}   # gateway rid -> record
        self.dead = False
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True,
            name=f"tpu_dist_torch-serve-gw-pump-{name}")
        self._pump_thread.start()

    def send(self, frame: dict) -> None:
        send_frame(self.sock, frame, lock=self.send_mu)

    def _pump(self) -> None:
        detail = "backend closed the connection"
        try:
            while True:
                frame = read_frame(self.sock)
                if frame is None:
                    break
                self._dispatch(frame)
        except (OSError, ConnectionError) as e:
            detail = repr(e)
        self.gw._link_died(self, detail)

    def _dispatch(self, frame: dict) -> None:
        kind = frame.get("type")
        rid = frame.get("id")
        with self.gw._mu:
            fwd = self.inflight.get(rid)
            if fwd is None:
                return  # a response for a request no longer tracked
            if kind == "token" and fwd.skip > 0:
                fwd.skip -= 1       # failover replay: already delivered
                return
            if kind == "token":
                fwd.delivered += 1
            elif kind in ("done", "error", "stats"):
                del self.inflight[rid]
        if fwd.stats_ev is not None:
            fwd.stats_out = frame.get("stats")
            fwd.stats_ev.set()
            return
        if kind in ("done", "error"):
            fwd.sess._unroute(fwd.cid)
        fwd.sess._to_client(dict(frame, id=fwd.cid))

    def close(self) -> None:
        self.dead = True
        _shutdown(self.sock)
        if self._pump_thread is not threading.current_thread():
            self._pump_thread.join(_JOIN_TIMEOUT)


class Gateway(_Listener):
    """Client-facing role of the ``--serve`` split: ONE stable public port
    in front of a backend registry — the backends registered by name in the
    control-plane store (:func:`register_backend`), or one explicit
    ``backend`` address.

    Routing is least-outstanding-request: each submit goes to the live
    backend link with the fewest requests in flight (client request ids
    are remapped onto a gateway-wide id space, so many sessions share a
    link).  A submit that reaches no backend within ``backend_timeout``
    fails with a named ``BackendUnavailableError`` frame.

    Failover: when a link dies, each of its in-flight requests is
    resubmitted ONCE to another already-live backend (the original frame
    replayed, the tokens the client already has suppressed by count).  Only
    when no other live backend exists does the request fail with a
    ``BackendGoneError`` frame; either way nothing is dropped silently, and
    the next submit re-reads the registry, which a supervised restart
    fills again."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0, store=None,
                 backend: Optional[str] = None,
                 backend_timeout: float = 60.0):
        super().__init__(host, port, "tpu_dist_torch-serve-gateway")
        self._store = store
        self._backend = backend
        self.backend_timeout = float(backend_timeout)
        self._links: Dict[str, _BackendLink] = {}   # under self._mu
        self._grid = iter(range(1, 1 << 62))  # gateway-wide request ids
        self._last_refresh = 0.0             # registry re-read throttle
        self._dial_mu = threading.Lock()     # ONE refresher at a time: two
        # would both miss a name, both dial, and the loser's replacement
        # would close a healthy link that already carries requests
        self._reg_idx = 0                    # registry entries folded so
        self._reg_cache: Dict[str, str] = {}  # far (re-reads are
        # incremental: the append-only registry grows every restart)
        self._reg_holes: Dict[int, float] = {}  # idx -> first seen empty
        if store is not None:
            try:
                store.set(GATEWAY_KEY,
                          f"{self._public_host()}:{self.port}".encode())
            except BaseException:
                self.close()
                raise
        self._acceptor.start()

    def _public_host(self) -> str:
        """The address to PUBLISH: a 0.0.0.0 bind is not routable, so
        advertise the interface that routes toward the store server."""
        if self.host != "0.0.0.0":
            return self.host
        return _store_routed_host(self._store)

    # -- registry + links ----------------------------------------------------

    def _known_backends(self) -> Dict[str, str]:
        """name -> addr from the ``backend=`` pin or the store's registry
        (and the single-backend key), re-read on every resolution so a
        restarted backend's fresh address is found.  Only entries past
        ``_reg_idx`` are read."""
        if self._backend:
            return {"default": self._backend}
        if self._store is None:
            raise ConnectionError("gateway has neither --backend nor a "
                                  "control-plane store to resolve one")
        store = self._store
        try:
            n = int(store.add(BACKENDS_SEQ_KEY, 0))
        except Exception:
            n = self._reg_idx
        i = self._reg_idx + 1
        advance = True
        now = time.monotonic()
        while i <= n:
            key = f"{BACKENDS_REG_PREFIX}/{i}"
            try:
                if not store.check(key):
                    # a registration in flight (counter bumped, entry not
                    # yet set): the watermark stops before it, but later
                    # entries fold now; a hole older than a minute is a
                    # registrant that died between its add and its set
                    first = self._reg_holes.setdefault(i, now)
                    if now - first < 60.0:
                        advance = False
                    else:
                        self._reg_holes.pop(i, None)
                else:
                    self._reg_holes.pop(i, None)
                    e = json.loads(store.get(key).decode())
                    self._reg_cache[str(e["name"])] = str(e["addr"])
            except (ValueError, KeyError, TypeError):
                pass      # a poison entry: skip it for good
            except Exception:
                break     # a transient store error: retry from here
            if advance:
                self._reg_idx = i
            i += 1
        out = dict(self._reg_cache)
        try:
            if "default" not in out and store.check(BACKEND_KEY):
                out["default"] = store.get(BACKEND_KEY).decode()
        except Exception:
            pass
        return out

    def _live_links(self) -> List[_BackendLink]:
        with self._mu:
            return [l for l in self._links.values() if not l.dead]

    def _dial_new(self) -> List[_BackendLink]:
        """Dial every registered backend not linked yet; returns the links
        that came up (a dial failure prunes silently: the registry keeps a
        dead incarnation's entry until its name registers again)."""
        with self._dial_mu:
            self._last_refresh = time.monotonic()
            fresh = []
            try:
                known = self._known_backends()
            except ConnectionError:
                return fresh
            for name, addr in known.items():
                with self._mu:
                    cur = self._links.get(name)
                    if cur is not None and not cur.dead \
                            and cur.addr == addr:
                        continue
                try:
                    link = _BackendLink(self, name, addr)
                except (OSError, ConnectionError):
                    continue
                with self._mu:
                    closing = self._closing   # a close raced this dial
                    if not closing:
                        old = self._links.get(name)
                        self._links[name] = link
                if closing:
                    link.close()
                    break
                if old is not None:
                    old.close()
                fresh.append(link)
            return fresh

    def pick_link(self, deadline: Optional[float] = None) -> _BackendLink:
        """The live link with the fewest requests in flight, dialing the
        registry as needed; retried until ``deadline`` (default
        ``backend_timeout`` from now), then a named ``ConnectionError``."""
        if deadline is None:
            deadline = time.monotonic() + self.backend_timeout

        def attempt():
            # the registry is re-read at most every 2 s while links are
            # healthy; a submit with NO live link always re-reads it (the
            # backend-mid-restart path)
            live = self._live_links()
            if not live or time.monotonic() - self._last_refresh > 2.0:
                self._dial_new()
                live = self._live_links()
            if not live:
                raise ConnectionError("no live serving backend")
            with self._mu:
                return min(live, key=lambda l: len(l.inflight))

        try:
            return retry_call(
                attempt, timeout=max(0.05, deadline - time.monotonic()),
                what="resolve+dial serving backend", base=0.1, cap=1.0)
        except BackoffDeadlineError as e:
            raise ConnectionError(
                f"no serving backend reachable within "
                f"{self.backend_timeout:.0f}s (last error: "
                f"{e.last!r})") from e

    # -- death + failover ----------------------------------------------------

    def _link_died(self, link: _BackendLink, detail: str) -> None:
        link.dead = True
        _shutdown(link.sock)
        with self._mu:
            if self._links.get(link.name) is link:
                del self._links[link.name]
            orphans = list(link.inflight.items())
            link.inflight.clear()
        for _, fwd in orphans:
            if fwd.stats_ev is not None:
                fwd.stats_ev.set()
                continue
            self._failover(fwd, detail)

    def _failover(self, fwd: _Forward, detail: str) -> None:
        """Reroute one orphaned request to an ALREADY-LIVE backend, or fail
        it by name.  No dialing here: a restarting backend is seconds away
        at best, and in-flight requests must end bounded — new submits own
        the wait for the restart."""
        if fwd.sess.closed:
            fwd.sess._unroute(fwd.cid)
            return  # nobody is reading: drop the orphan quietly
        with self._mu:
            cancelled = (fwd.cancelled
                         or fwd.cid in fwd.sess._cancelled_cids)
        if cancelled:
            # replaying a cancelled submit would decode for a client that
            # walked away: end the handle by name instead
            fwd.sess._unroute(fwd.cid)
            fwd.sess._to_client({
                "type": "error", "id": fwd.cid,
                "error": "RequestCancelledError",
                "detail": "request cancelled; its backend died before "
                          "confirming the cancellation"})
            return
        while fwd.retries < 1:
            fwd.retries += 1
            live = self._live_links()
            if not live:
                break
            with self._mu:
                link = min(live, key=lambda l: len(l.inflight))
                gw_rid = next(self._grid)
                fwd.skip = fwd.delivered
                link.inflight[gw_rid] = fwd
            fwd.sess._reroute(fwd.cid, link, gw_rid)
            try:
                link.send(dict(fwd.frame, id=gw_rid))
                return
            except (OSError, ConnectionError):
                with self._mu:
                    link.inflight.pop(gw_rid, None)
                continue
        fwd.sess._unroute(fwd.cid)
        fwd.sess._to_client({
            "type": "error", "id": fwd.cid, "error": "BackendGoneError",
            "detail": f"backend died mid-request ({detail}) with no live "
                      f"replica to absorb it; resubmit after the "
                      f"supervised restart"})

    # -- stats ---------------------------------------------------------------

    def gateway_stats(self) -> dict:
        with self._mu:
            return {name: {"addr": l.addr, "inflight": len(l.inflight)}
                    for name, l in self._links.items() if not l.dead}

    def collect_stats(self, timeout: float = 5.0) -> dict:
        """The wire ``stats`` answer: per-backend in-flight counts (the
        routing balance) and each live backend's own engine stats, each
        probe bounded by ``timeout``."""
        probes = []
        for link in self._live_links():
            fwd = _Forward(None, None, None)
            fwd.stats_ev = threading.Event()
            with self._mu:
                gw_rid = next(self._grid)
                link.inflight[gw_rid] = fwd
            try:
                link.send({"type": "stats", "id": gw_rid})
                probes.append((link, fwd))
            except (OSError, ConnectionError):
                with self._mu:
                    link.inflight.pop(gw_rid, None)
        deadline = time.monotonic() + timeout
        backends = {}
        for link, fwd in probes:
            fwd.stats_ev.wait(max(0.0, deadline - time.monotonic()))
            if fwd.stats_out is not None:
                backends[link.name] = fwd.stats_out
            else:
                # a timed-out probe: reclaim its entry, or a wedged but
                # alive backend would carry phantom load forever
                with self._mu:
                    for rid, f in list(link.inflight.items()):
                        if f is fwd:
                            del link.inflight[rid]
        return {"gateway": self.gateway_stats(), "backends": backends}

    # -- sessions ------------------------------------------------------------

    def _serve_conn(self, conn) -> None:
        if not self._hello(conn):
            return
        sess = _GatewaySession(self, conn)
        try:
            sess.run()
        finally:
            sess.close()

    def close(self) -> None:
        """Stop accepting, end every client session and backend link, and
        join their threads."""
        super().close()
        with self._mu:
            links = list(self._links.values())
            self._links.clear()
        for l in links:
            l.close()


class _GatewaySession:
    """One client connection's view: its routes (client rid → the backend
    link and gateway rid carrying it) and the client-side send lock.
    Backend traffic arrives through the SHARED links' pumps."""

    def __init__(self, gw: Gateway, conn):
        self.gw = gw
        self.conn = conn
        self._client_mu = threading.Lock()
        self._routes: Dict[object, Tuple[_BackendLink, int]] = {}
        self._cancelled_cids: set = set()   # closes the race of a cancel
        # landing while its request is orphaned between _link_died and
        # _failover: the replay must still be blocked
        self._stats_busy = threading.Event()
        self.closed = False

    def _to_client(self, obj: dict) -> None:
        if self.closed:
            return
        try:
            send_frame(self.conn, obj, lock=self._client_mu)
        except (OSError, ConnectionError):
            self.closed = True

    def _reroute(self, cid, link, gw_rid) -> None:
        with self.gw._mu:
            self._routes[cid] = (link, gw_rid)

    def _unroute(self, cid) -> None:
        with self.gw._mu:
            self._routes.pop(cid, None)

    def run(self) -> None:
        while not self.closed and not self.gw._closing:
            try:
                frame = read_frame(self.conn)
            except (OSError, ConnectionError):
                return
            if frame is None:
                return
            kind = frame.get("type")
            if kind == "cancel":
                with self.gw._mu:
                    self._cancelled_cids.add(frame.get("id"))
                    route = self._routes.get(frame.get("id"))
                    if route is not None:
                        link, gw_rid = route
                        fwd = link.inflight.get(gw_rid)
                        if fwd is not None:
                            fwd.cancelled = True  # never failover-replay
                if route is not None:
                    try:
                        link.send({"type": "cancel", "id": gw_rid})
                    except (OSError, ConnectionError):
                        pass  # the pump's sweep owns this link's death
                continue
            if kind == "stats":
                # answered off the session's reader (a wedged backend's
                # probe waits out its deadline); one probe in flight a
                # session — a fast poller gets the routing snapshot
                rid = frame.get("id")
                if self._stats_busy.is_set():
                    self._to_client({"type": "stats", "id": rid,
                                     "stats": {"gateway":
                                               self.gw.gateway_stats(),
                                               "backends": {}}})
                    continue
                self._stats_busy.set()

                def _answer(rid=rid):
                    try:
                        self._to_client(
                            {"type": "stats", "id": rid,
                             "stats": self.gw.collect_stats()})
                    finally:
                        self._stats_busy.clear()

                threading.Thread(target=_answer, daemon=True,
                                 name="tpu_dist_torch-serve-gw-stats").start()
                continue
            if kind != "submit":
                self._to_client({"type": "error", "id": frame.get("id"),
                                 "error": "ProtocolError",
                                 "detail": f"unknown frame type {kind!r}"})
                continue
            self._forward(frame)

    def _forward(self, frame: dict) -> None:
        cid = frame.get("id")
        deadline = time.monotonic() + self.gw.backend_timeout
        while True:
            try:
                link = self.gw.pick_link(deadline)
            except (ConnectionError, TimeoutError) as e:
                self._to_client({"type": "error", "id": cid,
                                 "error": "BackendUnavailableError",
                                 "detail": f"no serving backend: {e}"})
                return
            fwd = _Forward(self, cid, frame)
            with self.gw._mu:
                gw_rid = next(self.gw._grid)
                link.inflight[gw_rid] = fwd
                self._routes[cid] = (link, gw_rid)
            try:
                link.send(dict(frame, id=gw_rid))
                return
            except (OSError, ConnectionError) as e:
                with self.gw._mu:
                    link.inflight.pop(gw_rid, None)
                    self._routes.pop(cid, None)
                self.gw._link_died(link, repr(e))
                if time.monotonic() >= deadline:
                    self._to_client({"type": "error", "id": cid,
                                     "error": "BackendUnavailableError",
                                     "detail": f"no serving backend: {e}"})
                    return

    def close(self) -> None:
        self.closed = True
        # cancel everything this client still had in flight: the backend
        # frees the slots instead of decoding into a dead session
        with self.gw._mu:
            routes = list(self._routes.items())
            self._routes.clear()
        for cid, (link, gw_rid) in routes:
            try:
                link.send({"type": "cancel", "id": gw_rid})
            except (OSError, ConnectionError):
                pass


def store_from_env(timeout: float = 30.0):
    """Control-plane store client from the launcher's env contract
    (``TPU_DIST_STORE_ADDR``), or None when it is absent — the gateway and
    the serving worker find each other through it.  The heartbeat's parser
    of that contract, so the two can never resolve different stores."""
    from ..resilience.heartbeat import _store_from_env
    return _store_from_env(timeout=timeout)
