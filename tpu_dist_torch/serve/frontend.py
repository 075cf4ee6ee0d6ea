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
and the port's client drives the JAX package's.  Its gateway, backend
registry and store discovery come with the launcher (ROADMAP A5); the
network fault injection of its serve wire with the resilience slice (A9).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, Optional

from ._wire import (_JOIN_TIMEOUT, FrameCorruptError, _recv_exact, _sendv,
                    _shutdown, _tune_socket, frame_checksum)
from .scheduler import Scheduler

__all__ = ["Frontend", "connect_hello", "read_frame", "send_frame"]

_MAGIC = b"TPSV"
_HELLO = struct.Struct("<4sH")   # magic, protocol version
# v2: every frame carries a payload checksum (u32 length || u32 crc ||
# json) — a flipped bit on the request wire fails the connection with a
# named FrameCorruptError instead of decoding to silently wrong tokens
_VERSION = 2
_U32 = struct.Struct("<I")
_MAX_FRAME = 64 << 20


def send_frame(sock, obj: dict, lock: Optional[threading.Lock] = None) -> None:
    """One checksummed length-prefixed JSON frame, vectored send (header +
    payload in one syscall).  ``lock`` serializes concurrent writers on a
    shared connection (token frames for different requests interleave)."""
    payload = json.dumps(obj).encode()
    header = _U32.pack(len(payload)) + _U32.pack(frame_checksum((payload,)))
    if lock is None:
        _sendv(sock, header, payload)
    else:
        with lock:
            _sendv(sock, header, payload)


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


class Frontend:
    """Engine-side frame server: accepts serve-protocol connections (one
    thread each) and feeds the scheduler; per-request tokens stream back as
    they are emitted.  A client that disconnects (or sends a ``cancel``
    frame) mid-decode has its in-flight requests cancelled: the engine
    frees their slots at the next iteration boundary.

    ``store`` (the control-plane registry a gateway resolves backends
    through) comes with the launcher slice; only ``None`` is taken here.
    ``backend_name`` is this backend's identity in ``stats`` frames."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, store=None, backend_name: str = "default"):
        if store is not None:
            raise NotImplementedError(
                "Frontend(store=...): backend registration in the "
                "control-plane store comes with the launcher slice "
                "(ROADMAP A5)")
        self.scheduler = scheduler
        self.backend_name = str(backend_name)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._closing = False
        self._mu = threading.Lock()
        self._conns: Dict[socket.socket, threading.Thread] = {}
        self._acceptor = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="tpu_dist_torch-serve-frontend")
        self._acceptor.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        """Stop accepting, end every open connection (their in-flight
        requests are cancelled, their clients see the server gone) and
        join the frontend's threads, so nothing holds the scheduler or the
        engine's pool after it.  Where the JAX package only closes the
        listening socket, this shuts the sockets down first: on Linux a
        ``close`` does not wake a thread blocked in ``accept`` or ``recv``
        on the same socket, and that thread would keep the frontend, and
        through it the engine, alive."""
        with self._mu:
            self._closing = True
            conns = dict(self._conns)
        for sock in [self._sock, *conns]:
            _shutdown(sock)
        for t in [self._acceptor, *conns.values()]:
            if t is not threading.current_thread():
                t.join(_JOIN_TIMEOUT)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            _tune_socket(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name="tpu_dist_torch-serve-conn")
            with self._mu:
                if self._closing:
                    conn.close()
                    return
                self._conns[conn] = t
            t.start()

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

    def _stats(self) -> dict:
        eng = self.scheduler.engine
        return dict(eng.stats(), scheduler=self.scheduler.snapshot(),
                    free_slots=eng.free_slots(), backend=self.backend_name)

    def _serve_conn(self, conn) -> None:
        if not self._hello(conn):
            conn.close()
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
            with self._mu:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass
