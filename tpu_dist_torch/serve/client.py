"""Client for the serve frontend — counterpart of
``tpu_dist/serve/client.py``: streaming handles, named errors.

The client enforces the layer's no-silent-drop contract from its side:
every :meth:`ServeClient.submit` returns a ``RequestHandle``
(:mod:`tpu_dist_torch.serve.engine`) that ALWAYS terminates — with the
token stream and ``done``, with the server's named error
(:class:`RequestFailedError` carrying the server-side exception name), or
with :class:`ServerGoneError` when the connection itself died with
requests outstanding.  ``wait_done(timeout)`` is deadline-bounded, so a
vanished server can never hang a caller.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

from ._wire import _JOIN_TIMEOUT, _shutdown
from .engine import RequestHandle, ServeError
from .frontend import connect_hello, read_frame, send_frame

__all__ = ["ServeClient", "RequestFailedError", "ServerGoneError"]


class RequestFailedError(ServeError):
    """The server answered this request with an error frame.  ``error``
    is the server-side exception name (``SchedulerDrainingError``,
    ``QueueFullError``, ...), ``detail`` its
    message."""

    def __init__(self, error: str, detail: str = ""):
        self.error = error
        self.detail = detail
        super().__init__(f"{error}: {detail}" if detail else error)


class ServerGoneError(ServeError):
    """The connection to the serving frontend died with this request in
    flight — the request's fate is unknown, which the client reports
    loudly instead of leaving the handle pending forever."""


def _connect(host: str, port: int, timeout: float, retry: float):
    """``connect_hello``, retried on connection-shaped failures with a
    doubling back-off (0.05 s up to 2 s) until ``retry`` seconds pass; the
    last failure is raised then."""
    deadline = time.monotonic() + max(0.0, float(retry))
    delay = 0.05
    while True:
        try:
            return connect_hello(host, port, timeout=timeout)
        except (OSError, ConnectionError):
            left = deadline - time.monotonic()
            if left <= 0:
                raise
            time.sleep(min(delay, left))
            delay = min(2.0, 2 * delay)


class ServeClient:
    """Socket client for a serve frontend (the port's
    :class:`~tpu_dist_torch.serve.frontend.Frontend`, or the JAX package's
    frontend or gateway: the wire is the same).

    ``connect_retry`` bounds a retry window for the initial connection
    (a frontend that is still binding); 0 tries once.  Thread-safe:
    submits may come from any thread, one reader thread dispatches
    response frames to the per-request handles.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 connect_retry: float = 0.0):
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)
        self._sock = _connect(host, port, timeout, connect_retry)
        self._send_mu = threading.Lock()
        self._mu = threading.Lock()
        self._handles: Dict[int, RequestHandle] = {}
        self._stats_waiters: Dict[int, object] = {}
        self._next_id = 1
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="tpu_dist_torch-serve-client")
        self._reader.start()

    # -- API -----------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: int = 0,
               deadline_ms: Optional[float] = None) -> RequestHandle:
        """Send one request; returns its streaming handle.  Raises
        :class:`ServerGoneError` if the connection is already dead.
        ``deadline_ms`` is the server-side end-to-end budget: past it the
        request is shed/slot-freed and the handle terminates with a
        ``DeadlineExceededError``-naming :class:`RequestFailedError`.
        The handle's ``cancel()`` sends a ``cancel`` frame — the server
        frees the slot at its next iteration boundary."""
        with self._mu:
            if self._closed:
                raise ServerGoneError("client is closed")
            rid = self._next_id
            self._next_id += 1
            handle = RequestHandle(rid)
            handle._cancel = lambda: self._send_cancel(rid)
            self._handles[rid] = handle
        frame = {"type": "submit", "id": rid,
                 "prompt": [int(t) for t in prompt],
                 "max_new_tokens": int(max_new_tokens),
                 "temperature": float(temperature),
                 "eos_id": None if eos_id is None else int(eos_id),
                 "seed": int(seed)}
        if deadline_ms is not None:
            frame["deadline_ms"] = float(deadline_ms)
        try:
            send_frame(self._sock, frame, lock=self._send_mu)
        except (OSError, ConnectionError) as e:
            self._fail_all(ServerGoneError(
                f"connection to {self.host}:{self.port} lost: {e!r}"))
            raise self._handles_error()
        return handle

    def _send_cancel(self, rid: int) -> None:
        try:
            send_frame(self._sock, {"type": "cancel", "id": rid},
                       lock=self._send_mu)
        except (OSError, ConnectionError):
            pass  # a dead connection already fails every handle by name

    def generate(self, prompt, max_new_tokens: int = 16,
                 timeout: float = 120.0, **kw) -> list:
        """Blocking convenience: submit and wait for the full token list."""
        return self.submit(prompt, max_new_tokens, **kw).wait_done(timeout)

    def stats(self, timeout: float = 10.0) -> dict:
        """Server-side load snapshot, one ``stats`` frame round-trip:
        against a frontend, the engine's occupancy/latency split + the
        scheduler's queue depth.  Deadline-bounded."""
        with self._mu:
            if self._closed:
                raise ServerGoneError("client is closed")
            rid = self._next_id
            self._next_id += 1
            box: "queue.Queue" = queue.Queue(1)
            self._stats_waiters[rid] = box
        try:
            send_frame(self._sock, {"type": "stats", "id": rid},
                       lock=self._send_mu)
        except (OSError, ConnectionError) as e:
            with self._mu:
                self._stats_waiters.pop(rid, None)
            self._fail_all(ServerGoneError(
                f"connection to {self.host}:{self.port} lost: {e!r}"))
            raise self._handles_error()
        try:
            got = box.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no stats frame from {self.host}:{self.port} within "
                f"{timeout:.1f}s") from None
        finally:
            with self._mu:
                self._stats_waiters.pop(rid, None)
        if isinstance(got, BaseException):
            raise got
        return got

    def pending(self) -> int:
        with self._mu:
            return len(self._handles)

    def close(self) -> None:
        """Fail the requests still in flight and end the connection.  The
        socket is shut down before it is closed, which wakes the reader
        thread (a plain ``close`` does not, on Linux), and the reader is
        joined."""
        with self._mu:
            closed, self._closed = self._closed, True
        _shutdown(self._sock)
        if not closed:
            self._fail_all(ServerGoneError("client closed with the request "
                                           "still in flight"))
        if self._reader is not threading.current_thread():
            self._reader.join(_JOIN_TIMEOUT)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reader --------------------------------------------------------------

    def _handles_error(self) -> ServerGoneError:
        return ServerGoneError(
            f"connection to {self.host}:{self.port} lost")

    def _fail_all(self, exc: ServeError) -> None:
        """Connection death: every in-flight handle terminates with the
        named error — no handle is ever left pending forever."""
        with self._mu:
            self._closed = True
            handles, self._handles = list(self._handles.values()), {}
            waiters = list(self._stats_waiters.values())
            self._stats_waiters.clear()
        for h in handles:
            h._on_error(exc)
        for box in waiters:
            try:
                box.put_nowait(exc)   # a blocked stats() call terminates
            except Exception:
                pass

    def _read_loop(self) -> None:
        detail = "server closed the connection"
        try:
            while True:
                frame = read_frame(self._sock)
                if frame is None:
                    break
                self._dispatch(frame)
        except (OSError, ConnectionError) as e:
            detail = repr(e)
        with self._mu:
            closed = self._closed
        if closed:
            return  # local close(): close() already failed the handles
        self._fail_all(ServerGoneError(
            f"connection to {self.host}:{self.port} lost with requests in "
            f"flight: {detail}"))

    def _dispatch(self, frame: dict) -> None:
        kind = frame.get("type")
        rid = frame.get("id")
        if kind == "stats":
            with self._mu:
                box = self._stats_waiters.get(rid)
            if box is not None:
                try:
                    box.put_nowait(frame.get("stats") or {})
                except Exception:
                    pass
            return
        with self._mu:
            handle = self._handles.get(rid)
            if kind in ("done", "error") and rid in self._handles:
                del self._handles[rid]
        if handle is None:
            return  # response for a request we no longer track
        if kind == "token":
            handle._on_token(frame["t"])
        elif kind == "done":
            handle._on_done(frame.get("reason", "length"))
        elif kind == "error":
            handle._on_error(RequestFailedError(
                frame.get("error", "UnknownError"),
                frame.get("detail", "")))
