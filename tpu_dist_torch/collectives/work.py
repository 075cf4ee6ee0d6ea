"""Async collectives: :class:`Work` futures — counterpart of
``tpu_dist/collectives/work.py``.

``async_op=True`` on the eager collectives, the :class:`~tpu_dist_torch.
collectives.bucketer.Bucketer` and ZeRO's parameter gather return a
:class:`Work`.  It wraps one of two things:

- **torch.distributed async handles** (the device collectives: bucket
  reduce-scatters and all-gathers, ZeRO's gather), each waited by
  :func:`wait_handle`: on NCCL the *current stream* waits for the
  collective's stream and the host goes on (torch's semantics; the
  process group's watchdog bounds a hung collective by the group's
  timeout), elsewhere the host waits under the group's timeout or the
  caller's; then ``wait()`` returns the result the issuer attached;
- **a body run on the ordered executor** (the eager host collectives): one
  FIFO worker thread per process, so async collectives run in issue order,
  the order every peer sees (stream semantics).

Errors raised while the work runs are stored on the handle and re-raised by
``wait()``; ``exception()`` shows them without raising.  ``wait(timeout)``
raises ``TimeoutError`` while the work is still in flight (an executor body
keeps running and may be waited on again).  Every synchronous collective of the port calls
:func:`drain_pending` first, so it cannot overtake queued async ones.
"""

from __future__ import annotations

import datetime
import threading
import time
import weakref
from collections import deque
from typing import Callable, List, Optional, Sequence

__all__ = ["Work", "completed_work", "wait_all", "drain_pending", "reset",
           "engine", "engine_for", "wait_handle"]


def _group_timeout(group=None) -> float:
    """Seconds of a torch process group's own timeout (the default
    group's when ``group`` is None): the deadline its collectives run
    under."""
    import torch
    dist = torch.distributed
    try:
        g = group if group is not None else dist.group.WORLD
        opts = g._get_backend(torch.device("cpu")).options
        return opts._timeout.total_seconds()
    except Exception:   # a backend without options: torch's default
        return dist.distributed_c10d._get_default_timeout(
            dist.get_backend(group)).total_seconds()


def wait_handle(handle, group=None, timeout: Optional[float] = None):
    """Wait one ``torch.distributed`` async handle issued on ``group`` (a
    torch process group; the default group when None) under a deadline.

    On NCCL the wait is a stream wait, as torch's ``wait()``: the current
    stream waits for the collective's and the host goes on, and the
    group's watchdog aborts a collective that outlives the group's
    timeout.  Elsewhere (gloo) the host waits at most ``timeout`` seconds,
    the group's own timeout when None, and torch raises past it."""
    import torch
    if torch.distributed.get_backend(group) == "nccl":
        # tpudlint: disable=TD004  # NCCL stream wait: the host goes on, the group's watchdog enforces its timeout
        return handle.wait()
    secs = _group_timeout(group) if timeout is None else timeout
    return handle.wait(timeout=datetime.timedelta(seconds=secs))


class Work:
    """Handle for one asynchronously issued collective (torch ``dist.Work``
    parity, future-flavoured).  ``wait(timeout)`` returns its result (the
    reduced or gathered value), re-raising any error it hit;
    ``is_completed()`` polls; ``exception()`` returns the captured error
    (None while pending or on success); ``result`` is ``wait``."""

    __slots__ = ("_done", "_result", "_exc", "_label", "_handles", "_then",
                 "_group", "issued_ns", "started_ns", "site")

    def __init__(self, label: str = "work", handles: Sequence = (),
                 then: Optional[Callable[[], object]] = None, group=None):
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._label = label
        self._handles = list(handles)
        self._then = then
        self._group = group
        self.issued_ns = time.monotonic_ns()
        self.started_ns: Optional[int] = None
        self.site: Optional[str] = None

    def _finish(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._done.set()

    def _complete_handles(self, timeout: Optional[float]) -> None:
        """Wait the torch handles (a stream wait on NCCL, else under the
        group's timeout or ``timeout``), then run the issuer's ``then``
        for the result."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for h in self._handles:
            if deadline is None:
                wait_handle(h, self._group)
                continue
            left = max(deadline - time.monotonic(), 0.001)
            try:
                wait_handle(h, self._group, left)
            except RuntimeError as e:
                if "imed out" not in str(e) and "imeout" not in str(e):
                    self._finish(exc=e)
                    return
                raise TimeoutError(
                    f"async collective {self._label!r} still in flight "
                    f"after {timeout}s") from e
        try:
            self._finish(self._then() if self._then is not None else None)
        except Exception as e:  # captured for wait()/exception()
            self._finish(exc=e)

    def wait(self, timeout: Optional[float] = None):
        """Block until the work completes; returns its result.  Re-raises
        the error captured while it ran.  Raises ``TimeoutError`` if it is
        still in flight after ``timeout`` seconds."""
        if ((self._handles or self._then is not None)
                and not self._done.is_set()):
            self._complete_handles(timeout)
        elif not self._done.wait(timeout):
            raise TimeoutError(
                f"async collective {self._label!r} still in flight after "
                f"{timeout}s (wait again, or check exception())")
        if self._exc is not None:
            raise self._exc
        return self._result

    def is_completed(self) -> bool:
        """True once the collective finished (successfully or not)."""
        if self._done.is_set():
            return True
        return bool(self._handles) and all(h.is_completed()
                                           for h in self._handles)

    def exception(self) -> Optional[BaseException]:
        """The error captured while the work ran, or None."""
        return self._exc if self._done.is_set() else None

    def result(self, timeout: Optional[float] = None):
        """Alias for :meth:`wait` (concurrent.futures flavour)."""
        return self.wait(timeout)

    def __repr__(self):
        state = ("pending" if not self._done.is_set()
                 else "error" if self._exc is not None else "done")
        return f"Work({self._label!r}, {state})"


def completed_work(result, label: str = "work") -> Work:
    """An already finished :class:`Work` (single-process fast paths)."""
    w = Work(label)
    w._finish(result=result)
    return w


# set while an executor worker runs a body: drain_pending from inside the
# body must not wait on its own queue, and the obs span the body opens
# picks up its queue wait and its issue call-site
_tls = threading.local()


def take_pending_queue_ns() -> Optional[int]:
    """Pop the queue wait (ns) of the body executing on this thread: the
    first flight-recorder span the body opens takes it, splitting time
    behind earlier collectives from wire time."""
    ns = getattr(_tls, "queue_ns", None)
    _tls.queue_ns = None
    return ns


def pending_site() -> Optional[str]:
    """The issue call-site of the body executing on this thread (not
    consumed: every span the body opens is attributed to it; the engine
    thread's own stack holds no user frame)."""
    return getattr(_tls, "site", None)


def _issue_site() -> Optional[str]:
    """The submitting caller's call-site, taken only while the flight
    recorder is armed (a stack walk is not free)."""
    try:
        from ..obs import recorder as _rec
        if _rec.enabled():
            return _rec.call_site()
    except Exception:
        pass
    return None


class _OrderedExecutor:
    """Single-worker FIFO executor: bodies run in issue order, one at a
    time.  The daemon worker starts on the first submit and retires after
    30 s idle."""

    def __init__(self, name: str = "tpu_dist_torch-async-coll"):
        self._name = name
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._q: deque = deque()
        self._pending = 0          # queued + executing
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn: Callable[[], object], label: str = "work") -> Work:
        w = Work(label)
        w.site = _issue_site()
        with self._mu:
            self._q.append((fn, w))
            self._pending += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self._name)
                self._thread.start()
            self._cv.notify_all()
        return w

    def _run(self):
        while True:
            with self._mu:
                while not self._q:
                    if not self._cv.wait(30.0) and not self._q:
                        self._thread = None
                        return
                batch = list(self._q)
                self._q.clear()
            for fn, w in batch:
                w.started_ns = time.monotonic_ns()
                _tls.queue_ns = w.started_ns - w.issued_ns
                _tls.site = w.site
                _tls.on_engine = True
                try:
                    w._finish(result=fn())
                except BaseException as e:  # stored, re-raised by wait()
                    w._finish(exc=e)
                finally:
                    _tls.queue_ns = None
                    _tls.site = None
                    _tls.on_engine = False
                    with self._mu:
                        self._pending -= 1
                        self._cv.notify_all()

    def pending(self) -> int:
        with self._mu:
            return self._pending

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted body has finished; False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            while self._pending > 0:
                left = None if deadline is None else deadline - \
                    time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(left if left is not None else 1.0)
        return True


_engine: Optional[_OrderedExecutor] = None
_engine_mu = threading.Lock()
# per-DataPlane engines: the in-process multi-rank rigs (one plane and one
# ordered stream per fake rank, Bucketer(dp=...)); weak so they die with
# their planes
_engines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def engine() -> _OrderedExecutor:
    """The process's ordered executor (created on first use)."""
    global _engine
    with _engine_mu:
        if _engine is None:
            _engine = _OrderedExecutor()
        return _engine


def engine_for(dp=None) -> _OrderedExecutor:
    """The ordered executor of ``dp``'s ring, or the process's for
    ``dp=None`` (the JAX package's ``engine_for``)."""
    if dp is None:
        return engine()
    with _engine_mu:
        eng = _engines.get(dp)
        if eng is None:
            eng = _engines[dp] = _OrderedExecutor(
                f"tpu_dist_torch-async-coll-r{getattr(dp, 'rank', '?')}")
        return eng


def drain_pending(timeout: Optional[float] = None) -> None:
    """Wait for every queued async host collective (every engine) to
    finish.  Called at the top of every synchronous collective, and a no-op
    on an executor's own thread (a body calling a sync collective must not
    wait on its own queue)."""
    if getattr(_tls, "on_engine", False):
        return
    with _engine_mu:
        engines = list(_engines.values())
        if _engine is not None:
            engines.append(_engine)
    for eng in engines:
        eng.drain(timeout)


def wait_all(works: Sequence[Work], timeout: Optional[float] = None) -> List:
    """Wait on several :class:`Work` handles; returns their results in
    order.  The first captured error re-raises (after every handle had its
    share of the deadline)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    return [w.wait(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            for w in works]


def reset() -> None:
    """Drop the executor (tests): queued work keeps running on the orphaned
    thread, new submissions get a fresh queue."""
    global _engine
    with _engine_mu:
        _engine = None
