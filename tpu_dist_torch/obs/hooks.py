"""Instrumentation hooks: collective spans, store tails, crash dumps
(counterpart of ``tpu_dist/obs/hooks.py``).

This is the thin layer the rest of the port calls into; everything is a
no-op (one env lookup) while the recorder is disarmed.

- :func:`collective_span` — context manager the eager collectives
  (:mod:`tpu_dist_torch.collectives.eager`) and host ring collectives
  (:mod:`tpu_dist_torch.collectives.ring`) wrap themselves in.  The span opens a
  ``pending`` event before any payload moves, so a hung collective is
  visible in the crash dump, and closes it with ``ok`` / ``error:Type``.
- :func:`annotate_transport` — called from the single counter-ingestion
  point (:func:`.recorder.record_transport`) to stamp the
  enclosing span with the transport path it actually took.
- :func:`post_tail` / :func:`fetch_tail` — each rank's compact "last known
  position" rides the control-plane store under
  ``tpu_dist/g{gen}/obs/{rank}`` (posted on every heartbeat beat), so even
  a SIGKILLed rank leaves its position behind for the supervisor's table
  and for the ``RankLostError`` / ``PeerGoneError`` messages.
- :func:`install_from_env` — arms the crash-dump paths: ``sys.excepthook``
  (any unhandled exception, which covers ``RankLostError``,
  ``CollectiveMismatchError`` and ``PeerGoneError``), a chained SIGTERM
  handler (the supervisor's kill path), and an atexit catch-all so clean
  runs leave dumps for timeline merging too.

A rank blocked inside an NCCL call or a CUDA synchronize runs no Python
signal handler until the call returns, so on the NCCL path a SIGUSR1 may
get no dump from a waiting rank; its heartbeat thread's store tail is then
the record of where it was.  The host data plane waits in Python socket
waits with deadlines, where the handlers run.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from . import recorder

__all__ = ["collective_span", "current_span", "note_path", "note_algo",
           "annotate_transport", "heartbeat_tick", "post_tail", "fetch_tail",
           "render_tail", "install_from_env", "install_signal_handlers",
           "request_dumps"]

_tls = threading.local()


def current_span() -> Optional[dict]:
    """The innermost in-flight span opened on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class _NullCtx:
    """Shared disarmed context — no allocation on the hot path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _Span:
    __slots__ = ("_rec", "ev")

    def __init__(self, rec, ev):
        self._rec, self.ev = rec, ev

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.ev)
        return self.ev

    def __exit__(self, etype, exc, tb):
        if etype is None:
            self._rec.end(self.ev, outcome="ok")
        else:
            self._rec.end(self.ev, outcome=f"error:{etype.__name__}")
        stack = getattr(_tls, "stack", None)
        if stack:
            stack.pop()
        return False


def collective_span(op: str, value=None, reduce_op=None, src=None, dst=None,
                    peer=None, kind: str = "collective", path=None,
                    group=None):
    """Span context for one collective (or p2p) call.  ``kind='collective'``
    consumes the cross-rank collective sequence counter (every rank of an
    SPMD program opens span #N together — the merge key); ``kind='p2p'``
    deliberately does not, because send/recv are rank-asymmetric."""
    rec = recorder.get_recorder()
    if rec is None:
        return _NULL
    fields = {}
    try:
        # async collectives: spans opened on the ordered engine attribute
        # to the issuing call-site (the engine thread's own stack holds no
        # user frames), and the first span additionally carries queue_ns —
        # how long the work sat behind earlier collectives — split from
        # wire time (both slots set by the engine around the body)
        from ..collectives.work import pending_site, take_pending_queue_ns
        qns = take_pending_queue_ns()
        if qns is not None:
            fields["queue_ns"] = qns
        fields["site"] = pending_site()
    except Exception:
        pass
    if not fields.get("site"):
        fields["site"] = recorder.call_site()
    if group is not None and kind == "collective":
        # sub-group collectives run on MEMBER ranks only: consuming the
        # world's lockstep `coll` counter would permanently skew the
        # cross-rank merge/diagnose key for every later flat collective
        # (members at #N+1, non-members at #N).  Like p2p spans, they are
        # rank-asymmetric from the world's perspective — attributed by
        # the `group` field instead of the lockstep sequence.
        kind = "group-collective"
    if kind == "collective":
        fields["coll"] = rec.next_coll()
    if reduce_op is not None:
        fields["reduce"] = str(reduce_op).lower()
    if src is not None:
        fields["src"] = int(src)
    if dst is not None:
        fields["dst"] = int(dst)
    if peer is not None:
        fields["peer"] = int(peer)
    if path is not None:
        fields["path"] = path
    if group is not None:
        fields["group"] = str(group)  # SubGroup id (scoped collectives)
    if value is not None:
        dg, nbytes = recorder.digest(value)
        fields["digest"] = dg
        fields["bytes"] = nbytes
    return _Span(rec, rec.begin(kind, op, **fields))


def note_algo(algo: str) -> None:
    """Stamp the enclosing span with the selected collective algorithm
    (``flat`` | ``hier`` | ``store``, :mod:`..collectives.topology`'s
    autoselector), so traces show which ring shape a payload took."""
    span = current_span()
    if span is None:
        return
    rec = recorder.get_recorder()
    if rec is not None:
        rec.update_event(span, algo=algo)


def note_path(path: str) -> None:
    """Stamp the enclosing span's transport path (the mesh-collective
    branches, which never reach record_transport)."""
    span = current_span()
    if span is not None and span.get("path") is None:
        rec = recorder.get_recorder()
        if rec is not None:
            # through the recorder lock: snapshot()/last_position() copy
            # this dict from other threads, and inserting a new key during
            # that copy raises "dictionary changed size during iteration"
            rec.update_event(span, path=path)


def note_wire(wire_bytes: int, comm: Optional[str] = None,
              raw_bytes: Optional[int] = None) -> None:
    """Stamp the enclosing span with the wire quantities: ``wire_bytes``
    (compressed bytes that actually crossed the wire), ``raw_wire_bytes``
    (what the same traffic would have cost uncompressed — their ratio is
    the wire-format compression factor, independent of the ring's
    2(N-1)/N amplification), and the wire format (``comm``, e.g.
    ``"int8_block256"`` / ``"bfloat16"`` / None for raw).  The span's
    ``bytes`` field stays the logical payload.  Called by the host ring
    collectives at span close."""
    span = current_span()
    if span is None:
        return
    rec = recorder.get_recorder()
    if rec is None:
        return
    fields = {"wire_bytes": int(span.get("wire_bytes", 0)) + int(wire_bytes)}
    if raw_bytes is not None:
        fields["raw_wire_bytes"] = (int(span.get("raw_wire_bytes", 0))
                                    + int(raw_bytes))
    if comm is not None:
        fields["comm"] = comm
    rec.update_event(span, **fields)


def annotate_transport(rec, op: str, path: str, nbytes: int,
                       seconds: float) -> None:
    """Fold one transport leg into the enclosing span, or record it as a
    standalone ``transport`` event when no span is open (direct
    metrics-shim callers, ring helpers used standalone)."""
    span = current_span()
    if span is not None and span.get("outcome") == "pending":
        cur = span.get("path")
        rec.update_event(span,
                         path=path if cur in (None, path) else "mixed")
        return
    rec.record("transport", op, t0=time.monotonic_ns() - int(seconds * 1e9),
               path=path, bytes=int(nbytes))


# -- store tails --------------------------------------------------------------


def post_tail(store, rec: Optional["recorder.FlightRecorder"] = None) -> None:
    """Best-effort post of this rank's compact tail to the generation-scoped
    store key (one small SET; a flaky store degrades diagnostics, never the
    job)."""
    rec = rec if rec is not None else recorder.get_recorder()
    if rec is None or store is None:
        return
    pos = rec.last_position()
    if pos is None:
        return
    try:
        store.set(recorder.obs_key(rec.generation, rec.rank),
                  json.dumps(pos).encode())
    except Exception:
        pass


def fetch_tail(store, generation: int, rank: int) -> Optional[dict]:
    """The tail rank ``rank`` last posted, or None.  Works from disarmed
    processes too (the launcher's supervisor is never armed itself)."""
    if store is None:
        return None
    try:
        key = recorder.obs_key(generation, rank)
        # check-then-get: get() would block forever on a never-posted key.
        # The tiny check->get race only loses to the DELETE_PREFIX reaper,
        # which runs strictly after the generation is torn down.
        if not store.check(key):
            return None
        return json.loads(store.get(key).decode())
    except Exception:
        return None


def render_tail(tail: dict) -> str:
    """One-line human rendering of a posted tail."""
    op = tail.get("op", "?")
    what = (f"collective #{tail['coll']} {op}"
            if tail.get("coll") is not None else f"{tail.get('kind', '?')} {op}")
    site = f" at {tail['site']}" if tail.get("site") else ""
    role = f" role={tail['role']}" if tail.get("role") else ""
    return (f"{what} {tail.get('outcome', '?')}{site} "
            f"(event #{tail.get('seq', '?')} of {tail.get('events', '?')})"
            f"{role}")


def heartbeat_tick(store, step=None) -> None:
    """Per-beat hook from :class:`..resilience.heartbeat.Heartbeat`:
    record the beat and re-post this rank's tail so the store always holds
    a position at most one beat old."""
    rec = recorder.get_recorder()
    if rec is None:
        return
    rec.record("beat", "beat", step=step)
    post_tail(store, rec)


# -- crash-dump installation --------------------------------------------------

_prev_signal = {}
_prev_excepthook = None
_installed = False


def _on_signal(signum, frame):
    recorder.dump_now(f"signal:{signum}")
    prev = _prev_signal.get(signum)
    if callable(prev):
        prev(signum, frame)  # e.g. a Python-level preemption hook
    elif prev != signal.SIG_IGN:
        # SIG_DFL — or None (handler we could not introspect): a TERM must
        # terminate; swallowing it would leave a worker the supervisor
        # believes it killed
        os._exit(128 + signum)


def _on_exception(etype, exc, tb):
    recorder.dump_now(f"exception:{etype.__name__}")
    (_prev_excepthook or sys.__excepthook__)(etype, exc, tb)


def _on_dump_signal(signum, frame):
    # SIGUSR1 = "flush your flight recorder": the launcher sends it to
    # every still-alive worker on a failed round right before TERM, so
    # dumps land even where SIGTERM is owned at the C level (a raw
    # sigaction Python cannot chain)
    recorder.dump_now(f"signal:{signum}")


def request_dumps(targets, settle: Optional[float] = None) -> None:
    """Supervisor-side dump flush: SIGUSR1 each still-running worker, then
    wait (bounded) for its dump file to land before TERM goes out.

    The settle wait exists because the TERM that follows can be consumed
    at the C level and kill the process before the Python-level USR1
    handler ever ran: the race behind intermittently missing dumps.  Bounded by ``settle`` /
    ``TPU_DIST_OBS_DUMP_SETTLE`` (default 2 s) and skipped for ranks that
    already exited; the dump write is atomic (tmp+rename), so a file that
    exists is complete.

    ``targets``: iterable of ``(proc, dump_path)`` pairs, ``proc`` a
    ``subprocess.Popen`` (``poll()``/``send_signal()``).
    """
    def _mtime(path):
        try:
            return os.stat(path).st_mtime_ns
        except OSError:
            return None

    signaled = []
    for proc, path in targets:
        if proc.poll() is None:
            # snapshot BEFORE signaling: a previous incarnation's dump at
            # the same path (solo respawns share generation + rank) must
            # not satisfy the wait — we need a FRESH write, or the TERM
            # that follows re-opens the very race this settle closes
            signaled.append((proc, path, _mtime(path)))
            try:
                proc.send_signal(signal.SIGUSR1)
            except OSError:
                pass
    if not signaled:
        return
    if settle is None:
        try:
            settle = float(
                os.environ.get("TPU_DIST_OBS_DUMP_SETTLE", "2.0"))
        except ValueError:
            settle = 2.0
    deadline = time.monotonic() + settle
    while time.monotonic() < deadline:
        if all(proc.poll() is not None
               or (_mtime(path) is not None and _mtime(path) != before)
               for proc, path, before in signaled):
            return
        time.sleep(0.05)


def install_signal_handlers() -> None:
    """Install the dump signal handlers: SIGUSR1 (dump and continue — the
    launcher's pre-teardown flush request) and a chained SIGTERM handler
    (dump, then the previous disposition) for plain workers whose TERM is
    not claimed at the C level.  Called at rendezvous start.  Safe to call
    repeatedly; a no-op when disarmed or off the main thread (thread ranks
    of one process never raise here)."""
    if not recorder.enabled():
        return
    try:
        signal.signal(signal.SIGUSR1, _on_dump_signal)
        cur = signal.getsignal(signal.SIGTERM)
        if cur is None:
            # a C-level sigaction Python cannot introspect or chain: leave
            # SIGTERM alone (replacing it would break whoever owns it), and
            # the launcher's SIGUSR1 flush covers the dump
            return
        if cur is not _on_signal:
            _prev_signal[signal.SIGTERM] = cur
            signal.signal(signal.SIGTERM, _on_signal)
    except (ValueError, OSError):
        pass  # not the main thread / restricted environment


def install_from_env() -> Optional["recorder.FlightRecorder"]:
    """Arm the crash-dump paths if ``TPU_DIST_OBS`` is set (idempotent);
    returns the recorder or None.  Rendezvous and the role runtime call
    this for every worker; standalone scripts may call it directly."""
    global _installed, _prev_excepthook
    rec = recorder.get_recorder()
    if rec is None:
        return None
    if not _installed:
        _installed = True
        if sys.excepthook is not _on_exception:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _on_exception
        # clean runs dump too (force=False: never clobber a crash dump's
        # reason) so healthy timelines can be merged
        atexit.register(recorder.dump_now, "exit", False)
    install_signal_handlers()
    return rec
