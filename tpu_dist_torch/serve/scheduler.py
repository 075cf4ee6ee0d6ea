"""Admission scheduler — counterpart of ``tpu_dist/serve/scheduler.py``,
the thread layer between frontends and the engine.

Requests land in a bounded admission queue; a background *staging* thread
bucket-pads each prompt and copies it to the device (input prep overlaps
the decode loop instead of stalling it); the *loop* thread drives the
:class:`~tpu_dist_torch.serve.engine.SlotEngine` — admit
staged requests into free slots between decode iterations, then run one
``decode_step`` over the pool.

Admission coalescing: when the engine is IDLE and a request arrives, the
loop holds admission for up to ``batch_window`` seconds so closely-spaced
arrivals prefill as one admission group instead of paying a lone-slot
decode step each.  While slots are decoding there is nothing to wait
for — new arrivals are admitted at the next iteration boundary for free.

Every blocking wait in this module is deadline-bounded: a dead engine
thread or a stuck queue turns into a named timeout, never a silent hang.
Every request that cannot complete fails with a named ``ServeError``
subclass (:mod:`tpu_dist_torch.serve.engine`) — on ``close()`` the queued
and in-flight requests are failed with ``SchedulerClosedError``, not
dropped.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from .engine import (DeadlineExceededError, QueueFullError, Request,
                     RequestCancelledError, RequestHandle,
                     SchedulerClosedError, SchedulerDrainingError,
                     SlotEngine, error_outcome)

__all__ = ["Scheduler"]


def _now() -> float:
    return time.perf_counter()


class Scheduler:
    """Owns the admission queue, the staging thread, and the decode loop.

    ``submit()`` is thread-safe (frontends call it from per-connection
    reader threads) and returns a :class:`RequestHandle` that ALWAYS
    terminates — tokens then ``done``, or a named error.  ``drain()``
    implements the preemption protocol: stop admitting, finish in-flight
    decodes, report when empty.
    """

    def __init__(self, engine: SlotEngine, batch_window: float = 0.004,
                 max_pending: int = 4096, stage_depth: int = 16,
                 step_hook: Optional[Callable[[int], None]] = None):
        self.engine = engine
        self.batch_window = float(batch_window)
        self.step_hook = step_hook
        self._pending: "queue.Queue[Request]" = queue.Queue(max_pending)
        self._staged: "queue.Queue[Request]" = queue.Queue(stage_depth)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._idle_cv = threading.Condition()
        self._steps = 0
        self._fatal: Optional[BaseException] = None
        self._stage_thread = threading.Thread(
            target=self._stage_loop, daemon=True,
            name="tpu_dist_torch-serve-stage")
        self._loop_thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name="tpu_dist_torch-serve-loop")
        self._stage_thread.start()
        self._loop_thread.start()

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: int = 0, req_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable] = None,
               on_done: Optional[Callable] = None,
               on_error: Optional[Callable] = None,
               timeout: float = 5.0) -> RequestHandle:
        """Queue one request; returns its handle (stream + terminal state).

        ``deadline_ms`` is an end-to-end budget from submit: a request
        still queued past it is shed by name before staging, one still
        decoding frees its slot at the next iteration boundary — both
        terminate the handle with :class:`DeadlineExceededError`.  The
        handle's :meth:`~tpu_dist_torch.serve.engine.RequestHandle.cancel`
        releases the slot the same way (``RequestCancelledError``).

        Raises :class:`SchedulerDrainingError` while draining,
        :class:`SchedulerClosedError` after close, :class:`QueueFullError`
        when the admission queue stays full for ``timeout`` seconds (the
        bounded queue is the backpressure), and ``ValueError`` for
        requests that can never fit the slot capacity."""
        if self._stop.is_set():
            raise self._closed_error()
        if self._draining.is_set():
            raise SchedulerDrainingError(
                "scheduler is draining (preemption): in-flight requests "
                "finish, new ones are not admitted")
        self.engine.validate(len(prompt), max_new_tokens)
        handle = RequestHandle(req_id if req_id is not None else 0)

        def _tok(req, token):
            handle._on_token(token)
            if on_token is not None:
                on_token(req, token)

        def _done(req, reason):
            handle._on_done(reason)
            if on_done is not None:
                on_done(req, reason)

        def _err(req, exc):
            handle._on_error(exc)
            if on_error is not None:
                on_error(req, exc)

        req = Request(prompt, max_new_tokens, temperature=temperature,
                      eos_id=eos_id, seed=seed, req_id=req_id,
                      deadline_ms=deadline_ms,
                      on_token=_tok, on_done=_done, on_error=_err)
        handle.id = req.id
        handle._cancel = req.cancel  # frees the slot at the next boundary
        SlotEngine.obs_open(req)
        try:
            self._pending.put(req, timeout=timeout)
        except queue.Full:
            exc = QueueFullError(
                f"admission queue full ({self._pending.maxsize} pending); "
                f"shed load or retry")
            self.engine._obs_end(req, error_outcome(exc))
            raise exc
        if self._stop.is_set():
            # close() may have drained the queues while this put was
            # blocked in the backpressure wait — the request would land in
            # a queue nobody reads.  Fail it by name (idempotent if the
            # close-side drain already did) and refuse the submit.
            exc = self._closed_error()
            self.engine._obs_end(req, error_outcome(exc))
            req.fail(exc)
            raise exc
        return handle

    def _closed_error(self) -> SchedulerClosedError:
        if self._fatal is not None:
            return SchedulerClosedError(
                f"scheduler is closed: the decode loop died with "
                f"{type(self._fatal).__name__}: {self._fatal}")
        return SchedulerClosedError("scheduler is closed")

    # -- preemption drain ----------------------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop admitting; True once the queue is empty and every in-flight
        decode finished (False if ``timeout`` expired first).  Queued
        requests that were never admitted are failed with
        :class:`SchedulerDrainingError` — named, not dropped."""
        self._draining.set()
        deadline = _now() + timeout
        while _now() < deadline:
            if self._quiesced():
                return True
            with self._idle_cv:
                self._idle_cv.wait(0.05)
        return self._quiesced()

    def _quiesced(self) -> bool:
        """No request anywhere in the pipeline.  ``unfinished_tasks``
        (decremented by ``task_done`` only after a pop is fully handled)
        rather than ``empty()``: a request in the staging thread's HANDS —
        popped from pending, not yet placed — is in neither queue, and
        ``empty()`` would let ``drain()`` report quiesced while it is
        about to surface."""
        return (self._pending.unfinished_tasks == 0
                and self._staged.unfinished_tasks == 0
                and self.engine.idle())

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def fatal(self) -> Optional[BaseException]:
        """The error that killed the decode loop, or None while healthy.
        A serving worker polls this: a fatal engine death must turn into a
        nonzero exit, not a zombie frontend refusing every submit."""
        return self._fatal

    def snapshot(self) -> dict:
        """Queue-side load counters for the wire ``stats`` frame (engine
        aggregates ride :meth:`SlotEngine.stats`)."""
        return {"pending": self._pending.qsize(),
                "staged": self._staged.qsize(),
                "draining": self._draining.is_set(),
                "steps": self._steps}

    @property
    def steps(self) -> int:
        """Decode iterations run so far (heartbeat progress feed)."""
        return self._steps

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop both threads; every request still queued or decoding fails
        with :class:`SchedulerClosedError`."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._loop_thread.join(timeout)
        self._stage_thread.join(timeout)
        exc = SchedulerClosedError("scheduler closed with the request "
                                   "still pending")
        self.engine.fail_all(exc)
        self._fail_queued(exc, count=False)

    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- background threads --------------------------------------------------

    def _stage_loop(self) -> None:
        while not self._stop.is_set():
            try:
                req = self._pending.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                shed = self._shed_stale(req)
                if shed is not None:
                    self.engine._obs_end(req, error_outcome(shed))
                    req.fail(shed)
                    continue
                try:
                    self.engine.stage(req)
                except Exception as e:   # bad request: not a stage killer
                    self.engine._obs_end(req, error_outcome(e))
                    req.fail(e)
                    continue
                placed = False
                while not self._stop.is_set():
                    try:
                        self._staged.put(req, timeout=0.1)
                        placed = True
                        break
                    except queue.Full:
                        continue
                if not placed:
                    # shutdown caught the request in this thread's hands —
                    # it still terminates with the named error, never
                    # silently
                    exc = self._closed_error()
                    self.engine._obs_end(req, error_outcome(exc))
                    req.fail(exc)
            finally:
                # the pending pop is fully handled (staged OR failed) —
                # this is what lets drain()'s quiesced predicate see a
                # request that is in this thread's hands
                self._pending.task_done()
        if self._fatal is not None:
            # the loop thread died mid-flight: it swept the queues, but a
            # put of ours may have raced past that sweep — as the ONLY
            # producer into _staged, our exit sweep is the last word
            self._fail_queued(self._closed_error(), count=False)

    def _shed_stale(self, req: Request):
        """The named shed error for a queued request that should never
        reach the engine (cancelled, or past its deadline), else None."""
        if req.cancelled:
            return RequestCancelledError(
                f"request {req.id} cancelled while queued — shed before "
                f"staging")
        if req.expired():
            return DeadlineExceededError(
                f"request {req.id} spent its whole deadline_ms in the "
                f"admission queue — shed before staging (overload)")
        return None

    def _drain_failed(self, req: Request) -> None:
        exc = SchedulerDrainingError("request rejected: scheduler started "
                                     "draining before it was admitted")
        self.engine._obs_end(req, error_outcome(exc))
        req.fail(exc)

    def _reject_queued(self) -> None:
        """Drain mode: everything accepted but not yet admitted fails with
        a NAMED error (clients resubmit elsewhere); in-flight slots finish."""
        for q in (self._staged, self._pending):
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                self._drain_failed(req)
                q.task_done()

    def _fail_queued(self, exc: BaseException, count: bool = True) -> None:
        """Terminal sweep: fail everything still queued with ``exc``.
        ``count=False`` on post-stop sweeps — double-failing a handle is
        idempotent, but a second ``task_done`` for one pop would raise."""
        for q in (self._staged, self._pending):
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                self.engine._obs_end(req, error_outcome(exc))
                req.fail(exc)
                if count:
                    q.task_done()

    def _admit(self, req: Request) -> None:
        try:
            self.engine.admit(req)
        except Exception as e:   # a bad request must not kill the loop
            self.engine._obs_end(req, error_outcome(e))
            req.fail(e)
            fatal = getattr(self.engine, "fatal_error", None)
            if fatal is not None:
                # the failure poisoned the ENGINE, not just the request (a
                # sharded leader whose admit plan went out before its
                # prefill died): shut down with the cause — the loop's
                # epilogue fails everything by name, as after a fatal step
                self._fatal = fatal
                self._stop.set()
        finally:
            self._staged.task_done()

    def _sweep_once(self) -> bool:
        """One expiry sweep; False = fatal engine death (stop set): a
        failing sweep takes the same cause-naming shutdown as a fatal
        ``step()``, never kills the loop thread silently."""
        try:
            self.engine.sweep_expired()
        except Exception as e:
            self._fatal = e
            self._stop.set()
            return False
        return True

    def _step_once(self) -> bool:
        """One decode iteration; False = fatal engine death (stop set)."""
        try:
            self.engine.step()
        except Exception as e:
            # a dead engine (a device error mid-decode) strands every
            # request: record the cause, stop
            # the scheduler, and fail everything BY NAME in the epilogue —
            # a zombie loop accepting submits it can never serve is the
            # one shape this layer forbids
            self._fatal = e
            self._stop.set()
            return False
        self._steps += 1
        if self.step_hook is not None:
            try:
                self.step_hook(self._steps)
            except Exception:
                pass
        with self._idle_cv:
            self._idle_cv.notify_all()
        return True

    def _run_loop(self) -> None:
        held = []            # staged requests inside the coalescing window
        window_start = None
        while not self._stop.is_set():
            if self._draining.is_set():
                # drain mode: NOTHING new reaches the engine — reject the
                # window + both queues by name (including anything the
                # staging thread surfaces later), and only finish the
                # slots already decoding
                for req in held:
                    self._drain_failed(req)
                    self._staged.task_done()
                held, window_start = [], None
                self._reject_queued()
                # cancelled slots free even while draining — the drain
                # must not wait on them
                if not self._sweep_once():
                    break
                if not self.engine.idle():
                    if not self._step_once():
                        break
                else:
                    with self._idle_cv:
                        self._idle_cv.notify_all()
                    time.sleep(0.01)
                continue
            # -- the iteration boundary: cancelled / past-deadline slots
            # free HERE, before admission sees the free-slot count — a
            # disconnected client's request stops costing decode steps
            # after at most one iteration
            if not self._sweep_once():
                break
            # -- pull staged arrivals (never beyond the free slots) ----------
            while len(held) < self.engine.free_slots():
                try:
                    held.append(self._staged.get_nowait())
                except queue.Empty:
                    break
            if held and window_start is None:
                window_start = _now()
            busy = not self.engine.idle()
            window_over = window_start is not None and (
                _now() - window_start >= self.batch_window
                or len(held) >= self.engine.free_slots())
            # -- admission, between decode iterations ------------------------
            # a busy pool admits immediately (the iteration boundary IS the
            # batching point); an idle pool holds the first prefill for up
            # to batch_window so closely-spaced arrivals group up
            if held and (busy or window_over or self.batch_window <= 0):
                for req in held:
                    self._admit(req)
                held, window_start = [], None
                busy = not self.engine.idle()
            # -- one decode iteration over the pool --------------------------
            if busy:
                if not self._step_once():
                    break
            elif held:
                # inside the coalescing window: short bounded nap
                time.sleep(min(self.batch_window / 4, 0.002))
            else:
                with self._idle_cv:
                    self._idle_cv.notify_all()
                try:
                    held.append(self._staged.get(timeout=0.05))
                    window_start = _now()
                except queue.Empty:
                    pass
        # loop exit: requests still held in the window are not dropped
        exc = self._closed_error()
        for req in held:
            self.engine._obs_end(req, error_outcome(exc))
            req.fail(exc)
            self._staged.task_done()
        if self._fatal is not None:
            # fatal engine death: close() early-returns once _stop is set,
            # so THIS thread owns the terminal sweep — decoding slots and
            # queued requests all fail with the cause-naming error (the
            # stage thread's exit sweep catches a racing late put)
            self.engine.fail_all(exc)
            self._fail_queued(exc)
            with self._idle_cv:
                self._idle_cv.notify_all()
