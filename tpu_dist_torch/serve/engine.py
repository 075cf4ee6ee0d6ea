"""Slot-based continuous-batching decode engine — counterpart of
``tpu_dist/serve/engine.py``.

Where ``TransformerLM.generate()`` runs one batch to completion (every
sequence holds its row until the longest one finishes), the
:class:`SlotEngine` owns a fixed pool of ``num_slots`` KV-cache rows with
per-slot lengths and admits a new request into any free slot between decode
iterations, while the other slots keep decoding.

Two model methods drive the pool (``tpu_dist_torch/models/transformer.py``):

- ``prefill_into_slot``: one request's prompt, padded to a power-of-two
  bucket, fills ONE cache slot in a single forward; the other slots' rows
  are untouched.  Buckets keep the JAX package's rule (there they bound
  recompiles; here they keep the engine's admission behaviour the same).
- ``decode_step``: ONE batched iteration over the whole pool, each slot
  appending at its own length.  ``generate`` runs the same method, so
  serving output equals offline generation token for token.

The engine is driven from one thread (the scheduler's loop thread runs
``admit``/``step``); everything thread-sensitive (handles, queues) lives
in :mod:`tpu_dist_torch.serve.scheduler`.  ``torch.inference_mode`` is
thread-local, so the engine enters it in its own methods.  The pool and
every forward live on the model's device; the slot table lives on the
host.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import random
from ..ops._build import resolve_device
from ..utils.metrics import LatencyHistogram

__all__ = ["SlotEngine", "Request", "RequestHandle", "ServeError",
           "QueueFullError", "SchedulerDrainingError",
           "SchedulerClosedError", "DeadlineExceededError",
           "RequestCancelledError", "error_outcome", "sample_tokens",
           "sample_host"]


class ServeError(RuntimeError):
    """Base class for named serving-layer failures — every request the
    layer cannot complete fails with a subclass of this (never silently)."""


class QueueFullError(ServeError):
    """The admission queue is at capacity: the caller should shed load or
    retry after a backoff (the bounded queue IS the backpressure)."""


class SchedulerDrainingError(ServeError):
    """The scheduler is draining (preemption notice): it finishes in-flight
    requests but admits no new ones."""


class SchedulerClosedError(ServeError):
    """The scheduler shut down with this request still queued or decoding:
    the request did not complete, and this names why."""


class DeadlineExceededError(ServeError):
    """The request's ``deadline_ms`` passed before it finished: queued
    requests are shed before staging (they would be stale on arrival),
    decoding requests free their slot at the next iteration boundary —
    load shedding by deadline instead of latency collapse."""


class RequestCancelledError(ServeError):
    """The request was cancelled (client disconnect, or an explicit
    ``cancel`` frame) — its slot was freed at the next iteration boundary
    instead of decoding to ``max_new_tokens`` for nobody."""


def error_outcome(exc: BaseException) -> str:
    """The obs-span outcome string for a failed request.  Cancellation is
    a first-class outcome (``error:Cancelled``) rather than an exception
    class name — the span vocabulary of the JAX package's flight
    recorder."""
    if isinstance(exc, RequestCancelledError):
        return "error:Cancelled"
    return f"error:{type(exc).__name__}"


def _now() -> float:
    return time.perf_counter()


class RequestHandle:
    """Caller-side future for one request: the token stream plus terminal
    state.  Every submitted handle terminates — with ``done`` or with a
    named error — the layer never drops a request silently.

    Thread-safe.  ``wait_done(timeout)`` blocks for the terminal state and
    re-raises the captured error (deadline-bounded: a dead server turns
    into ``TimeoutError``, not a hang).  ``iter_tokens`` yields tokens as
    they stream in.
    """

    def __init__(self, req_id: int):
        self.id = req_id
        self._cv = threading.Condition()
        self._tokens: List[int] = []
        self._reason: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._cancel: Optional[Callable[[], None]] = None

    def cancel(self) -> None:
        """Request cancellation: the serving side frees the slot at the
        next iteration boundary and the handle terminates with
        :class:`RequestCancelledError`.  No-op when already terminal or
        when no cancel path is wired (bare handles)."""
        cb = self._cancel
        if cb is not None:
            cb()

    # -- producer side (engine/scheduler/client reader) ----------------------

    def _on_token(self, token: int) -> None:
        with self._cv:
            self._tokens.append(int(token))
            self._cv.notify_all()

    def _on_done(self, reason: str) -> None:
        with self._cv:
            self._reason = reason
            self._cv.notify_all()

    def _on_error(self, exc: BaseException) -> None:
        with self._cv:
            if self._reason is None and self._error is None:
                self._error = exc
            self._cv.notify_all()

    # -- consumer side -------------------------------------------------------

    @property
    def done(self) -> bool:
        with self._cv:
            return self._reason is not None or self._error is not None

    @property
    def reason(self) -> Optional[str]:
        """Terminal reason ('eos' | 'length'), None while running/failed."""
        with self._cv:
            return self._reason

    @property
    def error(self) -> Optional[BaseException]:
        with self._cv:
            return self._error

    def tokens(self) -> List[int]:
        """Snapshot of the tokens streamed so far."""
        with self._cv:
            return list(self._tokens)

    def wait_done(self, timeout: float) -> List[int]:
        """Block until the request terminates; returns the generated tokens
        or re-raises the named failure.  ``TimeoutError`` after ``timeout``
        seconds — never an unbounded hang."""
        deadline = _now() + timeout
        with self._cv:
            while self._reason is None and self._error is None:
                left = deadline - _now()
                if left <= 0:
                    raise TimeoutError(
                        f"request {self.id} not finished after "
                        f"{timeout:.1f}s ({len(self._tokens)} tokens so "
                        f"far)")
                self._cv.wait(left)
            if self._error is not None:
                raise self._error
            return list(self._tokens)

    def iter_tokens(self, timeout: float = 60.0):
        """Yield tokens as they stream in; raises the request's named error
        (or ``TimeoutError`` when ``timeout`` passes with no progress)."""
        i = 0
        while True:
            with self._cv:
                deadline = _now() + timeout
                while (i >= len(self._tokens) and self._reason is None
                       and self._error is None):
                    left = deadline - _now()
                    if left <= 0:
                        raise TimeoutError(
                            f"request {self.id}: no token progress in "
                            f"{timeout:.1f}s")
                    self._cv.wait(left)
                if i < len(self._tokens):
                    tok = self._tokens[i]
                else:
                    if self._error is not None:
                        raise self._error
                    return
            i += 1
            yield tok


class Request:
    """One decode request moving through the serving layer."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, prompt, max_new_tokens: int,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, req_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token: Optional[Callable] = None,
                 on_done: Optional[Callable] = None,
                 on_error: Optional[Callable] = None):
        self.id = req_id if req_id is not None else next(Request._ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.seed = int(seed)
        self.on_token = on_token
        self.on_done = on_done
        self.on_error = on_error
        self.t_submit = _now()
        # absolute monotonic deadline: past it the request is shed (if
        # still queued) or its slot freed at the next iteration boundary
        self.deadline: Optional[float] = (
            None if deadline_ms is None
            else self.t_submit + float(deadline_ms) / 1000.0)
        self.cancelled = False      # single-writer flag (GIL-safe)
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.emitted = 0
        self.staged = None          # the bucket-padded prompt on the device
        self.obs_span = None        # flight-recorder span

    def cancel(self) -> None:
        self.cancelled = True

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else _now()) >= self.deadline)

    def emit(self, token: int) -> None:
        self.emitted += 1
        if self.t_first is None:
            self.t_first = _now()
        if self.on_token is not None:
            self.on_token(self, int(token))

    def finish(self, reason: str) -> None:
        if self.on_done is not None:
            self.on_done(self, reason)

    def fail(self, exc: BaseException) -> None:
        if self.on_error is not None:
            self.on_error(self, exc)


def sample_tokens(logits, temps, keys, steps, sampling: bool):
    """Per-slot next token from (B, vocab) logits: greedy argmax at
    temperature 0, categorical at temperature > 0 from each slot's key
    folded by its step — ``generate``'s ``fold_in(key, step)`` schedule, so
    a request served alone with the same seed reproduces it.  ``temps``
    (B,) float32, ``keys`` (B, 2) and ``steps`` (B,) int64 are tensors on
    the logits' device; ``sampling`` False skips the sampling branch (the
    all-greedy pool)."""
    greedy = logits.argmax(-1)
    if not sampling:
        return greedy
    sampled = random.categorical(random.fold_in(keys, steps),
                                  logits / temps.clamp_min(1e-6)[:, None])
    return torch.where(temps > 0, sampled, greedy)


def sample_host(logits, temps, keys, steps) -> np.ndarray:
    """:func:`sample_tokens` over host arrays (``temps`` (B,) float32,
    ``keys`` (B, 2), ``steps`` (B,)), on the logits' device; the tokens on
    the host.  Every engine samples through this one function — a sharded
    group's ranks each sample their own tokens from identical logits."""
    sampling = bool(np.any(temps > 0))
    if sampling:
        temps, keys, steps = (torch.from_numpy(np.asarray(a)).to(
            logits.device) for a in (temps, keys, steps))
    return sample_tokens(logits, temps, keys, steps,
                         sampling).cpu().numpy()


def _bucket_lengths(max_prompt: int, min_bucket: int = 16) -> List[int]:
    """Power-of-two padded-prompt lengths up to ``max_prompt`` (always
    includes ``max_prompt`` itself)."""
    out = []
    b = min_bucket
    while b < max_prompt:
        out.append(b)
        b *= 2
    out.append(max_prompt)
    return out


class SlotEngine:
    """Fixed pool of ``num_slots`` KV-cache slots with per-slot lengths.

    Drive it from ONE thread (the scheduler loop): ``admit(request)``
    prefills a free slot between decode iterations, ``step()`` decodes
    every active slot one token.  EOS and per-request ``max_new_tokens``
    free slots immediately — the freed slot is admissible on the very next
    iteration.

    ``device``: where the engine runs, ``cuda`` unless the caller names
    another; the model's parameters must already be there.
    """

    def __init__(self, model, num_slots: int = 8,
                 max_len: Optional[int] = None, cache_dtype=None,
                 min_bucket: int = 16, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model's parameters are on {model.device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.num_slots = int(num_slots)
        self.max_len = int(max_len if max_len is not None
                           else model.max_seq_len)
        if self.max_len > model.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"max_seq_len {model.max_seq_len}")
        self.cache_dtype = cache_dtype or torch.float32
        self.buckets = _bucket_lengths(self.max_len, min_bucket)
        with torch.inference_mode():
            self.cache = model.init_slot_cache(self.num_slots, self.max_len,
                                               self.cache_dtype)

        # host-side slot table — THE source of truth for occupancy
        self.lengths = np.zeros(self.num_slots, np.int64)
        self.tokens = np.zeros(self.num_slots, np.int64)
        self.temps = np.zeros(self.num_slots, np.float32)
        self.keys = np.zeros((self.num_slots, 2), np.int64)
        self.steps = np.ones(self.num_slots, np.int64)
        self.active = np.zeros(self.num_slots, bool)
        self.slot_req: List[Optional[Request]] = [None] * self.num_slots
        self.reset_stats()
        self._build_programs()

    def _build_programs(self) -> None:
        """Bind the two pool operations: ``self._decode(tokens, lengths,
        cache)`` and ``self._prefill(prompt, length, slot, cache)``, each
        returning ``(logits, cache)``.  The tensor-parallel engine
        (:class:`~tpu_dist_torch.serve.sharded.ShardedSlotEngine`) overrides
        this ONE hook with its shard pipeline — every other line of slot
        bookkeeping is shared, so the engines cannot drift on admission or
        finish semantics."""
        self._decode = self.model.decode_step
        self._prefill = self.model.prefill_into_slot

    # -- introspection -------------------------------------------------------

    @property
    def fatal_error(self):
        """Non-None when the engine is unusable as a whole (not just one
        request): the scheduler checks it after a failed admit and shuts
        down with this cause instead of serving a dead pool.  The sharded
        engine reports its poisoned lockstep here."""
        return None

    def free_slots(self) -> int:
        return int(self.num_slots - self.active.sum())

    def active_count(self) -> int:
        return int(self.active.sum())

    def idle(self) -> bool:
        return not self.active.any()

    def occupancy(self) -> float:
        """Mean fraction of slots busy per decode step."""
        if self._decode_steps == 0:
            return 0.0
        return (self._occupied_slot_steps
                / (self._decode_steps * self.num_slots))

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the pool's "
                         f"max_len {self.max_len}")

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot capacity "
                f"({self.max_len})")

    def stage(self, req: Request):
        """Bucket-pad a request's prompt and copy it to the device — the
        work the scheduler's staging thread runs off the decode loop."""
        bucket = self.bucket_for(len(req.prompt))
        padded = np.zeros(bucket, np.int64)
        padded[:len(req.prompt)] = req.prompt
        req.staged = torch.from_numpy(padded).to(self.device)
        return req.staged

    # -- the two pool operations --------------------------------------------

    @torch.inference_mode()
    def admit(self, req: Request) -> int:
        """Prefill ``req`` into the lowest free slot and emit its first
        token.  Returns the slot index; raises ``RuntimeError`` when no
        slot is free (callers check :meth:`free_slots` first).  Cancelled or
        past-deadline requests are refused by name BEFORE the prefill."""
        slot = self._admission_slot(req)
        self._pre_admit(req, slot)
        return self._admit(req, slot)

    def _admission_slot(self, req: Request) -> int:
        """Every admission check and the slot choice (the lowest free one).
        Split from :meth:`_admit` so the sharded engine broadcasts its
        admission plan only after every refusal has passed: a follower must
        never prefill a slot the leader then refuses."""
        if req.cancelled:
            raise RequestCancelledError(
                f"request {req.id} was cancelled before admission")
        if req.expired():
            raise DeadlineExceededError(
                f"request {req.id} missed its deadline before admission "
                f"(deadline_ms elapsed in the queue) — shed")
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            raise RuntimeError("no free slot (check free_slots() first)")
        self.validate(len(req.prompt), req.max_new_tokens)
        return int(free[0])

    def _pre_admit(self, req: Request, slot: int) -> None:
        """Hook between the passed admission checks and the prefill — the
        sharded engine's plan broadcast point."""

    def _admit(self, req: Request, slot: int) -> int:
        """The unconditional half of admission: prefill and slot
        bookkeeping (every refusal already ruled out by
        :meth:`_admission_slot`)."""
        req.t_admit = _now()
        self.hist_queue.observe(req.t_admit - req.t_submit)
        staged = req.staged if req.staged is not None else self.stage(req)
        key = random.key(req.seed).numpy()
        logits, self.cache = self._prefill(
            staged, len(req.prompt), slot, self.cache)
        tok = int(sample_host(logits[None],
                              np.array([req.temperature], np.float32),
                              key[None], np.zeros(1, np.int64))[0])
        t_pf = _now()
        self.hist_prefill.observe(t_pf - req.t_admit)

        self.lengths[slot] = len(req.prompt)
        self.tokens[slot] = tok
        self.temps[slot] = req.temperature
        self.keys[slot] = key
        self.steps[slot] = 1
        self.active[slot] = True
        self.slot_req[slot] = req
        self._obs_admit(req, slot, t_pf)

        req.emit(tok)
        self.hist_ttft.observe(_now() - req.t_submit)
        self.generated_tokens += 1
        self._maybe_finish(slot, tok)
        return slot

    @torch.inference_mode()
    def step(self) -> int:
        """One decode iteration over the pool; returns tokens emitted."""
        if not self.active.any():
            return 0
        t0 = _now()
        logits, self.cache = self._decode(self.tokens, self.lengths,
                                          self.cache)
        nxt = sample_host(logits, self.temps, self.keys, self.steps)
        dt = _now() - t0
        n_active = int(self.active.sum())
        self._decode_steps += 1
        self._occupied_slot_steps += n_active
        self.hist_token.observe(dt)

        emitted = 0
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            self.lengths[slot] += 1
            self.steps[slot] += 1
            self.tokens[slot] = tok
            req.emit(tok)
            self.generated_tokens += 1
            emitted += 1
            self._maybe_finish(slot, tok)
        return emitted

    # -- completion / failure ------------------------------------------------

    def _maybe_finish(self, slot: int, token: int) -> None:
        req = self.slot_req[slot]
        if req.eos_id is not None and token == req.eos_id:
            self._finish(slot, "eos")
        elif req.emitted >= req.max_new_tokens:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        self._free(slot)
        self.completed += 1
        self.hist_e2e.observe(_now() - req.t_submit)
        self._obs_end(req, "ok", reason=reason)
        req.finish(reason)

    def fail_slot(self, slot: int, exc: BaseException) -> None:
        """Free a slot whose request failed; the request is notified with
        the named error (scheduler error paths)."""
        req = self.slot_req[slot]
        self._free(slot)
        if req is not None:
            self._obs_end(req, error_outcome(exc))
            req.fail(exc)

    def fail_all(self, exc: BaseException) -> None:
        for slot in np.flatnonzero(self.active):
            self.fail_slot(int(slot), exc)

    def sweep_expired(self) -> int:
        """Free slots whose requests were cancelled (client disconnect /
        explicit cancel) or ran past their ``deadline_ms`` — called by the
        scheduler loop at EVERY iteration boundary, so a cancelled request
        stops occupying a slot after at most one decode step.  The request
        terminates with the named error.  Returns the slots freed."""
        expired = self._sweep_candidates()
        if expired:
            self._pre_free([slot for slot, _ in expired])
        for slot, exc in expired:
            self.fail_slot(slot, exc)
        return len(expired)

    def _sweep_candidates(self) -> List[tuple]:
        """``(slot, named error)`` for every active slot whose request was
        cancelled or ran past its deadline — the decision half of
        :meth:`sweep_expired`, taken on this engine's clock only (the
        sharded leader broadcasts the slot list, so followers free the same
        slots without consulting their own clocks)."""
        expired = []
        now = _now()
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            req = self.slot_req[slot]
            if req is None:
                continue
            if req.cancelled:
                expired.append((slot, RequestCancelledError(
                    f"request {req.id} cancelled after {req.emitted} "
                    f"token(s); slot {slot} freed at the iteration "
                    f"boundary")))
            elif req.expired(now):
                expired.append((slot, DeadlineExceededError(
                    f"request {req.id} exceeded its deadline_ms after "
                    f"{req.emitted} token(s); slot {slot} freed at the "
                    f"iteration boundary")))
        return expired

    def _pre_free(self, slots: List[int]) -> None:
        """Hook before a sweep frees ``slots`` — the sharded engine's
        free-plan broadcast point."""

    def _free(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self.temps[slot] = 0.0
        self.slot_req[slot] = None

    # -- per-request obs spans ----------------------------------------------

    @staticmethod
    def obs_open(req: Request) -> None:
        """Open the request's flight-recorder span (armed runs only), at
        submit time so queue time is on the span from the start: a request
        stuck in the queue is still a named pending span."""
        from ..obs.recorder import call_site, get_recorder
        rec = get_recorder()
        if rec is None:
            return
        req.obs_span = rec.begin("serve", "request", req=req.id,
                                 prompt_len=int(len(req.prompt)),
                                 max_new_tokens=req.max_new_tokens,
                                 site=call_site())

    def _obs_admit(self, req: Request, slot: int, t_prefill_done) -> None:
        if req.obs_span is None:
            return
        from ..obs.recorder import get_recorder
        rec = get_recorder()
        if rec is None:
            return
        rec.update_event(
            req.obs_span, slot=slot,
            queue_ns=int((req.t_admit - req.t_submit) * 1e9),
            prefill_ns=int((t_prefill_done - req.t_admit) * 1e9))

    def _obs_end(self, req: Request, outcome: str, **fields) -> None:
        if req.obs_span is None:
            return
        from ..obs.recorder import get_recorder
        rec = get_recorder()
        if rec is None:
            return
        decode_ns = 0
        if req.t_first is not None:
            decode_ns = int((_now() - req.t_first) * 1e9)
        rec.end(req.obs_span, outcome=outcome, tokens=req.emitted,
                decode_ns=decode_ns, **fields)

    # -- aggregate stats -----------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the histograms/counters (benchmarks: exclude warm-up from
        the measured window).  Slot state is untouched."""
        self.hist_queue = LatencyHistogram()
        self.hist_prefill = LatencyHistogram()
        self.hist_ttft = LatencyHistogram()
        self.hist_token = LatencyHistogram()
        self.hist_e2e = LatencyHistogram()
        self.completed = 0
        self.generated_tokens = 0
        self._occupied_slot_steps = 0
        self._decode_steps = 0

    def stats(self) -> dict:
        return {
            "completed": self.completed,
            "generated_tokens": self.generated_tokens,
            "decode_steps": self._decode_steps,
            "occupancy": round(self.occupancy(), 4),
            "queue": self.hist_queue.summary(),
            "prefill": self.hist_prefill.summary(),
            "ttft": self.hist_ttft.summary(),
            "decode_step": self.hist_token.summary(),
            "e2e": self.hist_e2e.summary(),
        }
