"""Disaggregated prefill/decode serving over the role-graph runtime —
counterpart of ``tpu_dist/serve/disagg.py``.

Prefill is compute-bound and bursty; decode is latency-bound and steady.
The unified :class:`~tpu_dist_torch.serve.SlotEngine` runs both in one slot
pool, so a prompt burst stalls every in-flight decode behind its prefills.
This module splits the phases into separate role groups over
:mod:`tpu_dist_torch.roles`:

- **decode** ranks own requests end to end: the frontend submits to a
  decode rank's :class:`DisaggScheduler`, which queues the request locally
  AND publishes a compact *prefill descriptor* on the shared ``prefill-q``
  typed channel (an MPMC queue: claim order is the prefill queue).
- **prefill** ranks (:class:`PrefillWorker`) claim descriptors, run the
  bucket-padded prefill on their card — through the shared
  :class:`~tpu_dist_torch.serve.PrefixCache` when the prompt's prefix is
  cached, so only the suffix runs the forward — sample the request's FIRST
  token with the engine's sampling, and ship the KV rows to the owning
  decode rank with :class:`~tpu_dist_torch.serve.KVTransfer` (card → host →
  CRC-sealed data-plane fragments).  A small arrival envelope on the
  per-decode-rank ``kv{d}`` channel names the request and the sender.
- the decode rank's :class:`DisaggSlotEngine` lands arrived rows in a free
  slot's cache rows (host → card, :func:`~tpu_dist_torch.models.
  transformer.write_slot_rows`, no re-prefill) **between decode
  iterations** — admission stays iteration-boundary and occupancy-driven,
  since every line of slot bookkeeping is the unified engine's.

Token parity: the prefill worker pads prompts to the same power-of-two
buckets, samples with the same key schedule, and ships the TRUE ``length``
KV columns — so greedy disaggregated output is ``generate()``'s, prefix-
cache hits included (on the card a hit's suffix-only forward runs other
matmul shapes than the full prefill: equal but for ties).

Failure taxonomy: a dead prefill rank while a request waits for its KV
surfaces in ``stage()`` as a bounded timeout → the descriptor is
re-dispatched ONCE (another prefill rank, or the restarted one, claims it)
→ a second miss raises :class:`~tpu_dist_torch.serve.KVTransferError`
naming the request.  ``TPU_DIST_KV_TIMEOUT`` sets the deadline (30 s).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import random
from ..collectives import _lowp
from ..models.transformer import write_slot_rows
from ..ops._build import resolve_device
from ..utils.metrics import LatencyHistogram
from .engine import Request, ServeError, SlotEngine, _bucket_lengths, \
    sample_host
from .kvtransfer import KVTransfer, KVTransferError
from .scheduler import Scheduler

__all__ = ["ROLE_PREFILL", "ROLE_DECODE", "PREFILL_QUEUE", "kv_channel",
           "disagg_graph", "DisaggError", "DisaggSlotEngine",
           "DisaggScheduler", "PrefillWorker"]

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
PREFILL_QUEUE = "prefill-q"


def kv_channel(decode_role_rank: int) -> str:
    """Arrival-envelope channel name for one decode rank (decode role-rank
    ``d`` consumes ``kv{d}``)."""
    return f"kv{int(decode_role_rank)}"


def _now() -> float:
    return time.perf_counter()


def kv_timeout_default() -> float:
    """Per-transfer deadline (seconds); ``TPU_DIST_KV_TIMEOUT`` tunes it."""
    return float(os.environ.get("TPU_DIST_KV_TIMEOUT", "") or 30.0)


class DisaggError(ServeError):
    """Disaggregated-serving configuration or wiring failure (role spans,
    cache dtype, descriptor drift) — named before any traffic moves."""


def disagg_graph(n_prefill: int, n_decode: int, queue_depth: int = 64,
                 restart_prefill: str = "solo",
                 restart_decode: str = "gang"):
    """The canonical disaggregated role graph: ``prefill`` ranks restart
    solo (a lost prefill loses only its in-flight prompts, which
    re-dispatch), ``decode`` ranks as a gang (their pools hold live request
    state).  Channels: one shared ``prefill-q`` descriptor queue and one
    ``kv{d}`` arrival-envelope queue per decode rank."""
    from ..roles import ChannelSpec, Role, RoleGraph

    if n_prefill < 1 or n_decode < 1:
        raise DisaggError(f"disagg needs >=1 prefill and >=1 decode rank, "
                          f"got prefill:{n_prefill} decode:{n_decode}")
    roles = [Role(ROLE_PREFILL, n_prefill, restart=restart_prefill),
             Role(ROLE_DECODE, n_decode, restart=restart_decode)]
    channels = [ChannelSpec(PREFILL_QUEUE, src=ROLE_DECODE,
                            dst=ROLE_PREFILL, depth=queue_depth)]
    # drain="dedicated": the decode rank's receive thread drains the kv
    # queues even while its dispatch thread is blocked putting on
    # prefill-q, which keeps the prefill <-> decode channel cycle free of
    # deadlock (the graph verifier excludes such edges from wait-for
    # cycles)
    channels += [ChannelSpec(kv_channel(d), src=ROLE_PREFILL,
                             dst=ROLE_DECODE, depth=queue_depth,
                             drain="dedicated")
                 for d in range(n_decode)]
    return RoleGraph(roles, channels)


# ---------------------------------------------------------------------------
# decode side
# ---------------------------------------------------------------------------

class DisaggSlotEngine(SlotEngine):
    """The decode role's slot engine: admission writes TRANSFERRED KV rows
    into the slot instead of running a prefill.

    Every line of slot bookkeeping (occupancy, sweep, finish, stats) is
    :class:`SlotEngine`'s; the overridden pieces:

    - :meth:`dispatch` and a dispatcher thread: publish prefill descriptors
      on ``prefill-q`` (channel endpoints are one-per-thread, so callers
      enqueue to a host outbox instead of touching the endpoint);
    - a receiver thread: arrival envelope from ``kv{d}`` → blocking
      :meth:`KVTransfer.fetch` → the arrival lands in ``_arrived``;
    - :meth:`stage` (the scheduler's STAGING thread, so the decode loop
      never blocks on the wire): wait for the request's arrival under a
      bounded deadline, re-dispatch once on a miss, then fail by name; copy
      the rows to the card;
    - :meth:`_admit`: :func:`write_slot_rows` into the slot and the parent's
      slot bookkeeping; the first token was sampled on the prefill rank.

    ``model``: the decode rank's full ``TransformerLM`` (its cache layout
    and its decode step).  An int8 slot cache works end to end: the
    prefill rank runs its forward with the same cache dtype, and the int8
    k/v travel with their float32 scales as ordinary fragments."""

    def __init__(self, model, kv: KVTransfer, dispatch_ch, arrive_ch,
                 num_slots: int = 8, max_len: Optional[int] = None,
                 cache_dtype=None, min_bucket: int = 16,
                 kv_timeout: Optional[float] = None,
                 rank: Optional[int] = None, role_rank: int = 0,
                 device=None):
        super().__init__(model, num_slots=num_slots, max_len=max_len,
                         cache_dtype=cache_dtype, min_bucket=min_bucket,
                         device=device)
        self.kv = kv
        self.rank = int(rank if rank is not None else kv.dp.rank)
        self.role_rank = int(role_rank)
        self.kv_timeout = float(kv_timeout if kv_timeout is not None
                                else kv_timeout_default())
        self._dispatch_ch = dispatch_ch
        self._arrive_ch = arrive_ch
        self._cv = threading.Condition()
        self._arrived: Dict[int, object] = {}     # rid -> arrival | exc
        self._descs: Dict[int, tuple] = {}        # rid -> (desc, t_dispatch)
        self._outbox: "queue.Queue[dict]" = queue.Queue()
        self._stop = threading.Event()
        self._fatal: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="tpu_dist_torch-disagg-dispatch"),
            threading.Thread(target=self._recv_loop, daemon=True,
                             name="tpu_dist_torch-disagg-recv")]
        for t in self._threads:
            t.start()

    @property
    def fatal_error(self):
        return self._fatal

    # -- dispatch (submit side -> prefill-q) ----------------------------------

    def dispatch(self, desc: dict) -> None:
        """Queue one prefill descriptor for publication (thread-safe; the
        dispatcher thread owns the channel endpoint)."""
        with self._cv:
            self._descs[int(desc["id"])] = (desc, _now())
        self._outbox.put(desc)

    def _dispatch_loop(self) -> None:
        from ..obs.recorder import safe_record
        from ..roles.channel import ChannelError
        while not self._stop.is_set():
            try:
                desc = self._outbox.get(timeout=0.1)
            except queue.Empty:
                self._gc_arrivals()
                continue
            while not self._stop.is_set():
                try:
                    self._dispatch_ch.put(desc, timeout=2.0)
                    safe_record("plan", "dispatch", req=int(desc["id"]))
                    break
                except TimeoutError:
                    continue            # backpressured: keep trying
                except ChannelError:
                    # every prefill rank down or closed RIGHT NOW; a solo
                    # restart re-attaches by name, so retry after a beat —
                    # the waiting request's stage() deadline bounds this
                    time.sleep(0.25)
                except Exception as e:
                    self._fatal = e
                    with self._cv:
                        self._cv.notify_all()
                    return

    def _gc_arrivals(self) -> None:
        """Drop arrivals and descriptors nobody will claim (their request
        was shed before staging) — bounded by ~2x the transfer deadline."""
        horizon = 2.0 * self.kv_timeout + 30.0
        now = _now()
        with self._cv:
            stale = [rid for rid, (_, t) in self._descs.items()
                     if now - t > horizon]
            for rid in stale:
                self._descs.pop(rid, None)
                self._arrived.pop(rid, None)

    # -- arrivals (kv{d} envelope -> KVTransfer.fetch) ------------------------

    def _recv_loop(self) -> None:
        from ..obs.recorder import safe_record
        from ..roles.channel import ChannelClosedError, ChannelPeerGoneError
        while not self._stop.is_set():
            try:
                env = self._arrive_ch.get(timeout=1.0)
            except TimeoutError:
                continue
            except ChannelClosedError:
                return
            except ChannelPeerGoneError:
                time.sleep(0.25)        # prefill restarts solo; re-poll
                continue
            except Exception as e:
                if not self._stop.is_set():
                    self._fatal = e
                    with self._cv:
                        self._cv.notify_all()
                return
            rid, src = int(env["rid"]), int(env["src"])
            try:
                arrival = self.kv.fetch(src, rid, self.kv_timeout)
                arrival["t_arrive"] = _now()
                arrival["src"] = src
            except Exception as e:
                arrival = e             # stage() re-raises it by name
            safe_record("plan", "arrive", req=rid,
                        outcome=("ok" if not isinstance(arrival, Exception)
                                 else f"error:{type(arrival).__name__}"))
            with self._cv:
                self._arrived[rid] = arrival
                self._cv.notify_all()

    # -- staging (scheduler staging thread) -----------------------------------

    def stage(self, req: Request):
        """Wait for ``req``'s KV arrival (bounded), re-dispatch once on a
        miss, then copy the rows to the card.  Replaces the unified
        engine's staging — same thread, same 'off the decode loop'
        discipline."""
        rid = int(req.id)
        deadline = _now() + self.kv_timeout
        redispatched = False
        with self._cv:
            while True:
                arrival = self._arrived.pop(rid, None)
                if arrival is not None:
                    entry = self._descs.pop(rid, None)
                    break
                if self._fatal is not None:
                    raise KVTransferError(
                        f"request {rid}: disagg transfer plane died: "
                        f"{type(self._fatal).__name__}: "
                        f"{self._fatal}") from self._fatal
                if req.cancelled or req.expired():
                    self._descs.pop(rid, None)
                    raise KVTransferError(
                        f"request {rid} cancelled/expired while waiting "
                        f"for its KV transfer")
                left = deadline - _now()
                if left <= 0:
                    entry = self._descs.get(rid)
                    if entry is not None and not redispatched:
                        # the claiming prefill rank is presumed dead: put
                        # the descriptor back on the queue ONCE so a
                        # surviving (or restarted) rank picks it up
                        redispatched = True
                        self.redispatches += 1
                        self._outbox.put(entry[0])
                        deadline = _now() + self.kv_timeout
                        continue
                    self._descs.pop(rid, None)
                    raise KVTransferError(
                        f"request {rid}: no KV arrival within "
                        f"{self.kv_timeout:.1f}s"
                        + (" (after one re-dispatch)" if redispatched
                           else "")
                        + " — prefill rank dead or overloaded "
                          "(TPU_DIST_KV_TIMEOUT tunes the deadline)")
                self._cv.wait(min(left, 0.1))
        if isinstance(arrival, BaseException):
            raise KVTransferError(
                f"request {rid}: KV transfer failed: "
                f"{type(arrival).__name__}: {arrival}") from arrival
        if arrival["length"] != len(req.prompt):
            raise DisaggError(
                f"request {rid}: transferred KV covers "
                f"{arrival['length']} tokens but the prompt has "
                f"{len(req.prompt)} — descriptor/transfer drift")
        if entry is not None:
            arrival["t_dispatch"] = entry[1]
        arrival["rows"] = {
            path: {k: _lowp.to_torch(a, self.device) for k, a in e.items()}
            for path, e in arrival["rows"].items()}
        req.staged = arrival
        return req.staged

    # -- admission: write the rows instead of prefilling ----------------------

    def _admit(self, req: Request, slot: int) -> int:
        arrival = req.staged
        if not isinstance(arrival, dict) or "rows" not in arrival:
            raise DisaggError(f"request {req.id} reached disagg admission "
                              f"without a staged KV arrival")
        req.t_admit = _now()
        self.hist_queue.observe(req.t_admit - req.t_submit)
        key = random.key(req.seed).numpy()
        write_slot_rows(self.cache, arrival["rows"], slot)
        tok = int(arrival["first_tok"])
        t_pf = _now()
        # phase split: `prefill` is the REMOTE compute (shipped in the meta
        # frame), `transfer` the dispatch -> arrival wall time
        self.hist_prefill.observe(arrival["prefill_ns"] * 1e-9)
        desc_t = arrival.get("t_dispatch")
        xfer = (arrival["t_arrive"] - desc_t if desc_t is not None
                else t_pf - req.t_submit)
        self.hist_transfer.observe(xfer)
        self.transfers += 1
        if arrival["prefix_hit"] > 0:
            self.prefix_hits += 1
            self.prefix_tokens_saved += int(arrival["prefix_hit"])
        else:
            self.prefix_misses += 1

        self.lengths[slot] = len(req.prompt)
        self.tokens[slot] = tok
        self.temps[slot] = req.temperature
        self.keys[slot] = key
        self.steps[slot] = 1
        self.active[slot] = True
        self.slot_req[slot] = req
        self._obs_admit(req, slot, t_pf)
        self._obs_transfer(req, arrival, xfer)

        req.emit(tok)
        self.hist_ttft.observe(_now() - req.t_submit)
        self.generated_tokens += 1
        self._maybe_finish(slot, tok)
        return slot

    def _obs_transfer(self, req: Request, arrival: dict,
                      xfer: float) -> None:
        if req.obs_span is None:
            return
        from ..obs.recorder import get_recorder
        rec = get_recorder()
        if rec is None:
            return
        rec.update_event(req.obs_span, kv_src=int(arrival.get("src", -1)),
                         kv_bytes=int(arrival.get("bytes", 0)),
                         transfer_ns=int(xfer * 1e9),
                         prefix_hit=int(arrival.get("prefix_hit", 0)))

    # -- stats / lifecycle ----------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        out["transfer"] = self.hist_transfer.summary()
        out["kv"] = {"transfers": self.transfers,
                     "redispatches": self.redispatches,
                     "bytes_in": int(self.kv.fetched_bytes)}
        out["prefix_cache"] = {"hits": self.prefix_hits,
                               "misses": self.prefix_misses,
                               "tokens_saved": self.prefix_tokens_saved}
        return out

    def reset_stats(self) -> None:
        super().reset_stats()
        self.hist_transfer = LatencyHistogram()
        self.transfers = 0
        self.redispatches = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0

    def close(self) -> None:
        """Stop the dispatcher and receiver threads (idempotent).  Call
        after the scheduler is closed; the channel endpoints stay owned by
        their threads until this returns."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(5.0)


class DisaggScheduler(Scheduler):
    """The unified :class:`Scheduler` with dispatch at submit: every
    accepted request ALSO publishes its prefill descriptor, so prefill
    ranks start while the request waits for a slot.  The engine must be a
    :class:`DisaggSlotEngine`."""

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: int = 0, req_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable] = None,
               on_done: Optional[Callable] = None,
               on_error: Optional[Callable] = None,
               timeout: float = 5.0):
        handle = super().submit(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            eos_id=eos_id, seed=seed, req_id=req_id,
            deadline_ms=deadline_ms, on_token=on_token, on_done=on_done,
            on_error=on_error, timeout=timeout)
        self.engine.dispatch({
            "id": int(handle.id),
            "prompt": np.asarray(prompt, np.int32).tolist(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "eos_id": None if eos_id is None else int(eos_id),
            "seed": int(seed),
            "dst": self.engine.rank,
            "dst_rr": self.engine.role_rank,
        })
        return handle


# ---------------------------------------------------------------------------
# prefill side
# ---------------------------------------------------------------------------

class PrefillWorker:
    """One prefill rank: claim descriptors from ``prefill-q``, prefill
    (through the prefix cache when it hits) on the model's device, ship the
    KV rows and the first token to the owning decode rank.

    Parity contract: prompts pad to the unified engine's power-of-two
    buckets (``min_bucket`` must match the decode pool's), the first token
    comes from the engine's sampling and key schedule, and a prefix-cache
    hit prefills only the suffix at its true positions."""

    def __init__(self, model, kv: KVTransfer, claim_ch,
                 env_chans: Dict[int, object], rank: Optional[int] = None,
                 max_len: Optional[int] = None, dtype=None,
                 min_bucket: int = 16, prefix=None):
        self.model = model
        self.kv = kv
        self.claim_ch = claim_ch
        self.env_chans = dict(env_chans)
        self.rank = int(rank if rank is not None else kv.dp.rank)
        self.max_len = int(max_len if max_len is not None
                           else model.max_seq_len)
        self.dtype = dtype or torch.float32
        self.buckets = _bucket_lengths(self.max_len, min_bucket)
        self.prefix = prefix
        self.device = resolve_device(model.device)
        self.claims = 0
        self.errors = 0
        self.prefilled_tokens = 0   # tokens that RAN the forward
        self.total_tokens = 0       # tokens requested (hits saved the rest)
        self.hist_send = LatencyHistogram()   # card -> host -> wire, a send
        self.send_seconds = 0.0

    def _bucket_for(self, n: int, limit: int) -> int:
        """Smallest standard bucket >= n that still fits ``limit`` cache
        columns; the exact width otherwise (a near-full cache stays
        legal)."""
        for b in self.buckets:
            if b >= n:
                return b if b <= limit else int(n)
        raise ValueError(f"suffix length {n} exceeds max_len "
                         f"{self.max_len}")

    @torch.inference_mode()
    def warm(self) -> float:
        """Run the forward and the sampling once on a throwaway prompt of
        the smallest bucket, sending, caching and counting nothing; returns
        its seconds.  A process's first forward on the card pays one-time
        costs (the BLAS handle, lazy kernel loading, the allocator's first
        growth) that can by themselves pass a short ``TPU_DIST_KV_TIMEOUT``;
        call this before the rank announces itself, so that no request's
        transfer deadline pays them."""
        t0 = time.perf_counter()
        padded = np.zeros(self._bucket_for(1, self.max_len), np.int64)
        logits, _ = self.model.prefill_rows(padded, 1, self.max_len,
                                            dtype=self.dtype)
        sample_host(logits[None], np.zeros(1, np.float32),
                    random.key(0).numpy()[None], np.zeros(1, np.int64))
        return time.perf_counter() - t0

    @torch.inference_mode()
    def serve_one(self, desc: dict) -> None:
        """Prefill one descriptor and ship the result (see class doc)."""
        t0 = time.perf_counter_ns()
        tokens = np.asarray(desc["prompt"], np.int32).reshape(-1)
        L = len(tokens)
        rid = int(desc["id"])
        temp = float(desc.get("temperature", 0.0))
        key = random.key(int(desc.get("seed", 0))).numpy()

        hit, pre_rows = (self.prefix.match(tokens) if self.prefix
                         is not None else (0, None))
        if hit:
            sb = self._bucket_for(L - hit, self.max_len - hit)
            padded = np.zeros(sb, np.int64)
            padded[:L - hit] = tokens[hit:]
            pre_full = {}
            for path, entry in pre_rows.items():
                pre_full[path] = {}
                for k, t in entry.items():
                    full = torch.zeros((1, self.max_len) + tuple(t.shape[2:]),
                                       dtype=t.dtype, device=self.device)
                    full[:, :hit] = t
                    pre_full[path][k] = full
            logits, rows = self.model.prefill_rows(
                padded, L, self.max_len, dtype=self.dtype,
                prefix_rows=pre_full, prefix_len=hit)
        else:
            padded = np.zeros(self._bucket_for(L, self.max_len), np.int64)
            padded[:L] = tokens
            logits, rows = self.model.prefill_rows(
                padded, L, self.max_len, dtype=self.dtype)
        first_tok = int(sample_host(logits[None],
                                    np.array([temp], np.float32),
                                    key[None], np.zeros(1, np.int64))[0])
        prefill_ns = time.perf_counter_ns() - t0
        self.total_tokens += L
        self.prefilled_tokens += L - hit

        t_send = time.perf_counter()
        self.kv.send(int(desc["dst"]), rid, rows, L, first_tok,
                     prefix_hit=hit, prefill_ns=prefill_ns)
        dt = time.perf_counter() - t_send
        self.hist_send.observe(dt)
        self.send_seconds += dt
        self.env_chans[int(desc["dst_rr"])].put(
            {"rid": rid, "src": self.rank}, timeout=30.0)
        if self.prefix is not None:
            self.prefix.insert(tokens, rows, L)

    def run(self, stop: Optional[threading.Event] = None,
            poll: float = 0.5) -> None:
        """Claim and serve until ``stop`` is set or the decode side goes
        away (channel closed).  A failed descriptor is logged and skipped —
        its request re-dispatches from the decode side by name."""
        from ..roles.channel import ChannelClosedError, ChannelPeerGoneError
        from ..utils.logging import log_event

        while stop is None or not stop.is_set():
            try:
                desc = self.claim_ch.get(timeout=poll)
            except TimeoutError:
                continue
            except (ChannelClosedError, ChannelPeerGoneError):
                return
            self.claims += 1
            try:
                self.serve_one(desc)
            except Exception as e:
                self.errors += 1
                log_event("disagg-prefill-error",
                          rid=int(desc.get("id", -1)),
                          error=f"{type(e).__name__}: {e}"[:300])

    def stats(self) -> dict:
        out = {"claims": self.claims, "errors": self.errors,
               "prefilled_tokens": self.prefilled_tokens,
               "total_tokens": self.total_tokens,
               "kv_bytes_out": int(self.kv.sent_bytes),
               "send": self.hist_send.summary(),
               "send_mb_per_s": (self.kv.sent_bytes / self.send_seconds / 1e6
                                 if self.send_seconds else 0.0)}
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        return out
