"""Per-rank collective flight recorder: a lock-cheap ring buffer of
structured events (counterpart of ``tpu_dist/obs/recorder.py``, with the
same event schema, env knobs, store keys and dump format, so a dump a port
rank writes reads with either package's trace tools).

Every eager host collective, p2p send/recv, store client op, channel
cursor move and heartbeat beat appends one event (sequence number, op,
reduce op, payload digest, transport path, start/end monotonic ns, user
call-site, outcome) to a fixed-size ring buffer, which answers where every
rank was when the gang stalled, not only which rank went silent.

Arming: ``TPU_DIST_OBS=1`` (launcher ``--flight-recorder``); capacity
``TPU_DIST_OBS_CAPACITY``, dumps under ``TPU_DIST_OBS_DIR``.  Disarmed, the
hooks cost one environment lookup and allocate nothing; the per-(op,
transport) byte and latency counters are always on and share this module's
ingestion point (:func:`record_transport`).

An in-flight span (a collective that began and never finished) is also
held in an open-span table, so a flood of later events cannot evict the one
that explains the hang.  Digests read shape and dtype only: a CUDA tensor
is never copied to the host for them.  The recorder is per process: ranks
run as threads of one process share it, so multi-rank runs that arm it run
rank processes.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FlightRecorder", "enabled", "get_recorder", "reset", "dump_now",
           "safe_record", "record_transport", "transport_counters",
           "reset_transport_counters", "obs_key", "default_dump_dir",
           "dump_path", "call_site", "digest"]


def dump_path(dir: str, generation: int, rank: int) -> str:
    """Where rank ``rank``'s generation-``generation`` flight-recorder
    dump lands — THE definition of the filename contract; anything that
    waits on a dump file (the launchers' SIGUSR1 settle) must build the
    path here."""
    return os.path.join(dir, f"obs_g{generation}_r{rank}.json")

# the armed values (same parser as the sanitizer's TPU_DIST_SANITIZE gate)
_ON = ("1", "true", "yes", "on")
_DEF_CAPACITY = 4096


def enabled() -> bool:
    """True when the flight recorder is armed (``TPU_DIST_OBS``)."""
    return os.environ.get("TPU_DIST_OBS", "").strip().lower() in _ON


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get("TPU_DIST_OBS_CAPACITY",
                                          str(_DEF_CAPACITY))))
    except ValueError:
        return _DEF_CAPACITY


def default_dump_dir() -> str:
    """Where dumps land: ``TPU_DIST_OBS_DIR``, else a shared tempdir."""
    return (os.environ.get("TPU_DIST_OBS_DIR")
            or os.path.join(tempfile.gettempdir(), "tpu_dist_obs"))


def obs_key(generation: int, rank: int) -> str:
    """Store key a rank posts its compact tail under — generation-namespaced
    so the launcher's ``DELETE_PREFIX`` reaper covers it with the rest of
    ``tpu_dist/g{gen}/``."""
    return f"tpu_dist/g{generation}/obs/{rank}"


def _generation() -> int:
    # one parser of TPU_DIST_RESTART_COUNT exists (rendezvous.generation)
    import importlib
    return importlib.import_module(
        "tpu_dist_torch.dist.rendezvous").generation()


# framework layers whose frames are instrumentation, not the user's line
# (parallel: the ZeroOptimizer and DDP wrappers issue collectives from
# inside tpu_dist_torch.parallel; the user's line is their caller's)
_SITE_SKIP = ("collectives", "obs", "analysis", "dist", "resilience",
              "parallel", "optim", "serve")


def call_site(skip_parts=_SITE_SKIP) -> str:
    """First stack frame outside the named ``tpu_dist_torch`` subpackages:
    the user line the event is attributed to.  The sanitizer delegates
    here with a narrower skip set, so the two tools attribute a call to the
    same frame.  ``examples/`` and ``benchmarks/`` are not skipped."""
    import inspect
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # this helper's own frame lives in obs/ — it must always be skipped,
    # whatever narrower set a delegating caller (the sanitizer) passes
    skip = tuple(os.path.join(pkg, p)
                 for p in dict.fromkeys(tuple(skip_parts) + ("obs",)))
    frame = inspect.currentframe()
    try:
        while frame is not None:
            # normpath: a module imported through an unnormalized sys.path
            # entry carries that path in co_filename verbatim; it must
            # still match the normalized skip prefixes
            fname = os.path.normpath(frame.f_code.co_filename)
            if not fname.startswith(skip):
                return f"{os.path.basename(fname)}:{frame.f_lineno}"
            frame = frame.f_back
        return "<unknown>"
    finally:
        del frame


def _dtype_name(dt) -> Tuple[str, int]:
    """(numpy's name, itemsize) of a torch or numpy dtype: ``bfloat16`` for
    ``torch.bfloat16`` and for the port's bfloat16 host arrays, as
    ``ml_dtypes`` names it."""
    if isinstance(dt, torch.dtype):
        return str(dt).rpartition(".")[2], torch.empty(
            (), dtype=dt).element_size()
    from ..collectives import _lowp
    dt = np.dtype(dt)
    return _lowp.dtype_name(dt), dt.itemsize


def _leaf_sig(leaf) -> tuple:
    """(dtype+shape string, payload bytes) from the leaf's shape and dtype
    only: digesting never copies a device tensor to the host."""
    shape = getattr(leaf, "shape", None)
    dt = getattr(leaf, "dtype", None)
    if shape is None or dt is None:
        return type(leaf).__name__, 0
    try:
        name, itemsize = _dtype_name(dt)
        n = int(np.prod(tuple(shape), dtype=np.int64)) * itemsize
        return f"{name}{list(shape)}", n
    except Exception:
        return "?", 0


def digest(value) -> tuple:
    """``(digest_string, total_payload_bytes)`` over a tree's leaves
    (first 16 leaves spelled out, the rest counted)."""
    from ..collectives import _tree
    leaves = _tree.flatten(value)[0]
    parts: List[str] = []
    total = 0
    for i, leaf in enumerate(leaves):
        sig, n = _leaf_sig(leaf)
        total += n
        if i < 16:
            parts.append(sig)
    if len(leaves) > 16:
        parts.append(f"+{len(leaves) - 16} more")
    return ",".join(parts), total


class FlightRecorder:
    """Fixed-capacity ring buffer of structured events for one rank.

    Thread-safe; the critical section is a sequence-number increment and a
    deque append.  Events are plain dicts (JSON-ready).  Core keys:
    ``seq`` (per-rank event index), ``kind`` (collective | p2p | store |
    transport | beat | serve | channel | plan | user), ``op``,
    ``t0``/``t1`` (monotonic ns; ``t1`` None while in flight),
    ``outcome`` (pending | ok | error:Type).
    Collective events additionally carry ``coll`` — the process-local
    collective sequence number every rank of an SPMD program increments in
    lockstep, which is what the cross-rank merge aligns on — plus
    ``reduce``, ``digest``, ``bytes``, ``path`` and ``site``.
    """

    def __init__(self, capacity: Optional[int] = None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 generation: Optional[int] = None):
        self.capacity = capacity if capacity is not None else _capacity()
        self.rank = (rank if rank is not None
                     else int(os.environ.get("RANK", "0") or 0))
        self.world = (world if world is not None
                      else int(os.environ.get("WORLD_SIZE", "1") or 1))
        self.generation = (generation if generation is not None
                           else _generation())
        # role-graph identity (tpu_dist_torch.roles): set from the launcher
        # env here, corrected by init_role_graph; dumps, tails and the
        # supervisor's positions table key on (role, role_rank) beside the
        # flat rank
        self.role = os.environ.get("TPU_DIST_ROLE") or None
        try:
            self.role_rank = (int(os.environ["TPU_DIST_ROLE_RANK"])
                              if self.role else None)
        except (KeyError, ValueError):
            self.role_rank = None
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._open: Dict[int, dict] = {}
        # RLock, not Lock: the crash-dump signal handlers run ON the main
        # thread and may interrupt a frame that already holds this lock
        # mid-record — snapshot() must be able to re-enter, not deadlock
        self._mu = threading.RLock()
        self._seq = 0
        self._coll = 0
        self._last: Optional[dict] = None       # newest event
        self._last_coll: Optional[dict] = None  # newest collective event
        self._dumped = False
        # wall/mono anchor pair: lets the merge place each rank's monotonic
        # timestamps on a shared (approximate) wall-clock axis
        self.wall_anchor_ns = time.time_ns()
        self.mono_anchor_ns = time.monotonic_ns()

    # -- ingestion -----------------------------------------------------------

    def next_coll(self) -> int:
        with self._mu:
            c = self._coll
            self._coll += 1
            return c

    def begin(self, kind: str, op: str, **fields) -> dict:
        """Open an in-flight span (outcome ``pending``); finish it with
        :meth:`end`.  The span is pinned in the open-span table so ring
        eviction cannot lose it while it is still pending."""
        now = time.monotonic_ns()
        ev = {"kind": kind, "op": op, "t0": now, "t1": None,
              "outcome": "pending", **fields}
        with self._mu:
            ev["seq"] = self._seq
            self._seq += 1
            self._buf.append(ev)
            self._open[ev["seq"]] = ev
            self._note_last(ev)
        return ev

    def end(self, ev: dict, outcome: str = "ok", **fields) -> None:
        # mutate under the lock: snapshot()/last_position() copy these
        # dicts from other threads (heartbeat tail posts, crash dumps)
        with self._mu:
            ev.update(fields)
            ev["t1"] = time.monotonic_ns()
            ev["outcome"] = outcome
            self._open.pop(ev["seq"], None)

    def update_event(self, ev: dict, **fields) -> None:
        """Stamp extra fields onto an event (e.g. the transport path onto a
        pending span) — under the lock, for the same reason as :meth:`end`."""
        with self._mu:
            ev.update(fields)

    def record(self, kind: str, op: str, t0: Optional[int] = None,
               **fields) -> dict:
        """Append one already-completed event (``t0`` monotonic ns, default
        now)."""
        now = time.monotonic_ns()
        ev = {"kind": kind, "op": op,
              "t0": t0 if t0 is not None else now, "t1": now,
              "outcome": fields.pop("outcome", "ok"), **fields}
        with self._mu:
            ev["seq"] = self._seq
            self._seq += 1
            self._buf.append(ev)
            self._note_last(ev)
        return ev

    def _note_last(self, ev: dict) -> None:
        self._last = ev
        if ev["kind"] == "collective":
            self._last_coll = ev

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Events in sequence order: the ring contents plus any in-flight
        spans the ring already evicted (copied — safe to serialize while
        other threads keep recording)."""
        with self._mu:
            merged = {e["seq"]: e for e in self._buf}
            merged.update(self._open)
            return [dict(merged[s]) for s in sorted(merged)]

    def tail(self, n: int = 1) -> List[dict]:
        return self.snapshot()[-n:]

    def last_position(self) -> Optional[dict]:
        """Compact "where was this rank" record: the newest *collective*
        event (falling back to the newest event of any kind) — what gets
        posted to the store and printed in the supervisor's table.  O(1):
        this runs on every heartbeat beat, so it must not walk the ring."""
        with self._mu:
            last = self._last_coll or self._last
            if last is None:
                return None
            pos = {"rank": self.rank, "generation": self.generation,
                   "seq": last["seq"], "kind": last["kind"],
                   "op": last["op"], "coll": last.get("coll"),
                   "site": last.get("site"), "outcome": last["outcome"],
                   "events": self._seq}
            if self.role is not None:
                pos["role"] = f"{self.role}[{self.role_rank}]"
            return pos

    # -- dumps ---------------------------------------------------------------

    def dump(self, reason: str, dir: Optional[str] = None) -> str:
        """Flush the buffer to ``{dir}/obs_g{generation}_r{rank}.json``
        (atomic tmp+rename); returns the path."""
        out_dir = dir or default_dump_dir()
        os.makedirs(out_dir, exist_ok=True)
        path = dump_path(out_dir, self.generation, self.rank)
        doc = {"version": 1, "rank": self.rank, "world": self.world,
               "role": self.role, "role_rank": self.role_rank,
               "generation": self.generation, "pid": os.getpid(),
               "reason": reason, "capacity": self.capacity,
               "wall_anchor_ns": self.wall_anchor_ns,
               "mono_anchor_ns": self.mono_anchor_ns,
               "mono_dump_ns": time.monotonic_ns(),
               "events": self.snapshot()}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        self._dumped = True
        return path


# -- process-wide singleton ---------------------------------------------------

_rec: Optional[FlightRecorder] = None
_rec_mu = threading.Lock()


def get_recorder() -> Optional[FlightRecorder]:
    """The process's recorder, or None when disarmed — the single gate every
    hook checks (one env lookup on the disarmed path)."""
    if not enabled():
        return None
    global _rec
    if _rec is None:
        with _rec_mu:
            if _rec is None:
                _rec = FlightRecorder()
    return _rec


def safe_record(kind: str, op: str, t0: Optional[int] = None,
                **fields) -> None:
    """Armed-gated, never-raises event record — THE shim instrumentation
    choke points (transport reader threads, store client wrapper) share,
    so the "diagnostics must never break the data path" guarantee lives
    in exactly one place."""
    try:
        rec = get_recorder()
        if rec is not None:
            rec.record(kind, op, t0=t0, **fields)
    except Exception:
        pass


def dump_now(reason: str, force: bool = True) -> Optional[str]:
    """Best-effort dump of the armed recorder (None when disarmed or the
    write fails — crash paths must never raise).  ``force=False`` skips the
    write when a dump already happened (the atexit catch-all must not
    overwrite a crash dump's reason)."""
    rec = get_recorder()
    if rec is None or (not force and rec._dumped):
        return None
    try:
        return rec.dump(reason)
    except Exception:
        return None


def reset() -> None:
    """Drop the singleton recorder and the transport counters (tests)."""
    global _rec
    with _rec_mu:
        _rec = None
    reset_transport_counters()


# -- per-(op, transport) counters ---------------------------------------------
#
# The counters and the flight recorder ingest the same record_transport
# call, so byte and latency totals and the event stream cannot disagree.

_agg_mu = threading.Lock()
_agg: Dict[str, Dict[str, float]] = {}


def record_transport(op: str, path: str, nbytes: int, seconds: float,
                     wire_bytes: Optional[int] = None,
                     raw_wire_bytes: Optional[int] = None) -> None:
    """Account one transport leg: ``op`` over ``path`` ('dataplane' |
    'store' | 'mesh') moving ``nbytes`` *logical* bytes in ``seconds``.
    ``wire_bytes`` is what actually crossed the wire (compressed when a
    wire format was in play); ``raw_wire_bytes`` is what the SAME traffic
    would have cost uncompressed — their ratio is the wire-format
    compression factor, independent of the ring's 2(N-1)/N wire
    amplification over the logical payload.  Both default to ``nbytes``
    (store/mesh legs move logical bytes, uncompressed).  Always feeds the
    aggregate counters; when armed it additionally annotates the
    enclosing collective span (or records a standalone ``transport``
    event)."""
    key = f"{op}/{path}"
    with _agg_mu:
        c = _agg.get(key)
        if c is None:
            c = _agg[key] = {"calls": 0, "bytes": 0, "wire_bytes": 0,
                             "raw_wire_bytes": 0, "seconds": 0.0}
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["wire_bytes"] += int(nbytes if wire_bytes is None else wire_bytes)
        c["raw_wire_bytes"] += int(
            nbytes if raw_wire_bytes is None
            else raw_wire_bytes)
        c["seconds"] += float(seconds)
    rec = get_recorder()
    if rec is not None:
        from . import hooks
        hooks.annotate_transport(rec, op, path, nbytes, seconds)


def transport_counters(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Snapshot of the per-``op/transport`` counters, each entry
    ``{calls, bytes, wire_bytes, raw_wire_bytes, seconds, mb_per_s,
    compression}`` — ``mb_per_s`` is *effective* (logical bytes over wall
    time, the quantity benchmarks compare) and ``compression`` is
    raw ÷ compressed wire bytes (1.0 uncompressed, at every world size);
    ``reset=True`` atomically clears after reading."""
    with _agg_mu:
        out = {k: dict(v) for k, v in _agg.items()}
        if reset:
            _agg.clear()
    for v in out.values():
        v.setdefault("wire_bytes", v["bytes"])  # pre-quant recordings
        v.setdefault("raw_wire_bytes", v["wire_bytes"])
        v["mb_per_s"] = (v["bytes"] / v["seconds"] / 1e6
                         if v["seconds"] > 0 else 0.0)
        v["compression"] = (v["raw_wire_bytes"] / v["wire_bytes"]
                            if v["wire_bytes"] > 0 else 1.0)
    return out


def reset_transport_counters() -> None:
    with _agg_mu:
        _agg.clear()
