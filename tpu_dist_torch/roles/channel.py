"""Typed channels between roles — store-registered, data-plane-carried
(counterpart of ``tpu_dist/roles/channel.py``, with the same store keys,
envelope and frame tags).

A :class:`Channel` is one named edge of a
:class:`~tpu_dist_torch.roles.graph.RoleGraph`: a bounded FIFO queue (or a
versioned "latest" register) between a ``src`` role and a ``dst`` role.
Payloads are trees (dicts, lists, tuples) of tensors, arrays and plain
objects.  On the wire array leaves are numpy, as in the JAX package:
``put`` copies a tensor leaf to the host (a CUDA leaf on the caller's
stream; bfloat16 as the port's bit-pattern host arrays), and ``get``
hands numeric array leaves back as torch CPU tensors.

**Wire discipline** (all of it existing machinery, composed):

- Control and small payloads ride the control-plane store under the
  generation-scoped namespace ``tpu_dist/g{gen}/roles/ch/{name}/…`` —
  the same fencing as every collective key, so a restarted *gang* (new
  generation) can never read a dead incarnation's messages, while a
  **solo-restarted role rank** (same generation, see
  :func:`~tpu_dist_torch.roles.spawn_graph`) re-attaches to the live counters
  and the channel *resumes by name*.
- Store payloads are **sealed** with the data plane's frame checksum
  (``TPU_DIST_FRAME_CRC``, via ``eager._seal``): a bit flipped in
  transit raises a named
  :class:`~tpu_dist_torch.collectives.transport.FrameCorruptError` at the
  consumer instead of unpickling to silently wrong values.
- Array leaves of at least ``TPU_DIST_DP_THRESHOLD`` bytes ride the p2p
  **data plane** as raw frames (``transport.py``: vectored sendmsg, CRC
  trailers, SHM lanes for co-located peers — all inherited) whenever the
  destination role has exactly one rank, so the producer knows where to
  push; the store then carries only a small envelope.  Multi-consumer
  channels keep everything on the store (the claiming consumer is not
  known at send time).

**Queue semantics.**  Producers and consumers claim slots through atomic
store counters (``add``), so the queue is MPMC-safe and restart-proof —
the cursor lives in the store, not in any process.  MPMC means many
*ranks* (one endpoint per process); a single ``Channel`` endpoint is NOT
thread-safe — concurrent ``get`` calls on one endpoint race its claim
bookkeeping (a timed-out thread's claim release can hand a sibling
thread's slot to the next caller).  Use one endpoint per thread, or
serialize.  ``put`` blocks while ``depth`` messages are unacknowledged
(backpressure; with *k* concurrent producers the bound can overshoot by
at most *k−1*).  FIFO is by claim order.

**Failure taxonomy** (docs/roles.md#failure-taxonomy): every blocking
call is deadline-bounded (``timeout=`` or ``TPU_DIST_CH_TIMEOUT``, else
the data plane's ``TPU_DIST_DP_TIMEOUT``) and while waiting polls the
supervisor's *down* markers and the peer side's *closed* counters:

- :class:`ChannelTimeoutError` — deadline passed, peer role still
  nominally alive (names the channel, the op, the slot and the peer
  role).  A single-consumer ``get`` releases its slot claim first, so a
  recovered caller may retry without losing a message.  A slot whose
  producer claimed it but never wrote it (killed mid-``put``) is a
  *hole*: once it has starved retries past the settle window
  (``TPU_DIST_CH_HOLE_SETTLE``, at least that get's deadline) the
  consumer acks it and moves on instead of re-claiming it forever;
  multi-consumer endpoints remember their abandoned claims and later
  gets deliver a late write or ack the settled hole
  (``roles-channel-hole-skipped`` log event); each consumer rank also
  persists its outstanding claims (``claims/{rank}``), so a
  solo-respawned consumer inherits the dead incarnation's orphaned
  claims into the same ledger and reconciles them
  (``roles-channel-claims-reconciled``) instead of leaking the
  backpressure window.  A data-plane frame
  timeout under a fetched envelope is *retryable*: the envelope and
  claim are returned so the same slot delivers once frames land.
- :class:`ChannelPeerGoneError` — every rank of the peer role is marked
  down by the supervisor (died, not restarting): fail now, by name,
  instead of waiting out the deadline.
- :class:`ChannelClosedError` — the peer side *closed* cleanly: a
  drained queue whose producers all closed (EOF), or a ``put`` whose
  consumers are all gone.
- :class:`~tpu_dist_torch.collectives.transport.FrameCorruptError` —
  payload checksum mismatch (store seal or data-plane frame CRC).

**Mixed gangs.**  The store path works across the two packages both
ways, for trees of numpy arrays and plain objects (the JAX producer must
put numpy, not ``jax.Array``, leaves: the port refuses to unpickle JAX or
``tpu_dist`` classes, by name).  A leaf that rode the data plane leaves a
``_DPRef`` placeholder in the envelope, pickled under its module path: the
port's unpickler maps the JAX class path onto its own placeholder, so a
JAX producer feeds a port consumer on both paths; the JAX package cannot
unpickle the port's placeholder, so a port producer feeds a JAX consumer
on the store path only (``TPU_DIST_CH_DP=0`` on the producer).  A
bfloat16 leaf pickles as the port's bit-pattern host array, which the JAX
package reads as a structured array, not ``ml_dtypes.bfloat16``.
"""

from __future__ import annotations

import io
import os
import pickle
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import ChannelSpec, RoleGraphError, down_key

__all__ = ["Channel", "ChannelError", "ChannelClosedError",
           "ChannelTimeoutError", "ChannelPeerGoneError"]


class ChannelError(RuntimeError):
    """Base class for channel failures (mis-use, registration mismatch)."""


class ChannelClosedError(ChannelError):
    """The peer side closed cleanly: producers all closed and the queue is
    drained (EOF on get), or consumers all closed (put has no reader)."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """A channel op missed its deadline with the peer role still alive —
    the channel twin of ``CollectiveTimeoutError`` (named: channel, op,
    slot, peer role).  Subclasses both ``ChannelError`` (the documented
    taxonomy base) and ``TimeoutError``."""


class ChannelPeerGoneError(ChannelError, ConnectionError):
    """Every rank of the peer role is marked down by the supervisor and is
    not coming back in this generation — the channel twin of
    ``PeerGoneError``.  Subclasses both ``ChannelError`` and
    ``ConnectionError``."""

    def __init__(self, channel: str, role: str, ranks: Sequence[int],
                 what: str):
        self.channel, self.role, self.ranks = channel, role, list(ranks)
        super().__init__(
            f"channel {channel!r}: {what} but every rank of peer role "
            f"{role!r} (global ranks {self.ranks}) is down and not "
            f"restarting — failing by name instead of waiting out the "
            f"deadline")


def _default_timeout() -> float:
    try:
        v = os.environ.get("TPU_DIST_CH_TIMEOUT")
        if v:
            return float(v)
    except ValueError:
        pass
    from ..collectives.transport import _default_timeout as dp_timeout
    return dp_timeout()


def _dp_threshold() -> int:
    from ..collectives.eager import _dp_threshold as thr
    return thr()


def _hole_settle() -> float:
    try:
        return float(os.environ.get("TPU_DIST_CH_HOLE_SETTLE", "5"))
    except ValueError:
        return 5.0


_NOTHING = object()  # _sweep_abandoned: "no message surfaced" sentinel


class _DPRef:
    """Placeholder left in a pickled tree for a leaf that rode the data
    plane as a raw frame (position ``j`` of the message's frame burst)."""
    __slots__ = ("j",)

    def __init__(self, j: int):
        self.j = j


# the JAX package's placeholder class path, read as the port's own
_JAX_DPREF = ("tpu_dist.roles.channel", "_DPRef")
_REFUSED_MODULES = ("jax", "jaxlib", "tpu_dist")


class _Unpickler(pickle.Unpickler):
    """Unpickler of channel envelopes: the JAX ``_DPRef`` becomes the
    port's, and JAX or ``tpu_dist`` classes are refused by name (a port
    process must not import JAX to read a message)."""

    def find_class(self, module, name):
        if (module, name) == _JAX_DPREF:
            return _DPRef
        if module.split(".")[0] in _REFUSED_MODULES:
            raise ChannelError(
                f"channel payload holds {module}.{name}: a JAX producer "
                f"must put numpy leaves for a tpu_dist_torch consumer")
        return super().find_class(module, name)


def _loads(raw: bytes):
    return _Unpickler(io.BytesIO(raw)).load()


def _to_wire(leaf):
    """A tensor leaf as numpy (copied to the host); others as they are."""
    if isinstance(leaf, torch.Tensor):
        from ..collectives import _lowp
        return _lowp.from_torch(leaf)
    return leaf


def _from_wire(leaf):
    """A numeric numpy leaf as a torch CPU tensor; others as they are."""
    if isinstance(leaf, np.ndarray):
        from ..collectives import _lowp
        if leaf.dtype.kind in "iufb" or _lowp.is_lowp(leaf.dtype):
            return _lowp.to_torch(np.require(leaf, requirements="CW"))
    return leaf


class Channel:
    """One endpoint of a role-graph channel.  Obtain via
    :meth:`tpu_dist_torch.roles.RoleContext.channel`; direct construction is for
    in-process test rigs (explicit ``store``/spans/``dp``).

    The endpoint knows which side it is on from ``role``: ranks of
    ``spec.src`` may :meth:`put`, ranks of ``spec.dst`` may :meth:`get`;
    anything else is a named :class:`RoleGraphError` before any traffic
    moves.
    """

    def __init__(self, spec: ChannelSpec, store, rank: int, role: str,
                 src_span: Sequence[int], dst_span: Sequence[int],
                 generation: int = 0, graph_world: Optional[int] = None,
                 dp=None):
        self.spec = spec
        self.name = spec.name
        self._store = store
        self._rank = int(rank)
        self._role = str(role)
        self._src = list(src_span)
        self._dst = list(dst_span)
        self._gen = int(generation)
        self._world = (int(graph_world) if graph_world is not None
                       else max(self._src + self._dst) + 1)
        # dp: an injected DataPlane (in-process rigs), None (bring up
        # lazily via the process singleton), or False (never touch the
        # data plane — store-only endpoint)
        self._dp = dp if dp is not None and dp is not False else None
        self._dp_failed = dp is False
        self._peer_dp_up = self._dp is not None  # injected: skip the probe
        self._closed = False
        self._stuck: dict = {}      # slot -> (first_timeout, settle): the
        self._abandoned: dict = {}  # single/multi-consumer hole ledgers
        self._partial: dict = {}    # slot -> {j: frame} across dp retries
        self._next_status = 0.0     # peer-status cadence, across calls
        self._status_cache: Tuple[bool, List[int]] = (False, [])
        self._base = f"tpu_dist/g{self._gen}/roles/ch/{spec.name}"
        self.stats = {"put": 0, "got": 0, "dp_msgs": 0, "store_msgs": 0,
                      "dp_leaves": 0}
        if role not in (spec.src, spec.dst):
            raise RoleGraphError(
                f"role {role!r} holds no endpoint of channel "
                f"{spec.name!r} (src={spec.src!r}, dst={spec.dst!r})")
        self._register()
        try:
            # attaching IS the liveness statement: a crashed incarnation's
            # unwind posted this rank's closed marker on the way down, and
            # a solo respawn re-attaching by name must not keep faking a
            # clean EOF to its peers
            self._store.delete_key(self._k(f"closed/{self._rank}"))
        except Exception:
            pass
        self._claims: set = set()  # this rank's outstanding MPMC claims
        if (spec.kind == "queue" and self._role == spec.dst
                and self._dst == [self._rank]):
            # the claim-orphan rewind, the consumer twin of hole healing:
            # an incarnation killed mid-get died HOLDING claims (rtail
            # past acks with no other claimant possible) — return them so
            # this incarnation re-claims those slots instead of skipping
            # the undelivered messages and shrinking the window forever.
            # Single-consumer only (a sibling's in-flight claim is
            # indistinguishable from an orphan), at attach time (no own
            # get can be in flight yet)
            try:
                rtail = self._count("rtail")
                stranded = rtail - self._count("acks")
                if stranded > 0:
                    self._store.add(self._k("rtail"), -stranded)
                    for i in range(rtail - stranded, rtail):
                        self._obs("claim-return", slot=i)
            except Exception:
                pass
        elif (spec.kind == "queue" and self._role == spec.dst
                and len(self._dst) != 1):
            # multi-consumer claim-orphan reconciliation: claims cannot be
            # returned (a sibling may have claimed past us), so each
            # consumer rank persists its outstanding claims under
            # claims/{rank}; a solo-respawned incarnation inherits the
            # dead one's claims into the abandoned-claim ledger, where
            # later gets deliver a late write or settle-ack the hole —
            # instead of those slots leaking the backpressure window for
            # the rest of the generation
            try:
                raw = (self._store.get(self._k(f"claims/{self._rank}"))
                       if self._store.check(
                           self._k(f"claims/{self._rank}")) else b"[]")
                import json
                inherited = [int(i) for i in json.loads(raw.decode())]
                for i in inherited:
                    # settle clock deferred (entry[0]=None): the sweep
                    # starts it once a producer has claimed the slot
                    self._abandoned.setdefault(i, [None, _hole_settle()])
                    self._claims.add(i)
                    self._obs("inherit", slot=i)
                if inherited:
                    from ..utils.logging import log_event
                    log_event("roles-channel-claims-reconciled",
                              channel=self.name, rank=self._rank,
                              slots=sorted(inherited))
            except Exception:
                pass
        if (spec.kind == "queue" and self._dp is None
                and not self._dp_failed
                and self._role == spec.dst and self._dst == [self._rank]
                and os.environ.get("TPU_DIST_CH_DP", "").strip() != "0"):
            # single-consumer endpoint: bring the DataPlane up EAGERLY so
            # the listener address is published before any producer's
            # first big-payload put tries to dial it — lazily, producers
            # would block on a listener that does not exist yet
            self._dp = self._singleton_dp()

    # -- registration --------------------------------------------------------

    def _register(self) -> None:
        """Store-register the channel spec (idempotent): first endpoint
        posts it, later endpoints validate — two programs attaching to the
        same name with different specs is a named error, not silent
        cross-talk."""
        import dataclasses
        import json
        key = f"{self._base}/spec"
        mine = json.dumps(dataclasses.asdict(self.spec), sort_keys=True)
        try:
            if self._store.check(key):
                theirs = self._store.get(key).decode()
                if theirs != mine:
                    raise ChannelError(
                        f"channel {self.name!r}: registered spec {theirs} "
                        f"does not match this endpoint's {mine} — every "
                        f"endpoint must attach with the identical "
                        f"ChannelSpec")
                return
            self._store.set(key, mine.encode())
        except ChannelError:
            raise
        except Exception:
            pass  # registration is a guard rail; a flaky store degrades it

    # -- small helpers -------------------------------------------------------

    def _k(self, leaf: str) -> str:
        return f"{self._base}/{leaf}"

    def _obs(self, op: str, **fields) -> None:
        """Flight-record one cursor transition (kind=``channel``) — the
        event stream the offline replay sanitizer re-verifies (claim
        without ack = orphaned claim, double-ack, hole-skip vs
        late-write).  No-op unless the recorder is armed; never raises."""
        from ..obs.recorder import safe_record
        safe_record("channel", op, channel=self.name, **fields)

    def _count(self, leaf: str) -> int:
        return int(self._store.add(self._k(leaf), 0))

    def _require(self, side: str, what: str) -> None:
        ok = (self._role == self.spec.src) if side == "src" \
            else (self._role == self.spec.dst)
        if not ok:
            raise RoleGraphError(
                f"channel {self.name!r}: {what} requires the "
                f"{'producer' if side == 'src' else 'consumer'} role "
                f"({getattr(self.spec, side)!r}); this endpoint is "
                f"{self._role!r}")
        if self._closed:
            raise ChannelClosedError(
                f"channel {self.name!r}: this endpoint is closed")

    def _peer(self, side: str) -> Tuple[str, List[int]]:
        """(peer role name, peer global ranks) for an op on this side."""
        if side == "src":
            return self.spec.dst, self._dst
        return self.spec.src, self._src

    def _peer_status(self, peer_ranks: Sequence[int]):
        """``(all_gone, down_ranks)``: a peer rank is *gone* when it either
        closed its endpoint cleanly (per-rank closed marker — idempotent
        across solo restarts, unlike a counter) or the supervisor marked
        it down.  ``all_gone`` with an empty ``down_ranks`` is the clean
        EOF; any down rank makes the failure a peer-death."""
        down: List[int] = []
        gone = 0
        try:
            for r in peer_ranks:
                if self._store.check(down_key(self._gen, r)):
                    down.append(r)
                    gone += 1
                elif self._store.check(self._k(f"closed/{r}")):
                    gone += 1
        except Exception:
            return False, []  # store trouble is neither death nor EOF
        return gone == len(peer_ranks), down

    def _peer_status_cadenced(self, peer_ranks: Sequence[int]):
        """:meth:`_peer_status` throttled to one probe per 0.1 s ACROSS
        calls (peer death is the rare case; a hot put/get loop must not
        pay peer-count store round-trips per message).  The last verdict
        is cached in between — an endpoint only ever polls one side's
        peers (``_require`` gates ops by role), so the cache cannot mix
        producer and consumer peer sets."""
        now = time.monotonic()
        if now >= self._next_status:
            self._status_cache = self._peer_status(peer_ranks)
            self._next_status = now + 0.1
        return self._status_cache

    def _claim_add(self, idx: int) -> None:
        """Persist a multi-consumer claim (crash ledger: a killed
        incarnation's successor inherits these — see ``__init__``).
        Best-effort: a flaky store degrades recovery, never delivery."""
        self._claims.add(idx)
        self._claims_persist()

    def _claim_done(self, idx: int) -> None:
        """The claim on ``idx`` is resolved (delivered, poison-consumed or
        settle-acked) — drop it from the persisted ledger."""
        if idx in self._claims:
            self._claims.discard(idx)
            self._claims_persist()

    def _claims_persist(self) -> None:
        if len(self._dst) == 1 or self._role != self.spec.dst:
            return
        import json
        try:
            self._store.set(self._k(f"claims/{self._rank}"),
                            json.dumps(sorted(self._claims)).encode())
        except Exception:
            pass

    def _consume_slot(self, idx: int, key: str) -> None:
        """Ack + delete a slot whose message is consumed by failure
        (poison decode, lossy multi-consumer timeout) — best-effort, so a
        flaky store cannot mask the original error."""
        self._partial.pop(idx, None)
        try:
            self._store.delete_key(key)
            self._store.add(self._k("acks"), 1)
            self._obs("consume", slot=idx)
        except Exception:
            pass
        self._claim_done(idx)

    def _deadline(self, timeout: Optional[float]) -> float:
        t = _default_timeout() if timeout is None else float(timeout)
        return time.monotonic() + max(0.0, t)

    def _timeout_error(self, what: str, deadline_len: float,
                       peer_role: str) -> ChannelTimeoutError:
        return ChannelTimeoutError(
            f"channel {self.name!r}: {what} missed its "
            f"{deadline_len:.1f}s deadline with peer role {peer_role!r} "
            f"still nominally alive (pass timeout= / TPU_DIST_CH_TIMEOUT "
            f"to tune; a dead peer raises ChannelPeerGoneError instead)")

    # -- payload encoding ----------------------------------------------------

    def _maybe_dp(self):
        """This (producer) endpoint's DataPlane, brought up lazily; None
        when the channel cannot (multi-consumer), should not
        (TPU_DIST_CH_DP=0, prior setup failure), or the consumer has not
        published a listener address — one-sided degradation to the store
        is SAFE here (unlike the ring): the envelope tells the consumer
        which path each leaf took, and checking the address first keeps a
        dp-less consumer from costing every put a dial deadline."""
        if len(self._dst) != 1:
            # multi-consumer channels stay on the store even with an
            # injected DataPlane: frames are addressed to one rank, but
            # ANY consumer may claim the slot
            return None
        if self._dp_failed:
            return None  # every _dp_failed path leaves _dp unset
        if os.environ.get("TPU_DIST_CH_DP", "").strip() == "0":
            return None
        if not self._peer_dp_up:
            from ..collectives.transport import dp_addr_key
            try:
                if not self._store.check(dp_addr_key(self._gen,
                                                     self._dst[0])):
                    return None
                self._peer_dp_up = True
            except Exception:
                return None
        if self._dp is not None:
            return self._dp
        self._dp = self._singleton_dp()
        return self._dp

    def _singleton_dp(self):
        """The process DataPlane via ``get_data_plane`` — accepted only
        when its rank identity matches this endpoint's (an in-process
        multi-rank rig's singleton belongs to whichever rank asked first;
        such rigs must inject per-rank DataPlanes explicitly)."""
        try:
            from ..collectives import transport
            dp = transport.get_data_plane(self._store, self._rank,
                                          self._world)
            if dp is not None and dp.rank != self._rank:
                dp = None
            if dp is None:
                self._dp_failed = True
            return dp
        except Exception as e:
            self._dp_failed = True
            from ..utils.logging import log_event
            log_event("roles-channel-dp-unavailable", channel=self.name,
                      error=repr(e)[:200])
            return None

    def _encode(self, tree, idx: int) -> bytes:
        """Pickle + seal ``tree``; big array leaves go out as data-plane
        frames first (consumer matches them by the slot index in the
        tag), leaving `_DPRef` placeholders in the pickled structure."""
        from ..collectives import _lowp, _tree
        from ..collectives.eager import _seal

        leaves, treedef = _tree.flatten(tree)
        leaves = [_to_wire(leaf) for leaf in leaves]
        # the `latest` register (idx -1) stays store-only: a consumer that
        # skips versions would leave stale frames queued under the reused
        # register tag, and the next recv would deliver them out of date
        dp = self._maybe_dp() if idx >= 0 else None
        header: dict = {"src": self._rank}
        if dp is not None:
            thr = _dp_threshold()
            refs, j = [], 0
            for leaf in leaves:
                arr = np.asarray(leaf)
                if (arr.nbytes >= thr and thr > 0
                        and (arr.dtype.kind in "iufb"
                             or _lowp.is_lowp(arr.dtype))):
                    dp.send_array(self._dst[0],
                                  f"roles/ch/{self.name}/{idx}/{j}", arr)
                    refs.append(_DPRef(j))
                    j += 1
                else:
                    refs.append(leaf)
            if j:
                header["dp"] = j
                self.stats["dp_msgs"] += 1
                self.stats["dp_leaves"] += j
                leaves = refs
            else:
                self.stats["store_msgs"] += 1
        else:
            self.stats["store_msgs"] += 1
        payload = pickle.dumps((header, _tree.unflatten(treedef, leaves)),
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _seal(payload)

    def _decode(self, raw: bytes, idx: int, deadline: float):
        from ..collectives import _tree
        from ..collectives.eager import _unseal

        header, tree = _loads(
            _unseal(raw, f"channel {self.name!r} slot {idx}"))
        ndp = int(header.get("dp", 0))
        if not ndp:
            self.stats["store_msgs"] += 1
            return _tree.tree_map(_from_wire, tree)
        src = int(header["src"])
        dp = self._dp or self._singleton_dp()
        if dp is None:
            raise ChannelError(
                f"channel {self.name!r}: slot {idx} carries {ndp} "
                f"data-plane leaves but this consumer has no data plane "
                f"(disabled or setup failed) — producers and consumers "
                f"must agree on TPU_DIST_CH_DP")
        self._dp = dp
        # frames already received on an earlier timed-out attempt are
        # HELD here (recv_array consumes them from the plane's queue, so
        # a retry could never see them again and would livelock on the
        # first tag); a successful decode releases the slot's cache
        frames = self._partial.setdefault(idx, {})
        for j in range(ndp):
            if j in frames:
                continue
            left = max(0.1, deadline - time.monotonic())
            frames[j] = dp.recv_array(src,
                                      f"roles/ch/{self.name}/{idx}/{j}",
                                      timeout=left)
        self._partial.pop(idx, None)
        # counted only now: the retryable frame-timeout path means one
        # message may enter _decode more than once
        self.stats["dp_msgs"] += 1
        self.stats["dp_leaves"] += ndp
        return _tree.tree_map(
            lambda l: _from_wire(frames[l.j] if isinstance(l, _DPRef)
                                 else l), tree)

    # -- queue ops -----------------------------------------------------------

    def put(self, tree: Any, timeout: Optional[float] = None) -> int:
        """Enqueue one message (any pytree); returns its slot index.
        Blocks under backpressure (``depth`` unacknowledged messages);
        see the module docstring for the failure taxonomy."""
        self._require("src", "put")
        if self.spec.kind == "latest":
            return self.put_latest(tree, timeout=timeout)
        deadline = self._deadline(timeout)
        peer_role, peer_ranks = self._peer("src")
        delay = 0.0005
        while True:
            gone, down = self._peer_status_cadenced(peer_ranks)
            if gone:
                if down:
                    raise ChannelPeerGoneError(self.name, peer_role, down,
                                               "put has no live reader")
                raise ChannelClosedError(
                    f"channel {self.name!r}: every consumer "
                    f"({peer_role!r}) closed; put has no reader")
            head = self._count("head")
            acks = self._count("acks")
            if head - acks < self.spec.depth:
                break
            if time.monotonic() > deadline:
                raise self._timeout_error(
                    f"put (backpressured at depth {self.spec.depth})",
                    _default_timeout() if timeout is None else timeout,
                    peer_role)
            time.sleep(delay)
            delay = min(delay * 2, 0.02)
        idx = int(self._store.add(self._k("head"), 1)) - 1
        self._store.set(self._k(f"m/{idx}"), self._encode(tree, idx))
        self._obs("put", slot=idx)
        self.stats["put"] += 1
        return idx

    def get(self, timeout: Optional[float] = None) -> Any:
        """Dequeue the next message (FIFO by claim order); see the module
        docstring for deadline/closed/peer-death semantics."""
        self._require("dst", "get")
        if self.spec.kind == "latest":
            tree, _ = self.get_latest(timeout=timeout)
            return tree
        deadline = self._deadline(timeout)
        deadline_len = _default_timeout() if timeout is None else timeout
        peer_role, peer_ranks = self._peer("dst")
        if self._abandoned:
            got = self._sweep_abandoned(deadline)
            if got is not _NOTHING:
                return got
        idx = int(self._store.add(self._k("rtail"), 1)) - 1
        self._obs("claim", slot=idx)
        if len(self._dst) != 1:
            self._claim_add(idx)
        key = self._k(f"m/{idx}")
        delay = 0.0005
        while True:
            try:
                present = self._store.check(key)
            except Exception:
                present = False
            if present:
                break
            now = time.monotonic()
            gone, down = self._peer_status_cadenced(peer_ranks)
            if gone and self._count("head") <= idx:
                # producers are gone AND nothing is left to drain; in-queue
                # messages from before a death are still delivered above
                if down:
                    raise ChannelPeerGoneError(
                        self.name, peer_role, down,
                        f"get waiting on slot {idx} with the queue drained")
                raise ChannelClosedError(
                    f"channel {self.name!r}: every producer "
                    f"({peer_role!r}) closed and the queue is drained")
            if now > deadline:
                self._get_timeout(idx, key, deadline_len, peer_role)
                break  # hole re-check found a late write: deliver it
            time.sleep(delay)
            delay = min(delay * 2, 0.02)
        return self._deliver(key, idx, deadline)

    def _deliver(self, key: str, idx: int, deadline: float):
        """Fetch + decode slot ``idx`` and settle its accounting.  A
        data-plane recv ``TimeoutError`` is RETRYABLE — the frames may
        still be in flight — so a single consumer releases its claim and
        keeps the envelope: the next get retries the SAME slot
        losslessly.  Every other decode failure is poison (a corrupt seal
        cannot decode differently on retry): the slot is still acked +
        deleted, so one bad message cannot shrink the backpressure window
        for the rest of the generation."""
        try:
            raw = self._store.get(key)
        except BaseException:
            # a transient store failure must not strand the claim on a
            # present, readable message — the lossless-retry contract
            if len(self._dst) == 1:
                try:
                    self._store.add(self._k("rtail"), -1)
                    self._obs("claim-return", slot=idx)
                except Exception:
                    pass
            else:
                # multi-consumer claims cannot be returned (a sibling may
                # have claimed past us); ledger the slot so a later get on
                # this endpoint re-delivers the message — or settle-acks
                # it — instead of leaking the backpressure window
                self._abandoned.setdefault(
                    idx, [time.monotonic(), _hole_settle()])
                self._obs("abandon", slot=idx)
            raise
        try:
            out = self._decode(raw, idx, deadline)
        except TimeoutError:
            if len(self._dst) == 1:
                # received frames stay held in self._partial for the retry
                self._store.add(self._k("rtail"), -1)
                self._obs("claim-return", slot=idx)
                raise
            self._consume_slot(idx, key)  # multi-consumer: lossy timeout
            raise
        except Exception:
            # poison: a corrupt seal / unpicklable payload cannot decode
            # differently on retry — consume the slot
            self._consume_slot(idx, key)
            raise
        except BaseException:
            # interrupt/exit mid-decode is NOT poison: return the claim so
            # a surviving (or respawned) single consumer retries losslessly
            if len(self._dst) == 1:
                self._store.add(self._k("rtail"), -1)
                self._obs("claim-return", slot=idx)
            raise
        self._store.delete_key(key)
        self._store.add(self._k("acks"), 1)
        self._obs("ack", slot=idx)
        self._stuck.pop(idx, None)
        self._claim_done(idx)
        self.stats["got"] += 1
        return out

    def _get_timeout(self, idx: int, key: str, deadline_len: float,
                     peer_role: str) -> None:
        """Handle a ``get`` deadline on slot ``idx``; raises unless a
        late write is found during hole healing (then returns to deliver).

        A producer killed between its head-claim and its message write
        (the solo-restart kill window lands anywhere) leaves a hole: the
        slot counter says ``idx`` exists but ``m/{idx}`` never appears.  A
        single consumer releasing its claim would re-claim the same dead
        slot on every retry — livelock.  Heal: once the hole has starved
        retries for well past any slow producer's write (2 deadlines, at
        least 5 s), ack the slot and keep the claim consumed so the next
        get moves on.  A write landing after the ack leaks one orphaned
        key until the generation reaper sweeps it."""
        claimed = self._count("head") > idx
        now = time.monotonic()
        if claimed:
            floor = _hole_settle()
            if len(self._dst) == 1:
                # threshold pinned at first observation: a later retry
                # with a longer timeout must not move the goalposts
                first, settle = self._stuck.setdefault(
                    idx, (now, max(floor, deadline_len)))
                if now - first >= settle:
                    try:
                        present = self._store.check(key)
                    except Exception:
                        present = False
                    if present:  # write landed after all — deliver late
                        self._stuck.pop(idx, None)
                        return
                    self._store.add(self._k("acks"), 1)
                    self._obs("hole-skip", slot=idx)
                    self._stuck.pop(idx, None)
                    from ..utils.logging import log_event
                    log_event("roles-channel-hole-skipped",
                              channel=self.name, slot=idx)
                    raise self._timeout_error(
                        f"get (slot {idx}: skipped a hole left by a "
                        f"producer that claimed the slot but never wrote "
                        f"it — killed mid-put; a retry claims the next "
                        f"message)", deadline_len, peer_role)
            else:
                # multi-consumer: the claim is abandoned for good (no
                # sibling will ever re-claim idx), but the producer may
                # still be mid-write — do NOT ack yet.  Remember the slot;
                # subsequent gets on this endpoint deliver a late write or
                # ack the hole once the settle window passes
                self._abandoned.setdefault(
                    idx, [now, max(floor, deadline_len)])
                self._obs("abandon", slot=idx)
        elif len(self._dst) != 1:
            # multi-consumer claim on a slot NO producer has claimed yet:
            # remember it too, but with the settle clock deferred until a
            # producer claims it — acking an unclaimed slot would drop
            # whatever a live producer eventually writes there
            self._abandoned.setdefault(
                idx, [None, max(_hole_settle(), deadline_len)])
            self._obs("abandon", slot=idx)
        if len(self._dst) == 1:
            # single consumer: release the claim so a recovered caller
            # retries the SAME slot instead of skipping it (multi-consumer
            # claims cannot be returned safely — a sibling may already
            # have claimed past us)
            self._store.add(self._k("rtail"), -1)
            self._obs("claim-return", slot=idx)
        raise self._timeout_error(
            f"get (slot {idx})", deadline_len, peer_role)

    def _sweep_abandoned(self, deadline: float):
        """Visit this endpoint's abandoned multi-consumer claims: deliver
        a slot whose write finally landed (returns the message), ack one
        that stayed a hole past its settle window (accounting intact),
        leave the rest.  Returns ``_NOTHING`` when no message surfaced."""
        now = time.monotonic()
        for idx in sorted(self._abandoned):
            key = self._k(f"m/{idx}")
            try:
                present = self._store.check(key)
            except Exception:
                present = False
            if present:
                self._abandoned.pop(idx, None)
                return self._deliver(key, idx, deadline)
            entry = self._abandoned[idx]
            if entry[0] is None:
                # settle clock starts only once a producer CLAIMS the
                # slot: an unclaimed slot costs nothing and may yet be
                # written by a perfectly healthy producer
                if self._count("head") > idx:
                    entry[0] = now
                continue
            if now - entry[0] >= entry[1]:
                self._abandoned.pop(idx, None)
                self._store.add(self._k("acks"), 1)
                self._obs("hole-skip", slot=idx)
                self._claim_done(idx)
                from ..utils.logging import log_event
                log_event("roles-channel-hole-skipped", channel=self.name,
                          slot=idx)
        return _NOTHING

    def qsize(self) -> int:
        """Unacknowledged messages currently in flight (approximate under
        concurrent claims)."""
        return max(0, self._count("head") - self._count("acks"))

    # -- latest register -----------------------------------------------------

    def put_latest(self, tree: Any, timeout: Optional[float] = None) -> int:
        """Overwrite the register with ``tree``; returns the new version
        (monotone from 1).  Never blocks on consumers — the register holds
        exactly one value."""
        self._require("src", "put_latest")
        del timeout  # symmetry with put(); a register write never blocks
        self._store.set(self._k("latest"), self._encode(tree, -1))
        self.stats["put"] += 1
        return int(self._store.add(self._k("ver"), 1))

    def get_latest(self, last_version: int = 0,
                   timeout: Optional[float] = None) -> Tuple[Any, int]:
        """Wait until the register holds a version newer than
        ``last_version``; returns ``(tree, version)``.  The value read may
        be newer than the returned version under concurrent writes —
        freshness is at-least-once."""
        self._require("dst", "get_latest")
        deadline = self._deadline(timeout)
        peer_role, peer_ranks = self._peer("dst")
        delay = 0.0005
        while True:
            ver = self._count("ver")
            if ver > int(last_version):
                break
            gone, down = self._peer_status_cadenced(peer_ranks)
            if gone:
                if down:
                    raise ChannelPeerGoneError(
                        self.name, peer_role, down,
                        f"get_latest waiting past version {last_version}")
                raise ChannelClosedError(
                    f"channel {self.name!r}: every producer "
                    f"({peer_role!r}) closed; no newer version is coming")
            if time.monotonic() > deadline:
                raise self._timeout_error(
                    f"get_latest (> v{last_version})",
                    _default_timeout() if timeout is None else timeout,
                    peer_role)
            time.sleep(delay)
            delay = min(delay * 2, 0.05)
        raw = self._store.get(self._k("latest"))
        out = self._decode(raw, -1, deadline)
        self.stats["got"] += 1  # after decode: got counts deliveries
        return out, ver

    def poll_latest(self, last_version: int = 0):
        """Non-blocking :meth:`get_latest`: ``(tree, version)`` when a
        newer version exists, else ``None``."""
        self._require("dst", "poll_latest")
        ver = self._count("ver")
        if ver <= int(last_version):
            return None
        raw = self._store.get(self._k("latest"))
        out = self._decode(raw, -1, time.monotonic() + 60.0)
        self.stats["got"] += 1  # after decode: got counts deliveries
        return out, ver

    # -- lifecycle -----------------------------------------------------------

    def close(self, mark: bool = True) -> None:
        """Close this endpoint (idempotent).  When every rank of a side
        has closed, the other side's blocked/future ops raise
        :class:`ChannelClosedError` instead of waiting — the EOF
        protocol.  ``mark=False`` detaches WITHOUT posting the EOF
        marker: the crash-unwind path, where the rank is about to be
        solo-respawned and a clean-EOF signal would be a lie."""
        if self._closed:
            return
        self._closed = True
        if not mark:
            return
        try:
            # per-RANK marker, not a counter: idempotent across solo
            # restarts and partially-attached roles (a rank closing twice
            # must not fake a second rank's EOF)
            self._store.set(self._k(f"closed/{self._rank}"), b"1")
            self._obs("close")
        except Exception:
            pass

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, etype, *exc) -> None:
        # a crash unwind is NOT a clean EOF: the supervisor may be about
        # to solo-respawn this rank, and peers must keep waiting for the
        # respawn instead of taking ChannelClosedError
        self.close(mark=etype is None)

    def __repr__(self):
        return (f"Channel({self.name!r}, {self.spec.src!r}->"
                f"{self.spec.dst!r}, kind={self.spec.kind}, "
                f"role={self._role!r}, gen={self._gen})")
