"""Deterministic *network* fault injection — counterpart of
``tpu_dist/resilience/netchaos.py`` (the grammar, the counting and the bit
flips are the JAX package's, so a spec replays the same failure in either
package): the data-plane side of :mod:`tpu_dist_torch.resilience.chaos`.

The process-fault harness (``TPU_DIST_CHAOS``) kills, stalls and starves
whole ranks; this module attacks the wires between them.  Faults are
declared in the same compact grammar, via ``TPU_DIST_NETCHAOS``::

    TPU_DIST_NETCHAOS="corrupt:surface=tcp,rank=1,frame=2"
    TPU_DIST_NETCHAOS="partition:rank=0,peer=1;delay:surface=serve,delay=0.05"

Grammar: ``fault[;fault...]`` where ``fault = kind[:k=v[,k=v...]]``.  Kinds
(all applied at the *sending* side of a wire, so a spec replays the same
failure on every run):

=================  ==========================================================
``partition``      rank-pair blackhole: matching frames never leave
                   (persistent from ``frame=``).  The receiver's
                   collective watchdog (``TPU_DIST_COLL_TIMEOUT``) turns
                   the wedge into a named
                   :class:`~tpu_dist_torch.collectives.transport.CollectiveTimeoutError`
``delay``          sleep ``delay`` seconds before each matching frame
                   (persistent): a congested link's latency
``conn-reset``     hard RST mid-frame at the ``frame``-th matching frame
                   (one-shot): both sides raise
                   :class:`~tpu_dist_torch.collectives.transport.PeerGoneError`
``truncate``       send a header promising N payload bytes, deliver half,
                   then close (one-shot): the receiver's framing raises a
                   truncated-frame ``ConnectionError``
``corrupt``        flip ``flips`` payload bits (seeded, deterministic;
                   one-shot).  With frame checksums armed
                   (``TPU_DIST_FRAME_CRC``, default on) the receiver
                   raises :class:`~tpu_dist_torch.collectives.transport.FrameCorruptError`
                   naming src, tag and offset — never silently wrong numbers
``slow-drip``      throttle matching frames to ``rate`` bytes/s
                   (persistent): a degraded NIC
=================  ==========================================================

Scoping params (all optional): ``rank=`` the *sending* rank, ``peer=`` the
destination rank, ``node=`` the node this process runs on (``NODE_RANK``
or ``TPU_DIST_NODE_ID``): ``partition:surface=store,node=1`` blackholes
the store wire of EVERY process on node 1 and nothing elsewhere, the shape
of a top-of-rack switch death; ``surface=`` one of ``tcp`` (a data-plane
frame), ``shm`` (a shared-memory lane's payload), ``store`` (a
control-plane client request), ``serve`` (a serving-wire frame);
``frame=`` the 1-based index of the matching frame or op at which the
fault fires (persistent kinds stay armed from there, one-shot kinds fire
once).  ``corrupt`` also takes ``flips=`` (bit count, 1) and ``seed=``.

Every trigger is *counted*, never timed, so the same spec reproduces the
same failure at the same frame.

Injection points (each probes :func:`active` through a guarded call-time
import — one global read when nothing is installed):

- ``tpu_dist_torch/collectives/transport.py`` — the frame boundary
  (``tcp``) and the SHM lane's staging (``shm``).  An ``shm`` conn-reset or
  truncate breaks the lane *before* the frame header leaves, which drives
  the lane's mid-stream degradation: the frame (and every later one) ships
  inline over the established socket and the collective completes bit for
  bit;
- ``tpu_dist_torch/dist/store.py`` — the pure-Python store client
  (``store``): ``partition`` raises a named ``ConnectionError``,
  ``conn-reset`` closes the socket before the op (the reconnect path),
  ``corrupt`` flips bits of the request payload;
- ``tpu_dist_torch/serve/frontend.py`` — the serving wire (``serve``):
  frames are checksummed, so ``corrupt`` fails the connection with a
  ``FrameCorruptError`` and the client turns it into named handle errors.

The NCCL route has no surface, as the JAX package's mesh has none: a
collective on a group's NCCL backend never crosses these wires, and no
spec reaches it.  A spec that names an unknown kind, surface or parameter
raises ``ValueError``; nothing is ignored.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import List, Optional

__all__ = ["NetChaos", "NetFault", "parse", "install", "install_from_env",
           "uninstall", "active", "NET_KINDS", "SURFACES"]

NET_KINDS = ("partition", "delay", "conn-reset", "truncate", "corrupt",
             "slow-drip")
SURFACES = ("tcp", "shm", "store", "serve")

# kinds that stay armed from frame= on, against those firing there once
_PERSISTENT = frozenset({"partition", "delay", "slow-drip"})
_INT_PARAMS = ("rank", "peer", "node", "frame", "flips", "seed")


@dataclasses.dataclass(frozen=True)
class NetFault:
    kind: str
    rank: Optional[int] = None     # sending rank (None = every rank)
    peer: Optional[int] = None     # destination rank (None = every peer)
    node: Optional[int] = None     # this process's node (None = every node)
    surface: Optional[str] = None  # tcp | shm | store | serve (None = all)
    frame: int = 1                 # 1-based matching-frame trigger index
    delay: float = 0.0             # delay kind
    rate: float = 0.0              # slow-drip bytes/s
    flips: int = 1                 # corrupt bit flips
    seed: int = 0                  # corrupt determinism

    def __post_init__(self):
        if self.kind not in NET_KINDS:
            raise ValueError(f"unknown netchaos fault kind {self.kind!r}; "
                             f"one of {NET_KINDS}")
        if self.surface is not None and self.surface not in SURFACES:
            raise ValueError(f"unknown netchaos surface {self.surface!r}; "
                             f"one of {SURFACES}")
        if self.frame < 1:
            raise ValueError("frame= is 1-based (first matching frame)")
        if self.kind == "delay" and self.delay <= 0:
            raise ValueError("delay fault requires delay=<seconds>")
        if self.kind == "slow-drip" and self.rate <= 0:
            raise ValueError("slow-drip fault requires rate=<bytes/sec>")
        if self.flips < 1:
            raise ValueError("corrupt needs flips >= 1")


def parse(spec: str) -> List[NetFault]:
    """Parse a ``TPU_DIST_NETCHAOS`` spec (the module docstring's
    grammar)."""
    faults = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        kind, _, params = part.partition(":")
        kwargs = {}
        for kv in filter(None, (p.strip() for p in params.split(","))):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"malformed netchaos param {kv!r} in "
                                 f"{part!r} (expected key=value)")
            k = k.strip()
            if k in _INT_PARAMS:
                kwargs[k] = int(v)
            elif k in ("delay", "rate"):
                kwargs[k] = float(v)
            elif k == "surface":
                kwargs[k] = v.strip().lower()
            else:
                raise ValueError(f"unknown netchaos param {k!r} in {part!r}")
        faults.append(NetFault(kind.strip(), **kwargs))
    if not faults:
        raise ValueError(f"empty netchaos spec {spec!r}")
    return faults


class NetChaos:
    """The installed network-fault set, bound to this process's rank.

    :meth:`plan` is the one trigger point every injection site calls once
    a frame or op: it counts the frame against each matching fault's own
    counter and returns the fault that fires (or None).  Counters are per
    fault and per process, under one lock — deterministic, as every send
    site serializes through its per-destination lock and the store and
    serve clients issue requests in program order."""

    def __init__(self, faults: List[NetFault], rank: Optional[int] = None,
                 node: Optional[int] = None):
        self.faults = list(faults)
        self.rank = (rank if rank is not None
                     else int(os.environ.get("RANK", "0") or 0))
        if node is None:
            raw = (os.environ.get("NODE_RANK")
                   or os.environ.get("TPU_DIST_NODE_ID"))
            node = int(raw) if raw not in (None, "") else None
        # a node= fault in a process with NO node identity stays disarmed:
        # firing it everywhere would turn a one-cell partition into a
        # cluster-wide outage the spec never asked for
        self.node = node
        self._mu = threading.Lock()
        self._counts = [0] * len(self.faults)
        self._fired = [False] * len(self.faults)

    def _matches(self, f: NetFault, surface: str, src: Optional[int],
                 dst: Optional[int]) -> bool:
        if f.surface is not None and f.surface != surface:
            return False
        if f.node is not None and f.node != self.node:
            return False
        who = src if src is not None else self.rank
        if f.rank is not None and f.rank != who:
            return False
        if f.peer is not None and dst is not None and f.peer != dst:
            return False
        return True

    def plan(self, surface: str, src: Optional[int] = None,
             dst: Optional[int] = None) -> Optional[NetFault]:
        """Count one frame or op on ``surface`` (from ``src`` to ``dst``)
        and return the fault that fires on it, if any."""
        fired = None
        with self._mu:
            for i, f in enumerate(self.faults):
                if not self._matches(f, surface, src, dst):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                hit = n >= f.frame if f.kind in _PERSISTENT else n == f.frame
                if hit and fired is None:
                    fired = f
                    if not self._fired[i]:
                        self._fired[i] = True
                        self._log(f, surface, src, dst, n)
        return fired

    @staticmethod
    def _log(f: NetFault, surface, src, dst, n) -> None:
        try:
            from ..utils.logging import log_event
            log_event(f"netchaos-{f.kind}", surface=surface, src=src,
                      dst=dst, frame=n)
        except Exception:
            pass  # diagnostics must never break the data path

    @staticmethod
    def corrupt_parts(fault: NetFault, parts):
        """Flip ``fault.flips`` distinct bits across the concatenated
        payload parts, seeded by the fault and the total length (the JAX
        package's draw, so the same spec flips the same bits in either
        package).  Returns fresh buffers: the caller's arrays (live
        gradients) are never changed; this is corruption *on the wire*,
        after any checksum was taken."""
        views = [memoryview(p).cast("B") for p in parts]
        total = sum(len(v) for v in views)
        if total == 0:
            return parts
        rng = random.Random((int(fault.seed) << 24) ^ total)
        out = [bytearray(v) for v in views]
        # DISTINCT bit positions: a bit flipped twice would cancel, a
        # "corruption" that silently passes the checksum
        nbits = total * 8
        for pos in rng.sample(range(nbits), min(max(1, fault.flips),
                                                nbits)):
            byte, bit = divmod(pos, 8)
            for seg in out:
                if byte < len(seg):
                    seg[byte] ^= 1 << bit
                    break
                byte -= len(seg)
        return out


_ACTIVE: Optional[NetChaos] = None
_ACTIVE_SPEC: Optional[str] = None


def install(spec: str, rank: Optional[int] = None) -> NetChaos:
    """Parse ``spec`` and make it the process's active network chaos
    (replacing any set installed before)."""
    global _ACTIVE, _ACTIVE_SPEC
    nc = NetChaos(parse(spec), rank=rank)
    _ACTIVE, _ACTIVE_SPEC = nc, spec
    try:
        from ..utils.logging import log_event
        log_event("netchaos-installed", rank=nc.rank, spec=spec)
    except Exception:
        pass
    return nc


def install_from_env() -> Optional[NetChaos]:
    """Install from ``TPU_DIST_NETCHAOS`` when it is set (idempotent: the
    same spec keeps the installed set and its frame counters); else the
    installed set, or None."""
    spec = os.environ.get("TPU_DIST_NETCHAOS")
    if not spec:
        return _ACTIVE
    if _ACTIVE is not None and _ACTIVE_SPEC == spec:
        return _ACTIVE
    return install(spec)


def uninstall() -> None:
    global _ACTIVE, _ACTIVE_SPEC
    _ACTIVE, _ACTIVE_SPEC = None, None


def active() -> Optional[NetChaos]:
    """The installed :class:`NetChaos`, or None: THE gate every injection
    site checks (one global read when disarmed)."""
    return _ACTIVE
