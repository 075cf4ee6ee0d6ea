"""Topology-aware host collectives — the port's copy of
``tpu_dist/collectives/topology.py``: host detection, scoped data-plane
sub-groups, the two-level (hierarchical) ring and per-collective algorithm
selection.

- **Host topology** (:func:`detect_topology`): every rank publishes a host
  fingerprint (kernel boot id and hostname, or ``TPU_DIST_HOST_ID_R{rank}``
  / ``TPU_DIST_HOST_ID``) and its core count under :func:`host_key`;
  co-located pairs get shared-memory lanes (:mod:`.shm`).
- **Scoped sub-groups** (:func:`new_group`, :class:`SubGroup`,
  :class:`GroupDataPlane`): a group with its own ring order, store-key
  namespace and wire-tag prefix; a collective on a group the caller is not
  in raises :class:`GroupMembershipError`.  These are the data plane's
  groups; ``tpu_dist_torch.dist.new_group`` (the backend's groups) is
  another thing, as in the JAX package.
- **Hierarchical ring** (:func:`hier_all_reduce`): the flat ring run in
  host-major rank order, so a chunk crosses between hosts once per
  revolution.  The fold order per chunk stays the flat ring's, so on a
  host-contiguous layout (the launcher's) it is bit for bit the flat ring.
- **Algorithm selection** (:func:`select_algo`, ``TPU_DIST_ALGO`` =
  ``auto`` | ``flat`` | ``hier`` | ``store``): by payload size and the
  store-agreed topology; with more ranks a host than cores, ``auto`` takes
  the flat float32 ring (wire compression off).  :func:`algo_counters`
  counts the choices.
"""

from __future__ import annotations

import hashlib
import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Topology", "SubGroup", "GroupDataPlane", "GroupMembershipError",
           "new_group", "detect_topology", "host_fingerprint", "host_key",
           "publish_host_fingerprint", "parse_host_record",
           "hier_all_reduce", "hier_group",
           "select_algo", "algo_counters", "reset_algo_counters"]

_DEF_HIER_THRESHOLD = 1 << 20  # hierarchical pays off once wire-bound


class GroupMembershipError(RuntimeError):
    """A collective was issued on a :class:`SubGroup` the calling rank is
    not a member of."""


# -- host fingerprints --------------------------------------------------------


def host_fingerprint(rank: Optional[int] = None) -> str:
    """This process's host identity.  Two processes report the same
    fingerprint iff they share a physical host (kernel boot id +
    hostname).  Overrides, for simulated topologies:
    ``TPU_DIST_HOST_ID_R{rank}`` (per-rank — in-process multi-rank test
    rigs), then ``TPU_DIST_HOST_ID`` (per-process — spawned benchmark
    workers)."""
    if rank is not None:
        per_rank = os.environ.get(f"TPU_DIST_HOST_ID_R{int(rank)}")
        if per_rank:
            return per_rank
    forced = os.environ.get("TPU_DIST_HOST_ID")
    if forced:
        return forced
    boot = ""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        pass
    import socket as _socket
    return f"{_socket.gethostname()}|{boot}"


def host_key(generation: int, rank: int) -> str:
    """THE store key a rank's host fingerprint lives under — one
    definition, shared by the DataPlane, rendezvous pre-flight, and
    :func:`detect_topology`, so publishers and readers cannot drift."""
    return f"tpu_dist/g{generation}/dp/host/{rank}"


def publish_host_fingerprint(store, rank: int, generation: int) -> None:
    """Publish this rank's fingerprint + core count (idempotent —
    rendezvous pre-flight and DataPlane construction both call this; same
    key, same value).  The core count rides along so the compute-bound
    autoselection guard works from STORE-AGREED numbers: with a local
    ``os.cpu_count()`` heterogeneous hosts would pick different
    algorithms and mute-deadlock."""
    import json
    store.set(host_key(generation, rank),
              json.dumps({"host": host_fingerprint(rank),
                          "cores": os.cpu_count() or 1}).encode())


def parse_host_record(raw: bytes):
    """``(fingerprint, cores)`` from a published host key (cores None for
    a legacy bare-fingerprint value)."""
    import json
    text = raw.decode()
    try:
        rec = json.loads(text)
        return str(rec["host"]), int(rec.get("cores") or 0) or None
    except (ValueError, KeyError, TypeError):
        return text, None


# -- topology -----------------------------------------------------------------


class Topology:
    """Which ranks share a host.  ``hosts`` maps fingerprint → sorted
    member ranks, hosts ordered by their smallest member."""

    def __init__(self, hosts_by_rank: Sequence[str],
                 cores_by_rank: Optional[Sequence[Optional[int]]] = None):
        self.hosts_by_rank = list(hosts_by_rank)
        self.world = len(self.hosts_by_rank)
        self.cores_by_rank = (list(cores_by_rank) if cores_by_rank
                              else [None] * self.world)
        by_host: Dict[str, List[int]] = {}
        for r, h in enumerate(self.hosts_by_rank):
            by_host.setdefault(h, []).append(r)
        self.hosts: Dict[str, List[int]] = dict(
            sorted(by_host.items(), key=lambda kv: min(kv[1])))

    @property
    def min_cores(self) -> Optional[int]:
        """Smallest published core count across ranks — the store-agreed
        core budget the compute-bound guard uses, so every rank (on
        heterogeneous hosts too) reaches the identical decision.  None
        when no rank published one (legacy / hand-built topologies)."""
        known = [c for c in self.cores_by_rank if c]
        return min(known) if known else None

    @property
    def nhosts(self) -> int:
        return len(self.hosts)

    @property
    def max_ranks_per_host(self) -> int:
        return max((len(rs) for rs in self.hosts.values()), default=1)

    @property
    def colocated(self) -> bool:
        """Any host holding more than one rank?"""
        return self.max_ranks_per_host > 1

    def host_of(self, rank: int) -> str:
        return self.hosts_by_rank[rank]

    def host_major_order(self) -> List[int]:
        """Global ranks grouped by host (hosts by smallest member, members
        ascending) — the two-level ring order.  Identity whenever the
        launcher laid ranks out host-contiguously."""
        out: List[int] = []
        for members in self.hosts.values():
            out.extend(members)
        return out

    def is_host_major(self) -> bool:
        return self.host_major_order() == list(range(self.world))

    def __repr__(self):
        return (f"Topology(world={self.world}, hosts="
                f"{ {h: rs for h, rs in self.hosts.items()} })")


def detect_topology(dp, timeout: Optional[float] = None) -> Topology:
    """The gang's host topology, read from the fingerprints every rank
    published to the control-plane store (bounded wait — a peer that died
    before publishing surfaces as a named ``TimeoutError``, not a hang).
    Cached on the DataPlane: one store round per incarnation."""
    cached = getattr(dp, "_topo_cache", None)
    if cached is not None:
        return cached
    from . import transport as _t
    store, gen, n = dp._store, dp.generation, dp.num_processes
    keys = [host_key(gen, r) for r in range(n)]
    if timeout is None:
        timeout = _t._default_timeout()
    try:
        store.wait(keys, timeout=timeout if timeout > 0 else None)
    except TimeoutError as e:
        raise TimeoutError(
            f"topology detection: not every rank published a host "
            f"fingerprint within {timeout:.0f}s (a peer likely died before "
            f"its data plane came up): {e}") from e
    records = [parse_host_record(store.get(k)) for k in keys]
    topo = Topology([h for h, _ in records], [c for _, c in records])
    dp._topo_cache = topo
    return topo


# -- scoped sub-groups --------------------------------------------------------


def _digest8(items) -> str:
    return hashlib.sha256(repr(list(items)).encode()).hexdigest()[:8]


# membership -> how many groups with that exact member list this process
# has created; SPMD-consistent for the same reason the collective sequence
# counters are (every rank creates groups in the same program order)
_group_instances: Dict[Tuple[int, ...], int] = {}
_group_mu = threading.Lock()


class SubGroup:
    """A scoped sub-group of the flat rank space (``torch.distributed
    .new_group`` analogue) — create via :func:`new_group`.

    - ``members``: global ranks in **ring order** (the order given).
    - ``rank`` / ``num_processes``: this process's group-local rank (None
      for non-members) and the group size — the same duck-type every eager
      collective and ring function already consumes, so a SubGroup drops
      in wherever a ProcessGroup shim does.
    - ``group_id``: deterministic id (ordered-membership digest + a
      per-membership creation counter) — namespaces store keys
      (``tpu_dist/g{gen}/grp{id}/…``) and data-plane wire tags, so two
      groups' collectives can never cross.
    - ``set_scope``: digest of the *sorted* member set — the sanitizer
      signature namespace.  Ranks whose group objects diverge only in
      order/identity still land in the same signature keyspace, so the
      mismatch is *named* (both memberships) rather than a timeout.
    """

    def __init__(self, members: Sequence[int], parent_rank: int,
                 parent_world: int, instance: int):
        members = [int(r) for r in members]
        if len(set(members)) != len(members):
            raise ValueError(f"duplicate ranks in group members: {members}")
        if not members:
            raise ValueError("a group needs at least one member")
        for r in members:
            if not 0 <= r < parent_world:
                raise ValueError(
                    f"group member {r} out of range (world {parent_world})")
        self.members: Tuple[int, ...] = tuple(members)
        self.parent_rank = int(parent_rank)
        self.parent_world = int(parent_world)
        self.group_id = f"{_digest8(self.members)}.{instance}"
        self.member_hash = _digest8(self.members)
        self.set_scope = _digest8(sorted(self.members))
        self.num_processes = len(self.members)
        self.rank: Optional[int] = (
            self.members.index(self.parent_rank)
            if self.parent_rank in self.members else None)
        self._views: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()

    def describe(self) -> str:
        return f"grp{self.group_id}{list(self.members)}"

    def require_member(self, what: str = "collective") -> int:
        """This process's group-local rank; raises
        :class:`GroupMembershipError` for non-members — a non-member
        joining a group collective would desynchronize every member's ring
        tags and sanitizer sequence, so it fails loudly *before* payload
        moves."""
        if self.rank is None:
            raise GroupMembershipError(
                f"rank {self.parent_rank} issued a {what} on "
                f"{self.describe()} but is not a member — every "
                f"participant of a sub-group collective must be in its "
                f"member list")
        return self.rank

    def view(self, dp) -> "GroupDataPlane":
        """The group-scoped DataPlane view over ``dp`` (cached per dp)."""
        got = self._views.get(id(dp))
        if got is None or got._dp is not dp:
            got = GroupDataPlane(dp, self)
            self._views[id(dp)] = got
        return got

    def __repr__(self):
        return (f"SubGroup({self.describe()}, rank={self.rank}, "
                f"world={self.parent_world})")


def new_group(ranks: Sequence[int], group=None) -> SubGroup:
    """Create a scoped sub-group from global ``ranks`` (ring order = list
    order).  Like torch's ``new_group``: **every rank of the parent group
    must call this with the identical list, in the same program order**,
    whether or not it is a member — the group id that namespaces keys and
    tags is derived from the list and a creation counter, so divergent
    lists produce divergent groups (the sanitizer then names both
    memberships)."""
    if group is None:
        from ..dist import get_default_group
        group = get_default_group()
    members = tuple(int(r) for r in ranks)
    with _group_mu:
        instance = _group_instances.get(members, 0)
        _group_instances[members] = instance + 1
    return SubGroup(members, group.rank, group.num_processes, instance)


class GroupDataPlane:
    """Group-scoped view of a :class:`~tpu_dist_torch.collectives.transport
    .DataPlane`: group-local ranks in, global ranks out, every wire tag
    prefixed with the group id.  Exposes the exact method surface the ring
    collectives and eager routing consume, so they run unchanged inside a
    group."""

    def __init__(self, dp, group: SubGroup):
        group.require_member("data-plane collective")
        self._dp = dp
        self.group = group
        self.rank = group.rank
        self.num_processes = group.num_processes
        self.generation = dp.generation

    def _g(self, r: int) -> int:
        if not 0 <= r < self.num_processes:
            raise ValueError(
                f"group-local rank {r} out of range for "
                f"{self.group.describe()}")
        return self.group.members[r]

    def _t(self, tag: str) -> str:
        return f"grp{self.group.group_id}/{tag}"

    def send_array(self, dst: int, tag: str, arr) -> int:
        return self._dp.send_array(self._g(dst), self._t(tag), arr)

    def send_quant(self, dst: int, tag: str, chunk) -> int:
        return self._dp.send_quant(self._g(dst), self._t(tag), chunk)

    def recv_array(self, src: int, tag: str, timeout=None):
        return self._dp.recv_array(self._g(src), self._t(tag),
                                   timeout=timeout)

    def recv_array_dual(self, src: int, tag: str, alt_check=None,
                        timeout=None):
        return self._dp.recv_array_dual(self._g(src), self._t(tag),
                                        alt_check=alt_check,
                                        timeout=timeout)

    def try_recv_array(self, src: int, tag: str):
        return self._dp.try_recv_array(self._g(src), self._t(tag))

    def peer_gone(self, src: int):
        return self._dp.peer_gone(self._g(src))

    def gone_error(self, peer: int, detail: str = ""):
        note = f"group-local rank {peer} of {self.group.describe()}"
        return self._dp.gone_error(
            self._g(peer), f"{detail}; {note}" if detail else note)

    def shm_active(self, dst: int) -> bool:
        return self._dp.shm_active(self._g(dst))

    def send_chunk_bytes(self, dst: int, base: int) -> int:
        return self._dp.send_chunk_bytes(self._g(dst), base)

    def __repr__(self):
        return f"GroupDataPlane({self.group.describe()}, over {self._dp!r})"


# -- hierarchical (two-level) ring --------------------------------------------

# dp -> (host-major order, spanning SubGroup); weak so in-process test rigs
# with many DataPlanes do not pin them
_hier_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_hier_mu = threading.Lock()


def hier_group(dp, topo: Optional[Topology] = None) -> SubGroup:
    """The all-ranks SubGroup in host-major ring order — the two-level
    ring's backbone (cached per DataPlane; the group id therefore stays
    stable across calls, keeping wire tags and engine keys steady)."""
    if topo is None:
        topo = detect_topology(dp)
    order = tuple(topo.host_major_order())
    with _hier_mu:
        hit = _hier_cache.get(dp)
        if hit is not None and hit[0] == order:
            return hit[1]
        grp = SubGroup(order, dp.rank, dp.num_processes, instance=0)
        _hier_cache[dp] = (order, grp)
        return grp


def hier_all_reduce(dp, x, op: str = "sum", tag: str = "har",
                    comm_dtype=None, bounds=None, quant_residual=None,
                    stats=None, topo: Optional[Topology] = None):
    """Two-level (hierarchical) ring all-reduce: the ring run in host-major
    order, intra-host hops over shared memory, one inter-host hop per host
    per revolution (see the module docstring for the phase structure and
    the bitwise contract).  Signature-compatible with
    :func:`~tpu_dist_torch.collectives.ring.ring_all_reduce` — ``comm_dtype``
    (cast or quant schemes), custom ``bounds``, error-feedback residuals
    and ``stats`` all pass straight through, because this *is* that ring,
    over a re-ordered group view."""
    if topo is None:
        topo = detect_topology(dp)
    from . import ring as _ring
    gdp = hier_group(dp, topo).view(dp)
    return _ring.ring_all_reduce(gdp, x, op=op, tag=tag,
                                 comm_dtype=comm_dtype, bounds=bounds,
                                 quant_residual=quant_residual, stats=stats)


# -- algorithm autoselection --------------------------------------------------

_algo_mu = threading.Lock()
_algo_counts: Dict[str, int] = {}

_ALGO_MODES = ("auto", "flat", "hier", "store")


def algo_mode() -> str:
    """``TPU_DIST_ALGO``: ``auto`` (default — select by size + topology),
    ``flat`` / ``hier`` (force the ring shape; explicit modes also keep
    the configured ``comm_dtype``, compute-bound or not), ``store``
    (bypass the data plane entirely)."""
    mode = os.environ.get("TPU_DIST_ALGO", "auto").strip().lower()
    if not mode:
        return "auto"
    if mode not in _ALGO_MODES:
        raise ValueError(
            f"TPU_DIST_ALGO={mode!r}: expected one of {_ALGO_MODES}")
    return mode


def _cores(topo: Optional[Topology] = None) -> int:
    """Core budget for the compute-bound guard: ``TPU_DIST_ALGO_CORES``
    (launcher-uniform override), else the STORE-AGREED minimum core count
    the ranks published with their fingerprints, else local
    ``os.cpu_count()``.  Preferring the published minimum keeps the guard
    rank-consistent on heterogeneous hosts — a local count would make
    big-host ranks pick ``hier`` while small-host ranks pick ``flat``,
    and the mismatched ring tags would mute-deadlock."""
    try:
        forced = int(os.environ.get("TPU_DIST_ALGO_CORES", "0"))
    except ValueError:
        forced = 0
    if forced > 0:
        return forced
    agreed = topo.min_cores if topo is not None else None
    return agreed if agreed else (os.cpu_count() or 1)


def _hier_threshold() -> int:
    try:
        return int(os.environ.get("TPU_DIST_HIER_THRESHOLD",
                                  str(_DEF_HIER_THRESHOLD)))
    except ValueError:
        return _DEF_HIER_THRESHOLD


def select_algo(nbytes: int, dp=None,
                topo: Optional[Topology] = None) -> Tuple[str, bool]:
    """Choose the ring shape for one data-plane reduction leaf: returns
    ``(algo, comm_ok)`` with ``algo`` ∈ {``"flat"``, ``"hier"``,
    ``"store"``} and ``comm_ok=False`` meaning *suppress wire
    compression* (run plain f32).  ``"store"`` only under the explicit
    ``TPU_DIST_ALGO=store`` override — the eager router keeps such leaves
    off the data plane before selection is ever consulted.

    ``auto`` policy, in order:

    1. no topology available (store-less rig) → flat, compression kept;
    2. no co-located ranks → flat (there is nothing hierarchical to do);
    3. **compute-bound guard**: ranks-per-host > cores → flat **f32** —
       with more ranks than cores the ring serializes on CPU and any
       per-hop arithmetic (quant encode/decode, dtype casts) lands on the
       critical path; PR 8 measured the int8 wire *inverting* (21.5 vs
       30.5 MB/s) at exactly this point (world 4, 2 cores);
    4. payload below ``TPU_DIST_HIER_THRESHOLD`` (1 MiB) → flat (the
       re-ordered ring buys nothing until the wire dominates);
    5. otherwise → hierarchical.

    The decision depends only on launcher-uniform env, payload size, and
    the store-agreed topology — every rank answers identically."""
    mode = algo_mode()
    if mode == "flat":
        return "flat", True
    if mode == "hier":
        return "hier", True
    if mode == "store":
        # the eager router already short-circuits store mode before any
        # leaf reaches here (_dp_leaf_ok); direct callers get the honest
        # answer rather than a fall-through to the auto policy
        return "store", True
    if topo is None and dp is not None:
        topo = detect_topology(dp)
    if topo is None or not topo.colocated:
        return "flat", True
    if topo.max_ranks_per_host > _cores(topo):
        return "flat", False
    if int(nbytes) < _hier_threshold():
        return "flat", True
    return "hier", True


def record_algo(op: str, algo: str) -> None:
    """Count one algorithm choice and stamp it on the enclosing obs span."""
    with _algo_mu:
        key = f"{op}/{algo}"
        _algo_counts[key] = _algo_counts.get(key, 0) + 1
    try:
        from ..obs import hooks as _hooks
        _hooks.note_algo(algo)
    except Exception:
        pass


def algo_counters(reset: bool = False) -> Dict[str, int]:
    """Per-``op/algo`` selection counts (tests/benchmarks introspection)."""
    with _algo_mu:
        out = dict(_algo_counts)
        if reset:
            _algo_counts.clear()
    return out


def reset_algo_counters() -> None:
    with _algo_mu:
        _algo_counts.clear()
