"""Role graphs — named-role process graphs over the flat rank space
(counterpart of ``tpu_dist/roles/graph.py``; :meth:`RoleGraph.to_json` is
byte-equal to the JAX package's, since the launcher publishes it and
either package's workers read it).

A job whose processes play different **roles** (actor/learner, parameter
server/worker) instead of one homogeneous SPMD world — the Launchpad
programming model — on the port's own plumbing: scoped
:class:`~tpu_dist_torch.collectives.topology.SubGroup` rings for
intra-role collectives, the control-plane store for registration and small
payloads, and the host data plane for large array frames.

A :class:`RoleGraph` is the static spec:

- **roles** — ordered :class:`Role` declarations.  Each role owns a
  contiguous **global-rank span** in declaration order (``learner:1,
  actor:4`` → learner = rank 0, actors = ranks 1..4), so the flat rank
  API (store keys, data-plane addressing, heartbeats) works unchanged
  underneath, and every rank also gets ``role`` / ``role_rank`` /
  ``role_world`` and a pre-built :class:`SubGroup` over its role's span.
- **channels** — :class:`ChannelSpec` declarations naming typed queues
  between roles (:mod:`.channel`).  A channel whose ``src``/``dst`` names
  no declared role is a named :class:`RoleGraphError` at construction.

Validation is eager and named: duplicate role names, non-positive world
sizes, duplicate channel names and dangling channel endpoints all raise
:class:`RoleGraphError`.

The launcher (``python -m tpu_dist_torch.launch --roles ...`` /
:func:`tpu_dist_torch.roles.spawn_graph`) publishes the agreed role map
under the generation-scoped store key (:func:`map_key`), so every worker
— and the sanitizer, obs and data-plane diagnostics — can key on
``(role, role_rank)`` instead of a bare flat rank.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Role", "ChannelSpec", "RoleGraph", "RoleGraphError",
           "parse_roles_spec", "map_key", "down_key",
           "set_current", "clear_current", "current_role", "current_graph",
           "role_label"]

# role/channel names travel inside store keys, spec strings and wire tags:
# keep them to one safe token
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")

_RESTART_POLICIES = ("gang", "solo")


class RoleGraphError(ValueError):
    """A malformed role graph (duplicate/unknown names, bad sizes,
    dangling channel endpoints) or a role-map disagreement between the
    launcher and a worker's graph literal."""


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise RoleGraphError(
            f"{kind} name {name!r} is not a valid token (letters, digits, "
            f"'_', '.', '-'; must not start with punctuation) — names "
            f"travel inside store keys and launch specs")
    return name


@dataclasses.dataclass(frozen=True)
class Role:
    """One named role: ``world`` ranks running the same entrypoint.

    ``restart`` is the supervised-restart policy the role's ranks get
    from :func:`~tpu_dist_torch.roles.spawn_graph`:

    - ``"gang"`` (default) — a death here fails the whole graph round;
      the supervisor tears everyone down and relaunches the gang (the
      classic learner/parameter-server policy: peers hold state derived
      from this rank).
    - ``"solo"`` — the dead rank is respawned alone, same generation;
      every other role keeps running and store-backed channels resume by
      name (the actor/rollout-worker policy: producers are stateless
      between messages).

    ``node`` is the optional placement pin (``actor:4@1`` in the launcher
    grammar): all of the role's ranks run on that node of a multi-launcher
    cluster.  ``None`` means node 0 — placement must be deterministic
    across launchers, so an unpinned role cannot float.  Each node's
    launcher supervises the ranks pinned to it
    (:func:`tpu_dist_torch.roles.launcher.local_ranks_of`), and every
    launcher refuses a pin outside the cluster
    (:func:`tpu_dist_torch.cluster.validate_placement`).
    """
    name: str
    world: int
    restart: str = "gang"
    entry: Optional[str] = None   # per-role entrypoint override (launcher)
    node: Optional[int] = None    # placement pin (None -> node 0)

    def __post_init__(self):
        _check_name("role", self.name)
        if not isinstance(self.world, int) or self.world <= 0:
            raise RoleGraphError(
                f"role {self.name!r} needs a positive world size, got "
                f"{self.world!r}")
        if self.restart not in _RESTART_POLICIES:
            raise RoleGraphError(
                f"role {self.name!r}: restart policy {self.restart!r} "
                f"must be one of {_RESTART_POLICIES}")
        if self.node is not None and (not isinstance(self.node, int)
                                      or self.node < 0):
            raise RoleGraphError(
                f"role {self.name!r}: node pin {self.node!r} must be a "
                f"non-negative node id")


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """A typed channel between two roles (:mod:`.channel`).

    ``kind``:

    - ``"queue"`` — FIFO message queue, bounded to ``depth`` in-flight
      messages (``put`` blocks on backpressure).  SPSC and MPMC alike:
      producers/consumers claim slots through atomic store counters, so
      any ``src``-role rank may put and any ``dst``-role rank may get.
    - ``"latest"`` — a versioned register (``put_latest`` overwrites,
      ``get_latest`` waits for a newer version): the parameter-broadcast
      shape, where consumers want the freshest value, not every value.

    Verification hints for the static graph verifier
    (:mod:`tpu_dist_torch.analysis.protocol`); pure annotations with no
    runtime effect, the same as the JAX package's, so the spec and
    :meth:`RoleGraph.to_json` match it:

    - ``payload_bytes`` — expected per-message array payload.  With a
      multi-rank consumer role the payload cannot ride the p2p lane, so
      a hint at/above ``TPU_DIST_DP_THRESHOLD`` makes the verifier name
      the store funnel (TD104) instead of production discovering it.
    - ``drain`` — how the consumer role services this channel:
      ``"inline"`` in its main loop (default), or ``"dedicated"`` — the
      role drains it on a dedicated thread that never blocks in the
      role's own puts (e.g. the disagg decode leader's KV receive
      loop).  Dedicated-drain edges cannot be the blocked link of a
      bounded-channel wait-for cycle, so TD101 excludes them.
    - ``credits`` — claim-discipline bound: the producer role promises
      to keep at most ``credits`` messages unacknowledged in flight on
      this edge (it interleaves puts with claims of its own inbound
      edges, the 1F1B pipeline shape).  A cycle in which *every* edge
      carries a credits annotation with ``depth >= credits`` cannot
      deadlock — no put ever reaches the backpressure wall — so TD101
      admits it; an annotated edge with ``depth < credits`` is a
      deadlock finding with a credit-overflow witness.
    """
    name: str
    src: str
    dst: str
    depth: int = 8
    kind: str = "queue"
    payload_bytes: Optional[int] = None
    drain: str = "inline"
    credits: Optional[int] = None

    def __post_init__(self):
        _check_name("channel", self.name)
        if self.kind not in ("queue", "latest"):
            raise RoleGraphError(
                f"channel {self.name!r}: kind {self.kind!r} must be "
                f"'queue' or 'latest'")
        if not isinstance(self.depth, int) or self.depth <= 0:
            raise RoleGraphError(
                f"channel {self.name!r} needs a positive depth, got "
                f"{self.depth!r}")
        if self.drain not in ("inline", "dedicated"):
            raise RoleGraphError(
                f"channel {self.name!r}: drain {self.drain!r} must be "
                f"'inline' or 'dedicated'")
        if self.payload_bytes is not None and (
                not isinstance(self.payload_bytes, int)
                or self.payload_bytes <= 0):
            raise RoleGraphError(
                f"channel {self.name!r}: payload_bytes "
                f"{self.payload_bytes!r} must be a positive byte count")
        if self.credits is not None and (
                not isinstance(self.credits, int) or self.credits <= 0):
            raise RoleGraphError(
                f"channel {self.name!r}: credits {self.credits!r} must be "
                f"a positive in-flight message bound")


class RoleGraph:
    """Validated role-graph spec: ordered roles with contiguous global-
    rank spans, plus the channels between them.  See the module docstring
    for the model; construction raises :class:`RoleGraphError` on any
    inconsistency."""

    def __init__(self, roles: Sequence[Role],
                 channels: Sequence[ChannelSpec] = ()):
        roles = list(roles)
        if not roles:
            raise RoleGraphError("a role graph needs at least one role")
        seen: Dict[str, Role] = {}
        for r in roles:
            if not isinstance(r, Role):
                raise RoleGraphError(f"roles must be Role instances, got "
                                     f"{r!r}")
            if r.name in seen:
                raise RoleGraphError(
                    f"duplicate role name {r.name!r} (worlds "
                    f"{seen[r.name].world} and {r.world}) — role names "
                    f"must be unique")
            seen[r.name] = r
        self.roles: Tuple[Role, ...] = tuple(roles)
        self._by_name = seen
        self._spans: Dict[str, range] = {}
        start = 0
        for r in roles:
            self._spans[r.name] = range(start, start + r.world)
            start += r.world
        self.world = start

        chans: Dict[str, ChannelSpec] = {}
        for c in channels:
            if not isinstance(c, ChannelSpec):
                raise RoleGraphError(
                    f"channels must be ChannelSpec instances, got {c!r}")
            if c.name in chans:
                raise RoleGraphError(f"duplicate channel name {c.name!r}")
            for end, role_name in (("src", c.src), ("dst", c.dst)):
                if role_name not in self._by_name:
                    raise RoleGraphError(
                        f"channel {c.name!r}: {end}={role_name!r} names no "
                        f"declared role (dangling endpoint); roles are "
                        f"{[r.name for r in roles]}")
            chans[c.name] = c
        self.channels: Tuple[ChannelSpec, ...] = tuple(chans.values())
        self._chan_by_name = chans

    # -- lookups -------------------------------------------------------------

    def role(self, name: str) -> Role:
        try:
            return self._by_name[name]
        except KeyError:
            raise RoleGraphError(
                f"no role named {name!r}; roles are "
                f"{[r.name for r in self.roles]}") from None

    def channel_spec(self, name: str) -> ChannelSpec:
        try:
            return self._chan_by_name[name]
        except KeyError:
            raise RoleGraphError(
                f"no channel named {name!r}; channels are "
                f"{[c.name for c in self.channels]}") from None

    def span(self, name: str) -> range:
        """The global-rank span of role ``name``."""
        self.role(name)
        return self._spans[name]

    def role_of(self, rank: int) -> Tuple[str, int]:
        """``(role_name, role_rank)`` of global ``rank``."""
        for name, span in self._spans.items():
            if rank in span:
                return name, rank - span.start
        raise RoleGraphError(
            f"rank {rank} out of range for this graph (world {self.world})")

    def label(self, rank: int) -> str:
        """Human label: ``actor[2]`` for the third actor rank."""
        name, rr = self.role_of(rank)
        return f"{name}[{rr}]"

    def subgroup(self, name: str, rank: int):
        """The intra-role :class:`~..collectives.topology.SubGroup`
        for role ``name``, as seen by global ``rank`` (``rank=None`` group
        membership for non-members — collectives on it then raise the
        usual named ``GroupMembershipError``).  The instance token is
        derived from the role name, so role groups can never collide with
        user ``new_group`` ids."""
        from ..collectives.topology import SubGroup
        span = self.span(name)
        return SubGroup(list(span), int(rank), self.world,
                        instance=f"role-{name}")

    # -- serialization -------------------------------------------------------

    def spec_string(self) -> str:
        """The launcher grammar: ``learner:1,actor:4:solo@1`` (restart
        policy and ``@node`` pin only when non-default; channels do not
        travel here — they are the *program*'s literal, validated against
        this map)."""
        parts = []
        for r in self.roles:
            s = f"{r.name}:{r.world}"
            if r.restart != "gang":
                s += f":{r.restart}"
            if r.node is not None:
                s += f"@{r.node}"
            parts.append(s)
        return ",".join(parts)

    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "roles": [{"name": r.name, "world": r.world,
                       "restart": r.restart, "node": r.node}
                      for r in self.roles],
            "channels": [dataclasses.asdict(c) for c in self.channels],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, raw) -> "RoleGraph":
        doc = json.loads(raw if isinstance(raw, str) else raw.decode())
        return cls([Role(r["name"], int(r["world"]),
                         restart=r.get("restart", "gang"),
                         node=(int(r["node"])
                               if r.get("node") is not None else None))
                    for r in doc["roles"]],
                   [ChannelSpec(**c) for c in doc.get("channels", ())])

    def check_against(self, published: "RoleGraph") -> None:
        """Validate this (locally-constructed) graph against the launcher-
        published role map: role names, order and world sizes must agree —
        a worker whose graph literal drifted from the launch spec raises a
        named error instead of mis-spanning every rank after it."""
        mine = [(r.name, r.world) for r in self.roles]
        theirs = [(r.name, r.world) for r in published.roles]
        if mine != theirs:
            raise RoleGraphError(
                f"role graph disagrees with the published role map: this "
                f"process declared {mine} but the launcher published "
                f"{theirs} — the graph literal and --roles spec must "
                f"match (names, order and world sizes)")

    def describe(self) -> str:
        return self.spec_string()

    def __repr__(self):
        return (f"RoleGraph({self.spec_string()!r}, world={self.world}, "
                f"channels={[c.name for c in self.channels]})")


def parse_roles_spec(spec: str) -> RoleGraph:
    """Parse the launcher grammar ``name:world[:policy][@node][,...]``
    (e.g. ``learner:1,actor:4:solo@1``) into a channel-less
    :class:`RoleGraph`.  Raises :class:`RoleGraphError` on malformed
    specs, naming the bad segment."""
    if not spec or not spec.strip():
        raise RoleGraphError("empty --roles spec")
    roles = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise RoleGraphError(f"empty role segment in {spec!r}")
        part_body, at, node_str = part.partition("@")
        node = None
        if at:
            try:
                node = int(node_str)
            except ValueError:
                raise RoleGraphError(
                    f"role segment {part!r}: node pin {node_str!r} is "
                    f"not an integer") from None
        bits = part_body.split(":")
        if len(bits) not in (2, 3):
            raise RoleGraphError(
                f"role segment {part!r} must be name:world[:policy][@node] "
                f"(e.g. 'actor:4:solo@1')")
        name = bits[0].strip()
        try:
            world = int(bits[1])
        except ValueError:
            raise RoleGraphError(
                f"role segment {part!r}: world {bits[1]!r} is not an "
                f"integer") from None
        restart = bits[2].strip() if len(bits) == 3 else "gang"
        roles.append(Role(name, world, restart=restart, node=node))
    return RoleGraph(roles)


# -- store keys ---------------------------------------------------------------


def map_key(generation: int) -> str:
    """THE store key the launcher publishes the role map under — one
    definition shared by publisher (spawn_graph) and readers
    (init_role_graph, diagnostics), generation-scoped so a restarted
    gang's map can never be read by a fenced-out straggler."""
    return f"tpu_dist/g{generation}/roles/map"


def down_key(generation: int, rank: int) -> str:
    """Supervisor-posted marker: global ``rank`` died and is NOT coming
    back in this generation (the gang is failing, or its solo-restart
    budget is spent).  Channel endpoints poll these while blocked so a
    dead peer surfaces as a named ``ChannelPeerGoneError`` instead of a
    full deadline wait."""
    return f"tpu_dist/g{generation}/roles/down/{rank}"


# -- current-process role context ---------------------------------------------
#
# Process-global, set once by init_role_graph (.runtime):
# the sanitizer signs collectives with it, obs dumps/tails carry it, and
# the data plane's PeerGoneError diagnostics name peers by role.

_cur_mu = threading.Lock()
_cur_graph: Optional[RoleGraph] = None
_cur_role: Optional[Tuple[str, int]] = None


def set_current(graph: RoleGraph, role: str, role_rank: int) -> None:
    global _cur_graph, _cur_role
    with _cur_mu:
        _cur_graph = graph
        _cur_role = (str(role), int(role_rank))


def clear_current() -> None:
    global _cur_graph, _cur_role
    with _cur_mu:
        _cur_graph, _cur_role = None, None


def current_role() -> Optional[Tuple[str, int]]:
    """``(role_name, role_rank)`` of this process, or None outside any
    role graph."""
    return _cur_role


def current_graph() -> Optional[RoleGraph]:
    return _cur_graph


def role_label(rank: int) -> Optional[str]:
    """``"actor[2]"`` for a global rank under the current graph, or None
    when no graph is installed (or the rank is out of range) — safe to
    call from error paths unconditionally."""
    g = _cur_graph
    if g is None:
        return None
    try:
        return g.label(int(rank))
    except Exception:
        return None
