"""Per-process role runtime: join a role graph, get role-aware plumbing
(counterpart of ``tpu_dist/roles/runtime.py``).

:func:`init_role_graph` is the role-graph analogue of
``dist.init_process_group`` — but deliberately without a
``torch.distributed`` process group: a heterogeneous graph's roles restart
independently (a solo-restarted actor must not abort the learner through
a communicator), so the runtime rides only the control-plane store and the
host data plane, and no role-graph path creates an NCCL communicator.
Intra-role collectives run over the role's pre-built
:class:`~tpu_dist_torch.collectives.topology.SubGroup` (``ctx.group``),
which every eager collective and the
:class:`~tpu_dist_torch.collectives.bucketer.Bucketer` accept via
``group=``.

What it does, in order (mirroring ``rendezvous.rendezvous``):

1. installs the chaos, network chaos and obs crash-dump hooks from env
   (workers in a role graph never call ``rendezvous``, so the injection
   and diagnostics layers are armed here instead), correcting their rank;
2. resolves the graph: the given literal, else ``TPU_DIST_ROLES``; when
   the launcher published a role map (:func:`~tpu_dist_torch.roles.graph
   .map_key`), validates the local graph against it — drift is a named
   :class:`~tpu_dist_torch.roles.graph.RoleGraphError`, not a mis-spanned
   rank;
3. connects the control-plane store (``TPU_DIST_STORE_ADDR``) and makes
   it the process's rendezvous store if none exists, so eager
   collectives, the sanitizer and topology detection work unchanged;
4. checks in (liveness key + host fingerprint) and installs the
   process-global role context (:func:`~tpu_dist_torch.roles.graph
   .set_current`) that the sanitizer signs collectives with and obs
   dumps carry.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

from .channel import Channel
from .graph import (RoleGraph, RoleGraphError, clear_current, map_key,
                    parse_roles_spec, set_current)

__all__ = ["RoleContext", "init_role_graph"]


class RoleContext:
    """This process's view of a running role graph.

    Attributes: ``graph``, ``rank`` / ``world`` (flat), ``role`` (name),
    ``role_rank`` / ``role_world``, ``group`` (the intra-role SubGroup),
    ``store``, ``generation``.  :meth:`channel` opens typed channel
    endpoints; :meth:`close` detaches (and closes opened channels).
    """

    def __init__(self, graph: RoleGraph, rank: int, store, generation: int,
                 owns_store: bool, installed_rdzv: bool):
        self.graph = graph
        self.rank = int(rank)
        self.world = graph.world
        self.role, self.role_rank = graph.role_of(self.rank)
        self.role_world = graph.role(self.role).world
        self.group = graph.subgroup(self.role, self.rank)
        self.store = store
        self.generation = int(generation)
        self._owns_store = owns_store
        self._installed_rdzv = installed_rdzv
        self._channels = {}

    def channel(self, name: str, dp=None) -> Channel:
        """This process's endpoint of graph channel ``name`` (cached —
        repeated calls return the same object).  Re-requesting a cached
        endpoint with a different ``dp`` is a named error, not a silent
        fallback to the first call's wiring."""
        got = self._channels.get(name)
        if got is not None:
            cached_dp = got._dp if not got._dp_failed else False
            if dp is not None and dp is not cached_dp:
                raise RoleGraphError(
                    f"channel {name!r} was already opened with "
                    f"dp={cached_dp!r}; a cached endpoint cannot be "
                    f"re-wired to dp={dp!r} — open it with the intended "
                    f"data plane first, or use a separate Channel")
            return got
        spec = self.graph.channel_spec(name)
        ch = Channel(spec, self.store, self.rank, self.role,
                     src_span=list(self.graph.span(spec.src)),
                     dst_span=list(self.graph.span(spec.dst)),
                     generation=self.generation,
                     graph_world=self.world, dp=dp)
        self._channels[name] = ch
        return ch

    def close(self, mark_closed: bool = True) -> None:
        """Close opened channels and detach the role context (idempotent).
        ``mark_closed=False`` skips the channels' clean-EOF markers (the
        crash-unwind path — see :meth:`Channel.close`).  The store client
        is closed only if this context created it."""
        for ch in self._channels.values():
            try:
                ch.close(mark=mark_closed)
            except Exception:
                pass
        self._channels.clear()
        clear_current()
        if self._installed_rdzv:
            import importlib
            rdzv = importlib.import_module("tpu_dist_torch.dist.rendezvous")
            if rdzv._store is self.store:
                rdzv._store = None
                rdzv._store_num_processes = 0
            self._installed_rdzv = False
        if self._owns_store and self.store is not None:
            try:
                self.store.close()
            except Exception:
                pass
            self.store = None

    def __enter__(self) -> "RoleContext":
        return self

    def __exit__(self, etype, *exc) -> None:
        # a crash unwind must not post clean-EOF channel markers: the
        # supervisor may be about to solo-respawn this rank, and a peer
        # seeing "closed" would stop waiting for the respawn
        self.close(mark_closed=etype is None)

    def __repr__(self):
        return (f"RoleContext({self.graph.describe()!r}, rank={self.rank}, "
                f"role={self.role}[{self.role_rank}], "
                f"gen={self.generation})")


def _map_timeout() -> float:
    try:
        return float(os.environ.get("TPU_DIST_ROLES_MAP_TIMEOUT", "60"))
    except ValueError:
        return 60.0


def init_role_graph(graph: Optional[RoleGraph] = None,
                    rank: Optional[int] = None,
                    store=None) -> RoleContext:
    """Join the role graph this process was launched into; see the module
    docstring for the exact steps.  ``graph``/``rank``/``store`` are
    explicit for in-process test rigs; production workers rely on the
    launcher env contract (``TPU_DIST_ROLES``, ``RANK``,
    ``TPU_DIST_STORE_ADDR``, ``TPU_DIST_RESTART_COUNT``)."""
    # fault-injection + obs arming, exactly like rendezvous.rendezvous —
    # role workers never call it, so this is their install point
    chaos_active = None
    netchaos_active = None
    if os.environ.get("TPU_DIST_CHAOS"):
        from ..resilience import chaos as _chaos
        chaos_active = _chaos.install_from_env()
    if os.environ.get("TPU_DIST_NETCHAOS"):
        from ..resilience import netchaos as _netchaos
        netchaos_active = _netchaos.install_from_env()
    from ..obs import hooks as _obs_hooks
    obs_rec = _obs_hooks.install_from_env()

    if rank is None:
        rank = int(os.environ.get("RANK", "0") or 0)
    rank = int(rank)
    if chaos_active is not None:
        chaos_active.rank = rank
    if netchaos_active is not None:
        netchaos_active.rank = rank  # the same correction as rendezvous:
        # rank-scoped surface faults key on the resolved rank
    if graph is None:
        spec = os.environ.get("TPU_DIST_ROLES")
        if not spec:
            raise RoleGraphError(
                "init_role_graph() needs a RoleGraph literal or the "
                "launcher's TPU_DIST_ROLES env (python -m "
                "tpu_dist_torch.launch --roles name:world[,...])")
        graph = parse_roles_spec(spec)
    if not 0 <= rank < graph.world:
        raise RoleGraphError(
            f"rank {rank} out of range for {graph.describe()!r} "
            f"(world {graph.world})")

    import importlib
    rdzv = importlib.import_module("tpu_dist_torch.dist.rendezvous")
    generation = rdzv.generation()

    owns_store = False
    if store is None:
        addr = os.environ.get("TPU_DIST_STORE_ADDR")
        if not addr:
            raise RoleGraphError(
                "role graphs need the control-plane store: launch via "
                "python -m tpu_dist_torch.launch --roles / spawn_graph, or set "
                "TPU_DIST_STORE_ADDR, or pass store= explicitly")
        from ..dist.store import TCPStore
        host, _, port = addr.rpartition(":")
        store = TCPStore(host, int(port))
        owns_store = True

    # the launcher published the agreed role map before spawning; validate
    # the local literal against it so a drifted graph fails by name.
    # Only under the launcher env contract — a hand-built rig with no
    # publisher must not stall on a key that will never appear
    published = None
    if os.environ.get("TPU_DIST_ROLE"):
        key = map_key(generation)
        try:
            store.wait([key], timeout=_map_timeout())
            published = RoleGraph.from_json(store.get(key))
        except RoleGraphError:
            raise
        except Exception:
            published = None  # degraded store: fall back to local truth
    if published is not None:
        graph.check_against(published)

    # become the process's rendezvous store (if none): eager collectives,
    # the sanitizer and topology detection all read rendezvous._store
    installed_rdzv = False
    if rdzv._store is None:
        rdzv._store = store
        rdzv._store_num_processes = graph.world
        installed_rdzv = True

    # check in: liveness + host fingerprint (the _preflight publications,
    # without the all-ranks barrier — roles synchronize through channels)
    try:
        store.set(f"tpu_dist/alive/{rank}", str(os.getpid()))
        from ..collectives.topology import publish_host_fingerprint
        publish_host_fingerprint(store, rank, generation)
    except Exception as e:
        warnings.warn(f"role check-in publish failed ({e!r}); liveness "
                      f"and topology diagnostics degrade")

    role, role_rank = graph.role_of(rank)
    set_current(graph, role, role_rank)
    if obs_rec is not None:
        obs_rec.rank = rank
        obs_rec.world = graph.world
        obs_rec.role = role
        obs_rec.role_rank = role_rank
    return RoleContext(graph, rank, store, generation,
                       owns_store=owns_store,
                       installed_rdzv=installed_rdzv)
