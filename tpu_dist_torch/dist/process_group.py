"""Process groups — counterpart of ``tpu_dist/dist/process_group.py``.

On the card one process drives one GPU, so here (unlike the JAX package,
where a process drives all of a host's cores) rank, process and device are
the same thing, as in torch.distributed.  With no ``init_method`` the group
is this process alone (world 1) and nothing is started; ``env://`` and
``tcp://host:port`` go to ``torch.distributed.init_process_group``, with
NCCL on the card and gloo on the CPU.

The ranks form a mesh, as the JAX package's devices do: ``axis_names`` and
``mesh_shape`` (default one ``"data"`` axis over the world) lay the ranks out
row-major, as ``np.arange(world).reshape(mesh_shape)``, and each axis of size
above 1 gets a ``torch.distributed`` group for this rank's line along it.
:meth:`ProcessGroup.axis_group` (or :func:`axis_group`) stands for JAX's
``lax.axis_size``/``lax.axis_index`` and names the group a collective over
the axis takes.

Before ``torch.distributed`` starts, every process meets the others in the
control-plane store (rendezvous.py: liveness keys, the pre-flight that
names missing ranks, generation fencing), and it meets them there again in
:func:`destroy_process_group`'s teardown barrier.  :func:`new_group` makes a
sub-group (every rank calls it, members and non-members alike, as torch
requires), :func:`barrier` and :func:`monitored_barrier` block until the
ranks arrive (the second names the ranks that did not), and :func:`abort`
leaves at once with no teardown.

Counts, in the JAX package's terms: a rank drives one device, so the
``world_size`` (devices) of a group equals its ``num_processes``, and
``local_world_size`` (the devices this process addresses) is 1."""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops._build import resolve_device
from . import rendezvous as _rdzv

__all__ = ["ProcessGroup", "AxisGroup", "GroupMembershipError",
           "init_process_group", "destroy_process_group", "is_initialized",
           "get_default_group", "get_world_size", "get_rank",
           "get_local_rank", "get_local_world_size", "get_num_processes",
           "get_backend", "new_group", "barrier", "monitored_barrier",
           "abort", "axis_group", "DATA_AXIS"]

# the default mesh axis, as in the JAX package
DATA_AXIS = "data"

_DEFAULT_GROUP: Optional["ProcessGroup"] = None
_lock = threading.Lock()


class GroupMembershipError(RuntimeError):
    """A rank used a sub-group it is not a member of (its
    :func:`new_group` call returned the group to it all the same, as every
    rank must make the call)."""


class AxisGroup(NamedTuple):
    """This rank's line along one mesh axis: its ``size``, this rank's
    ``index`` on it (``lax.axis_size``/``lax.axis_index``), the global
    ``ranks`` of the line in axis order, and the ``torch.distributed``
    group over them (``None`` at size 1, where nothing is communicated)."""
    name: str
    size: int
    index: int
    ranks: tuple
    group: Optional[object] = None


def _mesh_lines(world: int, mesh_shape, axis: int) -> np.ndarray:
    """The rank lines along ``axis`` of the row-major mesh, one a row, in
    the order every rank walks them."""
    grid = np.arange(world).reshape(mesh_shape)
    return np.moveaxis(grid, axis, -1).reshape(-1, mesh_shape[axis])


class ProcessGroup:
    """This process's place in a group of ranks: the group's size, this
    rank's index in it, the device it drives, the torch.distributed backend
    (``None`` at world 1) and the mesh of the group's ranks (``axis_names``,
    ``mesh_shape``).  The default group spans the world; a sub-group
    (:func:`new_group`) lists its members' global ``ranks`` and carries the
    ``torch_group`` its collectives take (``None``: torch's default group).
    On a rank outside a sub-group every query raises
    :class:`GroupMembershipError`."""

    def __init__(self, world_size: int, rank: int, device: torch.device,
                 backend: Optional[str],
                 axis_names: Sequence[str] = (DATA_AXIS,),
                 mesh_shape: Optional[Sequence[int]] = None,
                 ranks: Optional[Sequence[int]] = None,
                 torch_group=None, parent: Optional["ProcessGroup"] = None):
        axis_names = tuple(axis_names)
        mesh_shape = (world_size,) if mesh_shape is None else tuple(
            int(n) for n in mesh_shape)
        if len(axis_names) != len(mesh_shape):
            raise ValueError("axis_names and mesh_shape must have equal "
                             "length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names {axis_names} repeat")
        if int(np.prod(mesh_shape)) != world_size:
            raise ValueError(f"mesh_shape {mesh_shape} does not cover "
                             f"{world_size} ranks")
        self._world_size = world_size
        self._rank = rank   # -1 on a rank outside the (sub-)group
        self.device = device
        self.backend = backend
        self.axis_names = axis_names
        self.mesh_shape = mesh_shape
        self.ranks = tuple(range(world_size) if ranks is None
                           else (int(r) for r in ranks))
        self.torch_group = torch_group
        self._parent = parent
        self._axes = {}
        coords = (np.unravel_index(rank, mesh_shape) if rank >= 0
                  else (0,) * len(mesh_shape))
        global_ranks = np.asarray(self.ranks)
        # every rank creates every group, axis by axis and line by line in
        # the same order (torch.distributed.new_group is collective, so
        # the ranks outside a sub-group make the calls too); a group with
        # no backend (world 1) has none to create
        for a, name in enumerate(axis_names):
            mine = None
            for line in _mesh_lines(world_size, mesh_shape, a):
                members = tuple(int(r) for r in global_ranks[line])
                group = (torch.distributed.new_group(list(members))
                         if backend is not None and len(members) > 1
                         else None)
                if rank >= 0 and rank in line:
                    mine = (members, group)
            if mine is not None:
                self._axes[name] = AxisGroup(name, mesh_shape[a],
                                             int(coords[a]), *mine)
        self._destroyed = False

    def _member(self) -> None:
        if self._rank < 0:
            raise GroupMembershipError(
                f"global rank {torch.distributed.get_rank()} is not a "
                f"member of this sub-group (ranks {list(self.ranks)})")

    def axis_group(self, name: str) -> AxisGroup:
        """This rank's :class:`AxisGroup` along axis ``name``."""
        self._member()
        if name not in self._axes:
            raise ValueError(f"no mesh axis {name!r}; the group has "
                             f"{self.axis_names}")
        return self._axes[name]

    def size(self) -> int:
        self._member()
        return self._world_size

    @property
    def world_size(self) -> int:
        return self.size()

    @property
    def rank(self) -> int:
        """This rank's index in the group (its global rank in the default
        group)."""
        self._member()
        return self._rank

    @property
    def is_member(self) -> bool:
        return self._rank >= 0

    @property
    def num_processes(self) -> int:
        """Processes in the group: one a rank."""
        return self.size()

    @property
    def local_world_size(self) -> int:
        """Devices this process addresses in the group: its own card."""
        self._member()
        return 1

    def destroy(self) -> None:
        if self.backend is not None and torch.distributed.is_initialized():
            if self._parent is None:
                torch.distributed.destroy_process_group()
        self._destroyed = True

    def __repr__(self):
        if self._rank < 0:
            return f"ProcessGroup(non-member, ranks={list(self.ranks)})"
        return (f"ProcessGroup(world_size={self._world_size}, "
                f"rank={self._rank}, device={self.device}, "
                f"backend={self.backend})")


def init_process_group(backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       world_size: int = -1, rank: int = -1,
                       timeout: Optional[float] = None,
                       device=None,
                       axis_names: Sequence[str] = (DATA_AXIS,),
                       mesh_shape: Optional[Sequence[int]] = None
                       ) -> ProcessGroup:
    """Bring up the default process group (c10d ``init_process_group``
    parity).  ``init_method``: ``None`` (this process alone),
    ``'env://'`` (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) or
    ``'tcp://host:port'``; ``world_size``/``rank`` override the
    environment.  ``backend`` defaults to ``nccl`` on the card and ``gloo``
    on the CPU.  ``device``: ``cuda`` unless named — with several ranks on
    one host, rank ``LOCAL_RANK`` (else ``rank``) takes that card.
    ``axis_names``/``mesh_shape``: the mesh of ranks, row-major (default
    one ``"data"`` axis over the world), as in the JAX package.

    Above one process, the processes first meet in the control-plane store
    when there is one (``TPU_DIST_STORE_ADDR``, set by the launcher; see
    rendezvous.py), which names the ranks that never arrive, and only then
    start ``torch.distributed``."""
    global _DEFAULT_GROUP
    with _lock:
        if _DEFAULT_GROUP is not None and not _DEFAULT_GROUP._destroyed:
            raise RuntimeError("Default process group already initialized; "
                               "call destroy_process_group() first.")
        device = resolve_device(device)
        if init_method is None:
            if world_size not in (-1, 1) or rank not in (-1, 0):
                raise ValueError("world_size/rank need an init_method "
                                 "('env://' or 'tcp://host:port')")
            _DEFAULT_GROUP = ProcessGroup(1, 0, device, None, axis_names,
                                          mesh_shape)
            return _DEFAULT_GROUP
        name = backend or ("nccl" if device.type == "cuda" else "gloo")
        if name not in ("nccl", "gloo"):
            raise ValueError(f"Unknown backend {backend!r}; use 'nccl' or "
                             f"'gloo'")
        coordinator, n, me = _rdzv.rendezvous(
            init_method, world_size=world_size, rank=rank, timeout=timeout)
        kwargs = {}
        if timeout is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=timeout)
        c10d = _published_store(coordinator, n, me, timeout)
        if c10d is not None:
            torch.distributed.init_process_group(
                name, store=c10d, world_size=n, rank=me, **kwargs)
        else:
            torch.distributed.init_process_group(
                name, init_method=init_method, world_size=world_size,
                rank=rank, **kwargs)
        world = torch.distributed.get_world_size()
        me = torch.distributed.get_rank()
        if device.type == "cuda" and world > 1:
            local = int(os.environ.get("LOCAL_RANK", me))
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        try:
            group = ProcessGroup(world, me, device, name, axis_names,
                                 mesh_shape)
        except BaseException:
            torch.distributed.destroy_process_group()
            _rdzv.shutdown()
            raise
        _DEFAULT_GROUP = group
        return _DEFAULT_GROUP


_INITS = [0]   # this process's store-published rendezvous; every rank makes
#                them in the same order, like every collective


def _published_store(coordinator: str, n: int, me: int,
                     timeout: Optional[float]):
    """torch's rendezvous store, bound on a port the OS picks, or None when
    ``init_method``'s port must be bound.  A port picked in advance
    (MASTER_PORT, the launcher's or the user's) and bound seconds later,
    after the children import torch, can be taken in between by any
    socket of the host, and rank 0 would then fail with EADDRINUSE.  A
    world of one binds where the OS says (no peer looks for it).  Above
    one, with a control-plane store (``TPU_DIST_STORE_ADDR``, set by the
    launcher, or ``TPU_DIST_STORE_PREFLIGHT``), rank 0 binds where the OS
    says and publishes the port there, and the other ranks read it;
    without one, ``init_method``'s port is the only address the ranks
    share, and torch binds it."""
    if coordinator is None:
        return None
    host = coordinator.rpartition(":")[0]
    wait = _rdzv.preflight_timeout(timeout)
    td = datetime.timedelta(seconds=wait)
    if n == 1:
        return torch.distributed.TCPStore(host, 0, 1, is_master=True,
                                          timeout=td,
                                          wait_for_workers=False)
    store = _rdzv.get_store()
    if store is None:
        return None
    seq = _INITS[0]
    _INITS[0] += 1
    key = (f"tpu_dist/g{_rdzv.generation()}/c10d_port/{coordinator}/{n}/"
           f"{seq}")
    if me == 0:
        c10d = torch.distributed.TCPStore(host, 0, n, is_master=True,
                                          timeout=td,
                                          wait_for_workers=False)
        store.set(key, str(c10d.port))
        return c10d
    store.wait([key], timeout=wait)
    return torch.distributed.TCPStore(host, int(store.get(key)), n,
                                      is_master=False, timeout=td)


def is_initialized() -> bool:
    return _DEFAULT_GROUP is not None and not _DEFAULT_GROUP._destroyed


def get_default_group() -> ProcessGroup:
    if not is_initialized():
        raise RuntimeError("Default process group has not been initialized; "
                           "call tpu_dist_torch.dist.init_process_group() "
                           "first.")
    return _DEFAULT_GROUP


def _group(group: Optional[ProcessGroup]) -> ProcessGroup:
    return group if group is not None else get_default_group()


def get_world_size(group: Optional[ProcessGroup] = None) -> int:
    """Number of ranks (one device each) — the DDP replica count."""
    return _group(group).size()


def get_rank(group: Optional[ProcessGroup] = None) -> int:
    """This rank's index in ``group`` (the launcher's ``RANK`` for the
    default group)."""
    return _group(group).rank


def get_backend(group: Optional[ProcessGroup] = None) -> str:
    """torch ``dist.get_backend`` parity: ``'nccl'`` or ``'gloo'`` — at
    world 1, the backend a larger world would take on this device."""
    g = _group(group)
    return g.backend or ("nccl" if g.device.type == "cuda" else "gloo")


def get_num_processes(group: Optional[ProcessGroup] = None) -> int:
    return _group(group).num_processes


def get_local_world_size(group: Optional[ProcessGroup] = None) -> int:
    return _group(group).local_world_size


def get_local_rank() -> int:
    """Local rank from the launcher's env (``LOCAL_RANK``); 0 when not
    launched."""
    return int(os.environ.get("LOCAL_RANK", 0))


def new_group(ranks: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              mesh_shape: Optional[Sequence[int]] = None) -> ProcessGroup:
    """Sub-group over a subset of the default group's ranks (c10d
    ``new_group``).  Every rank must call it, with the same ``ranks`` and
    in the same order as every other group it makes, members and
    non-members alike, as torch requires.  A member gets its index in
    ``ranks`` as :attr:`ProcessGroup.rank` and ``len(ranks)`` as its size;
    a non-member gets a group on which every query raises
    :class:`GroupMembershipError`.  The sub-group's collectives (the DDP's
    with ``group=``, :func:`barrier`) take its ``torch_group``."""
    default = get_default_group()
    world = default.size()
    ranks = list(range(world) if ranks is None else (int(r) for r in ranks))
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"new_group ranks {ranks} must be distinct ranks "
                         f"of a world of {world}")
    me = default.rank
    index = ranks.index(me) if me in ranks else -1
    tg = None
    if default.backend is not None and len(ranks) > 1:
        tg = torch.distributed.new_group(ranks)
    return ProcessGroup(len(ranks), index, default.device, default.backend,
                        axis_names, mesh_shape, ranks=ranks, torch_group=tg,
                        parent=default)


def barrier(group: Optional[ProcessGroup] = None) -> None:
    """Block until every rank of ``group`` reaches the barrier (a no-op for
    a group of one).  On NCCL the call names this rank's card
    (``device_ids``), so NCCL does not guess the card from the rank."""
    g = _group(group)
    if g.size() <= 1:
        return
    kw = {"group": g.torch_group} if g.torch_group is not None else {}
    if g.backend == "nccl":
        kw["device_ids"] = [g.device.index]
    from ..collectives.work import wait_handle
    # tpudlint: disable=TD004  # async_op: wait_handle bounds the wait
    work = torch.distributed.barrier(async_op=True, **kw)
    wait_handle(work, kw.get("group"))


_MB_SEQ = [0]  # this process's monitored_barrier calls (every process
               # makes them in the same order, like every collective)
_MB_PASSED = [-1]  # the last call THIS process passed: gates the GC of the
                   # previous call's keys (below)


def monitored_barrier(group: Optional[ProcessGroup] = None,
                      timeout: float = 300.0) -> None:
    """A barrier that NAMES the ranks that failed to arrive (torch
    ``dist.monitored_barrier`` with ``wait_all_ranks=True``), through the
    control-plane store and under the JAX package's keys
    (``__monitored_barrier__/<call>/arrived/<rank>`` and ``.../go``).

    Each rank posts an arrival key; rank 0 collects them for ``timeout``
    seconds and raises ``RuntimeError`` listing every missing rank, else
    publishes the release key the others wait on.  A no-op at world 1;
    raises ``RuntimeError`` when the job has no store (use :func:`barrier`)
    and ``ValueError`` for a sub-group (its membership is not tracked
    against store keys)."""
    g = _group(group)
    if g._parent is not None:
        raise ValueError("monitored_barrier supports the default group "
                         "only (a subgroup diagnosis would misname "
                         "non-member ranks as missing)")
    if g.num_processes <= 1:
        return
    store = _rdzv.get_store()
    if store is None:
        raise RuntimeError(
            "monitored_barrier needs the control-plane store (launcher or "
            "TPU_DIST_STORE_ADDR); use dist.barrier() instead")
    seq = _MB_SEQ[0]
    _MB_SEQ[0] += 1
    rank = g.rank
    n = g.num_processes
    prefix = f"__monitored_barrier__/{seq}"
    if seq > 0 and _MB_PASSED[0] == seq - 1:
        # GC this rank's arrival key of the previous call, which it passed
        # (rank 0 read every arrival before publishing the release this
        # rank saw); a rank that timed out there must not delete it, as
        # rank 0 may still be polling.  The previous release key stays
        # until rank 0 has seen every rank arrive HERE (below).
        store.delete_key(f"__monitored_barrier__/{seq - 1}/arrived/{rank}")
    store.set(f"{prefix}/arrived/{rank}", b"1")
    deadline = time.monotonic() + timeout
    if rank == 0:
        missing = list(range(1, n))
        while True:  # poll at least once: timeout=0 must not misdiagnose
            missing = [r for r in missing
                       if not store.check(f"{prefix}/arrived/{r}")]
            if not missing or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        if missing:
            raise RuntimeError(
                f"monitored_barrier timed out after {timeout}s; process "
                f"rank(s) {missing} did not reach the barrier")
        if seq > 0:
            # everyone arrived here, so everyone left the previous call:
            # its release key has no readers left
            store.delete_key(f"__monitored_barrier__/{seq - 1}/go")
        store.set(f"{prefix}/go", b"1")
        _MB_PASSED[0] = seq
    else:
        try:
            store.wait([f"{prefix}/go"],
                       timeout=max(deadline - time.monotonic(), 0.0))
        except TimeoutError:
            raise RuntimeError(
                f"monitored_barrier timed out after {timeout}s waiting "
                f"for process 0's release") from None
        _MB_PASSED[0] = seq


def abort(exit_code: int = 1, reason: str = "") -> None:
    """Leave this process NOW, with no distributed teardown (torch
    ``ProcessGroup.abort`` parity): flush stdio and ``os._exit``.  A
    process exiting because a *peer* is hung would otherwise block in a
    teardown that waits on that peer, and the launcher would never see it
    exit; use it in except-handlers around collectives::

        try:
            dist.monitored_barrier(timeout=60)
        except RuntimeError as e:
            print(e, file=sys.stderr)
            dist.abort(7)
    """
    if reason:
        print(f"tpu_dist_torch.abort: {reason}", file=sys.stderr)
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(exit_code)


def axis_group(name: str, group: Optional[ProcessGroup] = None) -> AxisGroup:
    """This rank's :class:`AxisGroup` along axis ``name`` of ``group`` (the
    default group).  With no group initialized every axis has size 1 and
    index 0, and no collective is called over it."""
    if group is None and not is_initialized():
        return AxisGroup(name, 1, 0, (0,))
    return _group(group).axis_group(name)


def destroy_process_group(group: Optional[ProcessGroup] = None) -> None:
    """Tear down ``group`` (the default group: first the store's teardown
    barrier, so no rank goes while a peer still flushes its last
    collective, then ``torch.distributed``)."""
    global _DEFAULT_GROUP
    with _lock:
        g = group if group is not None else _DEFAULT_GROUP
        if g is None:
            return
        if g is _DEFAULT_GROUP:
            _rdzv.shutdown()
        g.destroy()
        if g is _DEFAULT_GROUP:
            _DEFAULT_GROUP = None
