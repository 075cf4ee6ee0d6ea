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
the axis takes."""

from __future__ import annotations

import datetime
import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops._build import resolve_device

__all__ = ["ProcessGroup", "AxisGroup", "init_process_group",
           "destroy_process_group", "is_initialized", "get_default_group",
           "get_world_size", "get_rank", "axis_group", "DATA_AXIS"]

# the default mesh axis, as in the JAX package
DATA_AXIS = "data"

_DEFAULT_GROUP: Optional["ProcessGroup"] = None
_lock = threading.Lock()


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
    """This process's place in the job: world size, rank, the device it
    drives, the torch.distributed backend (``None`` at world 1) and the
    mesh of ranks (``axis_names``, ``mesh_shape``)."""

    def __init__(self, world_size: int, rank: int, device: torch.device,
                 backend: Optional[str],
                 axis_names: Sequence[str] = (DATA_AXIS,),
                 mesh_shape: Optional[Sequence[int]] = None):
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
        self._rank = rank
        self.device = device
        self.backend = backend
        self.axis_names = axis_names
        self.mesh_shape = mesh_shape
        self._axes = {}
        coords = np.unravel_index(rank, mesh_shape)
        # every rank creates every group, axis by axis and line by line in
        # the same order (torch.distributed.new_group is collective); a
        # group with no backend (world 1, or one that only describes a
        # rank's place) has none to create
        for a, name in enumerate(axis_names):
            mine = None
            for line in _mesh_lines(world_size, mesh_shape, a):
                ranks = tuple(int(r) for r in line)
                group = (torch.distributed.new_group(list(ranks))
                         if backend is not None and len(ranks) > 1 else None)
                if rank in ranks:
                    mine = (ranks, group)
            self._axes[name] = AxisGroup(name, mesh_shape[a], int(coords[a]),
                                         *mine)
        self._destroyed = False

    def axis_group(self, name: str) -> AxisGroup:
        """This rank's :class:`AxisGroup` along axis ``name``."""
        if name not in self._axes:
            raise ValueError(f"no mesh axis {name!r}; the group has "
                             f"{self.axis_names}")
        return self._axes[name]

    def size(self) -> int:
        return self._world_size

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def rank(self) -> int:
        return self._rank

    def destroy(self) -> None:
        if self.backend is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        self._destroyed = True

    def __repr__(self):
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
    one ``"data"`` axis over the world), as in the JAX package."""
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
        kwargs = {}
        if timeout is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=timeout)
        torch.distributed.init_process_group(
            name, init_method=init_method, world_size=world_size, rank=rank,
            **kwargs)
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
            raise
        _DEFAULT_GROUP = group
        return _DEFAULT_GROUP


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
    return _group(group).rank


def axis_group(name: str, group: Optional[ProcessGroup] = None) -> AxisGroup:
    """This rank's :class:`AxisGroup` along axis ``name`` of ``group`` (the
    default group).  With no group initialized every axis has size 1 and
    index 0, and no collective is called over it."""
    if group is None and not is_initialized():
        return AxisGroup(name, 1, 0, (0,))
    return _group(group).axis_group(name)


def destroy_process_group(group: Optional[ProcessGroup] = None) -> None:
    global _DEFAULT_GROUP
    with _lock:
        g = group if group is not None else _DEFAULT_GROUP
        if g is None:
            return
        g.destroy()
        if g is _DEFAULT_GROUP:
            _DEFAULT_GROUP = None
