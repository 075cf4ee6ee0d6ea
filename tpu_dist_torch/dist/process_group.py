"""Process groups — counterpart of ``tpu_dist/dist/process_group.py``.

On the card one process drives one GPU, so here (unlike the JAX package,
where a process drives all of a host's cores) rank, process and device are
the same thing, as in torch.distributed.  With no ``init_method`` the group
is this process alone (world 1) and nothing is started; ``env://`` and
``tcp://host:port`` go to ``torch.distributed.init_process_group``, with
NCCL on the card and gloo on the CPU."""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional

import torch

from ..ops._build import resolve_device

__all__ = ["ProcessGroup", "init_process_group", "destroy_process_group",
           "is_initialized", "get_default_group", "get_world_size",
           "get_rank"]

_DEFAULT_GROUP: Optional["ProcessGroup"] = None
_lock = threading.Lock()


class ProcessGroup:
    """This process's place in the job: world size, rank, the device it
    drives and the torch.distributed backend (``None`` at world 1)."""

    def __init__(self, world_size: int, rank: int, device: torch.device,
                 backend: Optional[str]):
        self._world_size = world_size
        self._rank = rank
        self.device = device
        self.backend = backend
        self._destroyed = False

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
                       device=None) -> ProcessGroup:
    """Bring up the default process group (c10d ``init_process_group``
    parity).  ``init_method``: ``None`` (this process alone),
    ``'env://'`` (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) or
    ``'tcp://host:port'``; ``world_size``/``rank`` override the
    environment.  ``backend`` defaults to ``nccl`` on the card and ``gloo``
    on the CPU.  ``device``: ``cuda`` unless named — with several ranks on
    one host, rank ``LOCAL_RANK`` (else ``rank``) takes that card."""
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
            _DEFAULT_GROUP = ProcessGroup(1, 0, device, None)
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
        _DEFAULT_GROUP = ProcessGroup(world, me, device, name)
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


def destroy_process_group(group: Optional[ProcessGroup] = None) -> None:
    global _DEFAULT_GROUP
    with _lock:
        g = group if group is not None else _DEFAULT_GROUP
        if g is None:
            return
        g.destroy()
        if g is _DEFAULT_GROUP:
            _DEFAULT_GROUP = None
