"""tpu_dist_torch.collectives — counterpart of ``tpu_dist.collectives``.

Only :func:`broadcast_object_list` so far, the piece of
``tpu_dist/collectives/eager.py`` that resuming from a checkpoint needs
(rank 0 decides, every rank follows).  The rest of the host collectives
come with ZeRO and resilience (ROADMAP A9.1)."""

from __future__ import annotations

from typing import Any, List

import torch

__all__ = ["broadcast_object_list"]


def broadcast_object_list(object_list: List[Any], src: int = 0,
                          group=None) -> List[Any]:
    """torch ``dist.broadcast_object_list`` in the JAX package's functional
    form: returns rank ``src``'s list on every rank (same length).
    ``group`` is a port :class:`~tpu_dist_torch.dist.ProcessGroup` (the
    default group when ``None``); at world 1 the list comes back as it
    is.  The objects are pickled: send only what this program made."""
    from .. import dist
    if group is None:
        group = dist.get_default_group()
    if not 0 <= src < group.size():
        raise ValueError(f"src {src} is not a rank of a world of "
                         f"{group.size()}")
    out = list(object_list)
    if group.size() <= 1:
        return out
    # nccl moves the pickled bytes through the rank's card
    device = group.device if group.backend == "nccl" else None
    torch.distributed.broadcast_object_list(out, src=src, device=device)
    return out
