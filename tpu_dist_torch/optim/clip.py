"""Gradient clipping — counterpart of ``tpu_dist/optim/clip.py``
(torch.nn.utils.clip_grad_norm_ parity).

Gradients are a dict of tensors (or a list).  Each leaf's squares are
summed in float32 over the leaf flattened, by one multi-tensor
``torch._foreach_norm`` for each device and dtype, and the global norm is
the square root of their sum; it stays on the device (a 0-d float32
tensor), so clipping never waits for the card.  Clipping scales the leaves
in place, in float32, back in each leaf's dtype (torch's
``clip_grad_norm_``; the JAX package returns new leaves), and returns them
with the pre-clip norm.

**Sharded path (ZeRO)**: when each rank holds only its owned flat shard of
every gradient leaf, :func:`sharded_global_norm` sums the local squares
over the owned chunks and folds the rank partials with ONE scalar
``torch.distributed.all_reduce``.  At world 1 (shards are the whole leaves,
flat) it equals :func:`global_norm` bit for bit, and numerically across
worlds (the rank partials associate differently).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

__all__ = ["clip_grad_norm", "global_norm",
           "sharded_clip_grad_norm", "sharded_global_norm"]

Grads = Union[Dict[str, torch.Tensor], List[torch.Tensor]]


def _leaves(grads: Grads) -> List[torch.Tensor]:
    return list(grads.values()) if isinstance(grads, dict) else list(grads)


def _by_kind(leaves):
    groups: dict = {}
    for g in leaves:
        groups.setdefault((g.device, g.dtype), []).append(g)
    return list(groups.values())


def _sum_sq(leaves) -> torch.Tensor:
    """Σ over the leaves of each leaf's float32 sum of squares, a 0-d
    float32 tensor on the leaves' device (the CPU for no leaves)."""
    total = None
    for group in _by_kind(leaves):
        norms = torch._foreach_norm([g.reshape(-1) for g in group], 2,
                                    dtype=torch.float32)
        part = torch.stack(norms).square().sum()
        total = part if total is None else total + part.to(total.device)
    return total if total is not None else torch.zeros(())


def global_norm(grads: Grads) -> torch.Tensor:
    """L2 norm over every leaf (torch: total_norm), a 0-d float32 tensor."""
    return _sum_sq(_leaves(grads)).sqrt()


def _scale(grads: Grads, norm: torch.Tensor, max_norm: float) -> Grads:
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for group in _by_kind(_leaves(grads)):
        torch._foreach_mul_(group, scale.to(group[0].device))
    return grads


@torch.no_grad()
def clip_grad_norm(grads: Grads, max_norm: float):
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``.  Returns ``(grads, total_norm)`` — the pre-clip norm, like
    torch's ``clip_grad_norm_``."""
    norm = global_norm(grads)
    return _scale(grads, norm, max_norm), norm


@torch.no_grad()
def sharded_global_norm(shards: Grads, group=None,
                        all_reduce=None) -> torch.Tensor:
    """Global L2 norm from per-rank owned shards (same structure as the
    gradients, leaves = owned flat chunks): the local sum of squares and one
    scalar all-reduce.  ``group`` is a port
    :class:`~tpu_dist_torch.dist.ProcessGroup` (the default group when
    ``None``; at world 1 nothing is reduced).  ``all_reduce`` overrides the
    collective (signature ``f(np.float32 scalar) -> scalar``), as in the JAX
    package."""
    local = _sum_sq(_leaves(shards))
    if all_reduce is not None:
        total = torch.tensor(np.float32(np.asarray(
            all_reduce(np.float32(local.item())))), device=local.device)
        return total.sqrt()
    from .. import dist
    world = (group.size() if group is not None else
             dist.get_world_size() if dist.is_initialized() else 1)
    if world > 1:
        torch.distributed.all_reduce(
            local, group=group.torch_group if group is not None else None)
    return local.sqrt()


@torch.no_grad()
def sharded_clip_grad_norm(shards: Grads, max_norm: float, group=None,
                           all_reduce=None):
    """:func:`clip_grad_norm` over per-rank owned shards: ONE scalar
    all-reduce computes the global norm, then each rank scales only the
    fragments it owns, in place.  Returns ``(shards, total_norm)``."""
    norm = sharded_global_norm(shards, group=group, all_reduce=all_reduce)
    return _scale(shards, norm, max_norm), norm
