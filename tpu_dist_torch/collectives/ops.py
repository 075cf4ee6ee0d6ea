"""In-step collectives over a group of ranks — counterpart of
``tpu_dist/collectives/ops.py``.

The JAX functions take a mesh axis name inside ``shard_map``; these take
the group the collective spans: a port
:class:`~tpu_dist_torch.dist.ProcessGroup`, one of its mesh axes
(:class:`~tpu_dist_torch.dist.AxisGroup`, or the axis name, resolved on the
default group) or ``None`` for the default group.  They run on
``torch.distributed`` (NCCL on the card, gloo on the CPU) over this rank's
tensors and return new tensors; ``x`` may be a tensor or a dict, list or
tuple of them, as the JAX functions map over a pytree.  Over a group of
size 1 each returns its input, as the JAX functions do under an axis of
size 1.  They are not differentiable (the port's autograd never sees a
collective; the DDP calls them after the backward).

Reduction ops mirror torch.distributed.ReduceOp: ``sum``, ``avg``/``mean``,
``max``, ``min``, ``prod``/``product``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ._tree import tree_map as _tree_map
from .work import wait_handle

__all__ = ["all_reduce", "psum", "pmean", "all_gather", "reduce_scatter",
           "broadcast", "all_to_all", "ppermute", "ring_all_reduce"]

_RED = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class _Line(NamedTuple):
    """The ranks a collective spans: their count, this rank's index among
    them, their global ranks and the torch group (None: the world)."""
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: object


def _line(group) -> _Line:
    from .. import dist
    if group is None or isinstance(group, str):
        if not dist.is_initialized():
            return _Line(1, 0, (0,), None)
        group = (dist.get_default_group() if group is None
                 else dist.axis_group(group))
    if isinstance(group, dist.AxisGroup):
        return _Line(group.size, group.index, tuple(group.ranks),
                     group.group)
    return _Line(group.size(), group.rank, tuple(group.ranks),
                 group.torch_group)


def _gather_stack(v: torch.Tensor, line: _Line) -> torch.Tensor:
    """Every rank's ``v`` stacked on a new leading axis, in rank order."""
    out = v.new_empty(line.size * v.numel())
    torch.distributed.all_gather_into_tensor(out, v.reshape(-1).contiguous(),
                                             group=line.group)
    return out.view((line.size,) + tuple(v.shape))


def all_reduce(x, group=None, op: str = "sum"):
    """All-reduce over ``group`` (ReduceOp parity).  ``avg`` is the sum
    divided by the group size (``lax.pmean``); ``product`` is the product
    of the gathered values in rank order, as the JAX package computes it
    (``jnp.prod`` over an all-gather)."""
    op = op.lower()
    if op not in ("sum", "avg", "mean", "max", "min", "prod", "product"):
        raise ValueError(f"Unknown reduce op {op!r}")
    line = _line(group)
    if line.size == 1:
        return x

    def red(v):
        if op in ("prod", "product"):
            return torch.prod(_gather_stack(v, line), dim=0)
        out = v.clone()
        kind = "sum" if op in ("avg", "mean") else op
        torch.distributed.all_reduce(
            out, op=getattr(torch.distributed.ReduceOp, _RED[kind]),
            group=line.group)
        return out / line.size if op in ("avg", "mean") else out

    return _tree_map(red, x)


def psum(x, group=None):
    return all_reduce(x, group, "sum")


def pmean(x, group=None):
    return all_reduce(x, group, "avg")


def all_gather(x, group=None, axis: int = 0, tiled: bool = False):
    """Gather every rank's value: ``tiled=False`` stacks them on a new axis
    ``axis`` of size world, ``tiled=True`` concatenates them along
    ``axis`` (``all_gather_into_tensor`` style)."""
    line = _line(group)

    def gather(v):
        if line.size == 1:
            return v if tiled else v.unsqueeze(axis)
        stacked = _gather_stack(v, line)          # (world, *v.shape)
        out = torch.movedim(stacked, 0, axis % (v.dim() + 1))
        if not tiled:
            return out
        ax = axis % v.dim()
        return torch.cat(list(stacked.unbind(0)), dim=ax)

    return _tree_map(gather, x)


def reduce_scatter(x, group=None, scatter_axis: int = 0, op: str = "sum"):
    """Reduce over ``group``, leaving this rank its 1/world slice along
    ``scatter_axis`` (``lax.psum_scatter(tiled=True)``); ``avg`` divides
    by the group size."""
    op = op.lower()
    if op not in ("sum", "avg", "mean"):
        raise ValueError("reduce_scatter supports sum/avg")
    line = _line(group)
    if line.size == 1:
        return x

    def rs(v):
        ax = scatter_axis % v.dim()
        if v.shape[ax] % line.size:
            raise ValueError(f"reduce_scatter: axis {ax} of {tuple(v.shape)}"
                             f" does not split into {line.size}")
        src = torch.movedim(v, ax, 0).contiguous()
        out = src.new_empty((src.shape[0] // line.size,) + src.shape[1:])
        torch.distributed.reduce_scatter_tensor(out, src, group=line.group)
        out = torch.movedim(out, 0, ax)
        return out / line.size if op in ("avg", "mean") else out

    return _tree_map(rs, x)


def broadcast(x, group=None, src: int = 0):
    """``src``'s value (its index in the group) on every rank."""
    line = _line(group)
    if not 0 <= src < line.size:
        raise ValueError(f"src {src} is not a rank of a group of "
                         f"{line.size}")
    if line.size == 1:
        return x

    def bc(v):
        out = v.clone().contiguous()
        torch.distributed.broadcast(out, src=line.ranks[src],
                                    group=line.group)
        return out

    return _tree_map(bc, x)


def all_to_all(x, group=None, split_axis: int = 0, concat_axis: int = 0):
    """All-to-all (the Ulysses primitive): each rank splits its value along
    ``split_axis`` into world chunks, sends chunk j to rank j, and
    concatenates what it receives along ``concat_axis`` in rank order."""
    line = _line(group)
    if line.size == 1:
        return x
    n = line.size

    def a2a(v):
        sa, ca = split_axis % v.dim(), concat_axis % v.dim()
        if v.shape[sa] % n:
            raise ValueError(f"all_to_all: axis {sa} of {tuple(v.shape)} "
                             f"does not split into {n}")
        send = torch.stack(v.chunk(n, dim=sa)).contiguous()
        recv = torch.empty_like(send)
        torch.distributed.all_to_all_single(recv, send, group=line.group)
        return torch.cat(list(recv.unbind(0)), dim=ca)

    return _tree_map(a2a, x)


def _exchange(v: torch.Tensor, line: _Line, send_to: Optional[int],
              recv_from: Optional[int]) -> Optional[torch.Tensor]:
    """One batch of point-to-point: send ``v`` to index ``send_to``,
    receive a tensor like it from index ``recv_from`` (either may be None)."""
    ops, out = [], None
    v = v.contiguous()
    if send_to is not None:
        ops.append(torch.distributed.P2POp(torch.distributed.isend, v,
                                           line.ranks[send_to], line.group))
    if recv_from is not None:
        out = torch.empty_like(v)
        ops.append(torch.distributed.P2POp(torch.distributed.irecv, out,
                                           line.ranks[recv_from],
                                           line.group))
    if ops:
        for req in torch.distributed.batch_isend_irecv(ops):
            wait_handle(req, line.group)
    return out


def ppermute(x, group=None, perm: Sequence[Tuple[int, int]] = ()):
    """Point-to-point permutation over the group's indices
    (``lax.ppermute``): for each ``(src, dst)`` pair, rank dst gets rank
    src's value; a rank no pair sends to gets zeros."""
    line = _line(group)
    perm = [(int(s), int(d)) for s, d in perm]
    me = line.index
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if len(send_to) > 1 or len(recv_from) > 1:
        raise ValueError(f"ppermute needs a permutation, got {perm}")
    if line.size == 1:
        return x if perm else _tree_map(torch.zeros_like, x)

    def move(v):
        got = _exchange(v, line, send_to[0] if send_to else None,
                        recv_from[0] if recv_from else None)
        return got if got is not None else torch.zeros_like(v)

    return _tree_map(move, x)


def ring_all_reduce(x, group=None, axis_size: Optional[int] = None):
    """Ring all-reduce spelled out, the JAX package's teaching ring: N-1
    reduce-scatter hops, then N-1 all-gather hops, each one
    ``batch_isend_irecv`` to the right neighbour and from the left.  The
    hops and the order of every addition are the JAX ring's, so the result
    is its result bit for bit.  Each leaf's leading dimension must divide
    by the group size."""
    line = _line(group)
    n = axis_size if axis_size is not None else line.size
    if n == 1:
        return x
    me = line.index
    right, left = (me + 1) % n, (me - 1) % n

    def ring(v):
        if v.shape[0] % n:
            raise ValueError(
                f"ring_all_reduce needs leading dim divisible by axis size "
                f"{n}; got shape {tuple(v.shape)}. Pad or use psum.")
        chunks = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
        # reduce-scatter: after n-1 hops this rank holds chunk (me+1) % n
        acc = chunks[me].clone()
        for i in range(n - 1):
            acc = _exchange(acc, line, right, left)
            acc = acc + chunks[(me - i - 1) % n]
        out = torch.zeros_like(chunks)
        out[(me + 1) % n] = acc
        piece = acc
        for i in range(n - 1):
            piece = _exchange(piece, line, right, left)
            out[(me - i) % n] = piece
        return out.reshape(v.shape)

    return _tree_map(ring, x)
