"""Sequence-parallel attention — counterpart of
``tpu_dist/parallel/ring_attention.py``: ring attention and Ulysses.

Both run on every rank of a mesh axis that shards the sequence (the
``"seq"`` axis of ``init_process_group(axis_names=, mesh_shape=)``), on this
rank's shard: q, k, v (B, T/n, H, D) → the output shard (B, T/n, H, D),
equal to attention over the gathered sequence.  At size 1 they are
attention on the local sequence, and nothing is communicated.

**Ring** (:func:`ring_self_attention`): the k/v shards travel backward
around the ring (rank d sends to d − 1), so at hop i rank d holds the block
of rank (d + i) mod n.  Each live block goes through K2f, and the partial
``(o, lse)`` merge in float32 (:func:`tpu_dist_torch.ops.merge_lse`).  Under
a causal mask hop 0 is the diagonal block (causal) and a later block counts
in full if it comes from a lower rank, else it is skipped.

The ring is one ``torch.autograd.Function``: autograd never sees a send or a
receive.  A rank that skips its last blocks would otherwise leave their
shifts out of its graph and skip backward sends its neighbour waits for.
Here the backward runs the same n hops with (k, v, dk, dv) travelling
together: each live block goes through K2b with the merged lse and one
``delta = rowsum(dO·O)`` (as the JAX package's ``_split_bwd`` shares them),
and a last shift brings dk/dv home.  Every rank makes the same sends in the
same order whatever it skips, and keeps O(T/n) memory: the residuals are the
local q, k, v, o and lse.

The maths of a hop is in :func:`ring_forward_hop` and
:func:`ring_backward_hop`; :func:`_shift` is the only communication
(``batch_isend_irecv`` over the axis group: gloo on the CPU, NCCL on the
card).  :func:`ring_one_process` drives the same hop functions over n
virtual ranks in one process, lists standing in for the shifts.

**Ulysses** (:func:`ulysses_self_attention`): an all-to-all turns the
sequence shards into head shards (B, T, H/n, D), attention runs locally
(:func:`tpu_dist_torch.nn.attention.scaled_dot_product_attention`) and the
inverse all-to-all turns it back; H must divide by n.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import dist
from ..collectives.work import wait_handle
from ..ops.flash_attention import (flash_bwd, flash_bwd_plain, flash_fwd,
                                   flash_fwd_plain, merge_lse)

__all__ = ["ring_self_attention", "ulysses_self_attention",
           "ring_forward_hop", "ring_backward_hop", "ring_block_mode",
           "ring_one_process"]

_IMPLS = ("flash", "dense")


def _impl(impl, device) -> str:
    """``"auto"``/None: flash on the card, dense on the CPU."""
    if impl in (None, "auto"):
        return "flash" if device.type == "cuda" else "dense"
    if impl not in _IMPLS:
        raise ValueError(f"Unknown ring attention impl {impl!r}")
    return impl


def ring_block_mode(i: int, me: int, n: int, causal: bool):
    """How rank ``me``'s queries meet the block of hop ``i`` (from rank
    (me + i) mod n): ``True`` (the diagonal block, causal), ``False`` (in
    full) or ``None`` (above the diagonal: skipped)."""
    if not causal:
        return False
    if i == 0:
        return True
    return False if (me + i) % n < me else None


def ring_forward_hop(q, k, v, block_causal, sm_scale: float, impl: str,
                     acc):
    """One forward hop: q against the visiting block ``k, v`` (``mode``
    from :func:`ring_block_mode`; ``None`` leaves ``acc`` as it is), merged
    into ``acc`` — None, or ``(o (B, T, H, D), lse (B, H, T))`` — and
    returned.  The first block's o stays in q's dtype (a ring of one is a
    plain K2f call); every merge is in float32.  ``impl="flash"`` runs K2f,
    ``"dense"`` its plain version."""
    if block_causal is None:
        return acc
    fwd = flash_fwd if impl == "flash" else flash_fwd_plain
    o, lse = fwd(q, k, v, block_causal, sm_scale)
    if acc is None:
        return o, lse
    return merge_lse(acc[0], acc[1], o, lse)


def ring_backward_hop(q, k, v, do, lse, delta, block_causal, sm_scale: float,
                      impl: str, grads):
    """One backward hop: the visiting block's share of the gradients from
    the merged ``lse`` and ``delta`` (both (B, H, T) float32), added to
    ``grads`` = (dq, dk, dv) (dk, dv the travelling accumulators of the
    visiting block), which are returned.  A None accumulator (before its
    first share: hop 0, which every rank computes) takes the share as it
    is; later shares are summed in float32, in place."""
    if block_causal is None:
        return grads
    bwd = flash_bwd if impl == "flash" else flash_bwd_plain
    shares = bwd(q, k, v, do, lse, delta, block_causal, sm_scale)
    return tuple(g if acc is None else acc.float().add_(g)
                 for acc, g in zip(grads, shares))


def _shift(tensors, axis):
    """Each tensor to the previous rank of the axis, and the next rank's in
    its place (rank d sends to d − 1): one ``batch_isend_irecv``.  Nothing
    is communicated at size 1."""
    if axis.size == 1:
        return list(tensors)
    n = axis.size
    dst = axis.ranks[(axis.index - 1) % n]
    src = axis.ranks[(axis.index + 1) % n]
    out = [torch.empty_like(t, memory_format=torch.contiguous_format)
           for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, out)):
        ops.append(torch.distributed.P2POp(torch.distributed.isend,
                                           t.contiguous(), dst, axis.group,
                                           tag))
        ops.append(torch.distributed.P2POp(torch.distributed.irecv, o, src,
                                           axis.group, tag))
    for req in torch.distributed.batch_isend_irecv(ops):
        wait_handle(req, axis.group)
    return out


def _delta(do, o):
    """rowsum(dO·O), (B, H, T) float32 contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _Ring(torch.autograd.Function):
    """The ring over ``axis`` (an :class:`~tpu_dist_torch.dist.AxisGroup`):
    forward and backward as the module docstring says."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, impl, sm_scale):
        n, me = axis.size, axis.index
        acc, kv = None, (k, v)
        for i in range(n):
            if i:
                kv = _shift(kv, axis)
            acc = ring_forward_hop(q, *kv, ring_block_mode(i, me, n, causal),
                                   sm_scale, impl, acc)
        o, lse = acc[0].to(q.dtype), acc[1]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = axis, causal, impl, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, impl, sm_scale = ctx.args
        n, me = axis.size, axis.index
        do = do.contiguous()
        delta = _delta(do, o)
        kk, vv, dq, dk, dv = k, v, None, None, None
        for i in range(n):
            if i:
                # the accumulators travel in float32 on every rank, whatever
                # it skipped: a send and its receive must match in size
                kk, vv, dk, dv = _shift((kk, vv, dk.float(), dv.float()),
                                        axis)
            dq, dk, dv = ring_backward_hop(
                q, kk, vv, do, lse, delta, ring_block_mode(i, me, n, causal),
                sm_scale, impl, (dq, dk, dv))
        if n > 1:  # block d's accumulator ends on rank d + 1: one hop home
            dk, dv = _shift((dk.float(), dv.float()), axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_self_attention(q, k, v, axis_name: str, causal: bool = False,
                        impl: Optional[str] = None):
    """Exact attention over the sequence sharded on mesh axis
    ``axis_name`` of the default process group: this rank's (B, T/n, H, D)
    shards in, its output shard out.  ``impl``: ``"flash"``
    (K2f/K2b a live block), ``"dense"`` (their plain versions), or
    None/``"auto"``: flash on the card, dense on the CPU."""
    axis = dist.axis_group(axis_name)
    return _Ring.apply(q, k, v, axis, bool(causal), _impl(impl, q.device),
                       1.0 / math.sqrt(q.shape[-1]))


def ring_one_process(qs, ks, vs, causal: bool, impl: str = "flash",
                     dos=None):
    """The ring over n virtual ranks in one process: ``qs, ks, vs`` hold
    each rank's shard, lists stand in for :func:`_shift`, and every hop runs
    :func:`ring_forward_hop` / :func:`ring_backward_hop` as a rank of
    :func:`ring_self_attention` runs them, the accumulators summed in the
    same order.  Returns the output shards and, given the output cotangents
    ``dos``, the ``(dq, dk, dv)`` of each rank."""
    n = len(qs)
    impl = _impl(impl, qs[0].device)
    sm_scale = 1.0 / math.sqrt(qs[0].shape[-1])
    accs = [None] * n
    for i in range(n):
        for me in range(n):
            src = (me + i) % n
            accs[me] = ring_forward_hop(qs[me], ks[src], vs[src],
                                        ring_block_mode(i, me, n, causal),
                                        sm_scale, impl, accs[me])
    outs = [a[0].to(q.dtype) for a, q in zip(accs, qs)]
    if dos is None:
        return outs
    dos = [do.contiguous() for do in dos]
    deltas = [_delta(do, o) for do, o in zip(dos, outs)]
    dqs, dks, dvs = [None] * n, [None] * n, [None] * n
    for i in range(n):
        for me in range(n):
            src = (me + i) % n
            dqs[me], dks[src], dvs[src] = ring_backward_hop(
                qs[me], ks[src], vs[src], dos[me], accs[me][1], deltas[me],
                ring_block_mode(i, me, n, causal), sm_scale, impl,
                (dqs[me], dks[src], dvs[src]))
    return outs, [(dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
                  for dq, dk, dv, q, k, v in zip(dqs, dks, dvs, qs, ks, vs)]


class _AllToAll(torch.autograd.Function):
    """Ulysses' re-shard over ``axis``: ``to_heads`` takes (B, T/n, H, D)
    to (B, T, H/n, D) (heads split over the ranks, the sequence gathered in
    rank order; ``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``),
    otherwise the inverse.  The backward is the other direction."""

    @staticmethod
    def forward(ctx, x, axis, to_heads: bool):
        ctx.args = axis, to_heads
        return _all_to_all(x, axis, to_heads)

    @staticmethod
    def backward(ctx, g):
        axis, to_heads = ctx.args
        return _all_to_all(g, axis, not to_heads), None, None


def _all_to_all(x, axis, to_heads: bool):
    n = axis.size
    if n == 1:
        return x
    b, t, h, d = x.shape
    if to_heads:  # chunk j of the heads goes to rank j
        send = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    else:  # chunk j of the sequence goes to rank j
        send = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(recv, send, group=axis.group)
    # recv[j]: rank j's piece, in rank order along the gathered axis
    if to_heads:  # (n, B, T/n, H/n, D) → (B, T, H/n, D)
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)
    # (n, B, T/n, H/n, D) → (B, T/n, H, D)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)


def ulysses_self_attention(q, k, v, axis_name: str, causal: bool = False,
                           impl: Optional[str] = None):
    """Sequence-parallel attention by head redistribution: (B, T/n, H, D)
    → all-to-all → (B, T, H/n, D) → local attention (``impl`` as in
    :func:`~tpu_dist_torch.nn.attention.scaled_dot_product_attention`:
    auto = flash on the card) → all-to-all back.  Needs H % n == 0."""
    axis = dist.axis_group(axis_name)
    n = axis.size
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[2]}) divisible by the "
            f"sequence-axis size ({n}); use ring_self_attention instead")
    from ..nn.attention import scaled_dot_product_attention

    qh, kh, vh = (_AllToAll.apply(x, axis, True) for x in (q, k, v))
    out = scaled_dot_product_attention(qh, kh, vh, causal=causal, impl=impl)
    return _AllToAll.apply(out, axis, False)
