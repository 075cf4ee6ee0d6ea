"""Gradient bucketing — counterpart of ``tpu_dist/collectives/bucketer.py``:
coalesce a tree of tensors into flat buckets and all-reduce (or
reduce-scatter) each bucket as one asynchronous collective on the group's
backend (NCCL on the card, gloo on the CPU), the torch DDP Reducer's
discipline.

Buckets hold ``TPU_DIST_BUCKET_BYTES`` (25 MiB by default, torch DDP's
``bucket_cap_mb``), one dtype each, and fill in **reverse leaf order**
(backward produces the last leaves' gradients first).

**Chunk-major layout.**  Bucket chunk *c* is every member leaf's own chunk
*c*, each leaf split by :func:`chunk_bounds` (the first ``size % world``
chunks one element longer), the JAX ring's partition.  Each chunk is padded
with zeros to the bucket's longest (``reduce_scatter_tensor`` wants equal
chunks; a zero changes no sum), and ``all_reduce`` runs as
``reduce_scatter_tensor`` followed by ``all_gather_into_tensor`` over that
layout — never as NCCL's ``all_reduce``, which may pick a tree and sum in
another order.  So the shard :meth:`Bucketer.reduce_scatter` leaves on a
rank is, by construction, bit for bit the span the all-reduce gives there,
at any world: the property ZeRO (``parallel/zero.py``) rests on.  ``avg``
divides the owned chunk's sum by the world size (the ring's owner-side
division), and sub-32-bit floats are summed in float32 and integers as the
JAX ring sums them (``avg`` in float64, ``sum`` in int64), then cast back to
the JAX result dtype.

Leaves the collectives cannot reduce (empty, boolean or complex leaves, and
``prod``/bitwise ops) take one synchronous :func:`~tpu_dist_torch.
collectives.eager.all_reduce_host` at issue, as JAX routes them to its store
path.  ``comm_dtype=`` (wire compression) and ``error_feedback=`` belong to
the ring's hop order and come with the host data plane, ROADMAP A9.1b.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _tree
from .work import Work, completed_work, drain_pending, wait_all

__all__ = ["Bucketer", "BucketWork", "bucketed_all_reduce",
           "bucketed_reduce_scatter", "chunk_bounds", "DEFAULT_BUCKET_BYTES"]

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024  # torch DDP bucket_cap_mb parity

_RING_OPS = ("sum", "avg", "mean", "max", "min")
_TORCH_OP = {"sum": "SUM", "avg": "SUM", "mean": "SUM", "max": "MAX",
             "min": "MIN"}


def chunk_bounds(n_elems: int, n: int) -> List[Tuple[int, int]]:
    """Chunk boundaries ``[(lo, hi)] * n`` covering ``n_elems`` elements;
    the first ``n_elems % n`` chunks get one extra element (the JAX ring's
    ``_bounds``: ZeRO shards and reshard manifests cut the same spans)."""
    q, rem = divmod(int(n_elems), int(n))
    out, lo = [], 0
    for i in range(n):
        hi = lo + q + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _bucket_bytes_env() -> int:
    try:
        return max(4096, int(os.environ.get("TPU_DIST_BUCKET_BYTES",
                                            str(DEFAULT_BUCKET_BYTES))))
    except ValueError:
        return DEFAULT_BUCKET_BYTES


def _acc_dtype(dt: torch.dtype, op: str) -> torch.dtype:
    """The dtype a reduction runs in (the JAX ring's ``_acc_dtype``)."""
    if not dt.is_floating_point:
        if op in ("avg", "mean"):
            return torch.float64
        return torch.int64 if op == "sum" else dt
    if dt in (torch.bfloat16, torch.float16) and op not in ("max", "min"):
        return torch.float32
    return dt


def _out_dtype(dt: torch.dtype, op: str) -> torch.dtype:
    """The result dtype (``np.mean``'s for avg, ``np.add.reduce``'s for an
    integer sum)."""
    if not dt.is_floating_point and op in ("avg", "mean"):
        return torch.float64
    if not dt.is_floating_point and op == "sum":
        return torch.int64
    return dt


def _ring_leaf_ok(t: torch.Tensor, op: str) -> bool:
    return (op in _RING_OPS and t.numel() > 0 and t.dtype != torch.bool
            and not t.dtype.is_complex)


class ChunkLayout:
    """The chunk-major layout of leaves of ``sizes`` over ``n`` ranks:
    ``gather`` indexes ``cat(leaves) + [0]`` into the padded buffer (pad
    slots index the trailing zero), ``scatter`` indexes the buffer back into
    ``cat(leaves)``; ``width`` is the padded chunk length, ``spans[c][j]``
    leaf j's (lo, hi) in chunk c."""

    def __init__(self, sizes, n: int, device):
        self.sizes = [int(s) for s in sizes]
        self.n = n
        self.spans = [[chunk_bounds(s, n)[c] for s in self.sizes]
                      for c in range(n)]
        lens = [sum(hi - lo for lo, hi in self.spans[c]) for c in range(n)]
        self.chunk_len = lens
        self.width = max(max(lens), 1)
        total = sum(self.sizes)
        offs = np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(
            np.int64) if self.sizes else np.zeros(0, np.int64)
        gather = np.full(n * self.width, total, np.int64)
        for c in range(n):
            pos = c * self.width
            for j, (lo, hi) in enumerate(self.spans[c]):
                gather[pos:pos + hi - lo] = np.arange(offs[j] + lo,
                                                      offs[j] + hi)
                pos += hi - lo
        scatter = np.empty(total, np.int64)
        real = gather < total
        scatter[gather[real]] = np.nonzero(real)[0]
        self.gather = torch.from_numpy(gather).to(device)
        self.scatter = torch.from_numpy(scatter).to(device)

    def pack(self, leaves, dtype) -> torch.Tensor:
        """The padded chunk-major buffer of ``leaves`` in ``dtype``."""
        flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves]
                         + [torch.zeros(1, dtype=dtype,
                                        device=leaves[0].device)])
        return flat[self.gather]

    def unpack(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Inverse of :meth:`pack`: the flat leaves, in member order."""
        return list(buf[self.scatter].split(self.sizes))

    def split_chunk(self, chunk: torch.Tensor, rank: int
                    ) -> List[torch.Tensor]:
        """Rank ``rank``'s padded chunk as each member leaf's owned span."""
        return list(chunk[:self.chunk_len[rank]].split(
            [hi - lo for lo, hi in self.spans[rank]]))


class BucketWork:
    """Aggregate handle over one bucketed collective: per-bucket
    :class:`~tpu_dist_torch.collectives.work.Work` futures and the
    unflatten.  ``wait_all(timeout)`` returns the reduced tree."""

    def __init__(self, treedef, assemble, works: List[Work], label: str):
        self._treedef = treedef
        self._assemble = assemble
        self.works = list(works)
        self._label = label
        self._result = None
        self._done = False

    def wait_all(self, timeout: Optional[float] = None):
        """Wait for every bucket; returns the reduced tree.  The first
        captured error re-raises."""
        if self._done:
            return self._result
        results = wait_all(self.works, timeout)
        self._result = _tree.unflatten(self._treedef,
                                       self._assemble(results))
        self._done = True
        return self._result

    def wait(self, timeout: Optional[float] = None):
        return self.wait_all(timeout)

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self.works)

    def exception(self) -> Optional[BaseException]:
        for w in self.works:
            exc = w.exception()
            if exc is not None:
                return exc
        return None

    def __repr__(self):
        state = "done" if self._done else f"{len(self.works)} buckets"
        return f"BucketWork({self._label!r}, {state})"


class Bucketer:
    """Coalesces a tree's leaves into flat buckets and all-reduces (or
    reduce-scatters) them asynchronously; see the module docstring::

        bucketer = C.Bucketer()                  # 25 MiB buckets
        grads = bucketer.all_reduce(grads, op="avg", group=pg).wait_all()

    Leaves are tensors on the group's device (numpy leaves are moved
    there); they are copied into the buckets at issue, so the caller may
    change them as soon as the call returns.  The result's leaves are new
    tensors."""

    def __init__(self, bucket_bytes: Optional[int] = None,
                 comm_dtype=None):
        if comm_dtype is not None:
            raise NotImplementedError(
                "Bucketer(comm_dtype=): wire compression rides the host "
                "ring's hop order, which comes with the host data plane, "
                "ROADMAP A9.1b")
        self.bucket_bytes = (int(bucket_bytes) if bucket_bytes
                             else _bucket_bytes_env())
        self._layouts: Dict[tuple, ChunkLayout] = {}

    def layout(self, sizes, n: int, device) -> ChunkLayout:
        """The (cached) chunk-major layout of one bucket."""
        key = (tuple(sizes), n, str(device))
        lay = self._layouts.get(key)
        if lay is None:
            lay = self._layouts[key] = ChunkLayout(sizes, n, device)
        return lay

    def all_reduce(self, tree, op: str = "avg", group=None,
                   error_feedback=None) -> BucketWork:
        """Issue the bucketed async all-reduce of every leaf of ``tree``;
        ``wait_all()`` returns the reduced tree."""
        return self._issue(tree, op, group, False, error_feedback)

    def reduce_scatter(self, tree, op: str = "avg", group=None,
                       error_feedback=None) -> BucketWork:
        """The bucketed all-reduce stopped after its reduce-scatter:
        ``wait_all()`` returns a tree of the same structure whose leaves are
        this rank's owned flat chunk of each reduced leaf (1-D, span
        ``chunk_bounds(leaf.numel(), world)[rank]``; the whole flattened
        leaf at world 1), bit for bit the span :meth:`all_reduce` gives
        there.  The ZeRO entry point."""
        return self._issue(tree, op, group, True, error_feedback)

    def _issue(self, tree, op: str, group, scatter: bool,
               error_feedback) -> BucketWork:
        from . import eager as _eager
        if error_feedback is not None:
            raise NotImplementedError(
                "error_feedback= corrects a lossy wire format, which comes "
                "with the host data plane, ROADMAP A9.1b")
        op = str(op).lower()
        _eager._reduce_fn(op)  # validate before anything moves
        group = _eager._default_group(group)
        n, r = group.num_processes, group.rank
        kind = "bucket_reduce_scatter" if scatter else "bucket_all_reduce"
        leaves, treedef = _tree.flatten(tree)
        dev = group.device
        ts = [t if isinstance(t, torch.Tensor) else torch.as_tensor(
            np.asarray(t), device=dev) for t in leaves]
        label = f"{kind}[{op}]x{len(ts)}"
        if n <= 1:
            out = [t.detach().reshape(-1).clone() if scatter
                   else t.detach().clone() for t in ts]
            return BucketWork(treedef, lambda results: out,
                              [completed_work(None, label)], label)
        drain_pending()
        ring = [i for i, t in enumerate(ts) if _ring_leaf_ok(t, op)]
        rest = [i for i in range(len(ts)) if i not in set(ring)]
        # dtype-uniform buckets filled in REVERSE leaf order (DDP's
        # heuristic); the size cap counts each leaf's own bytes
        buckets: List[List[int]] = []
        open_by_dtype: Dict[torch.dtype, Tuple[List[int], List[int]]] = {}
        for i in reversed(ring):
            t = ts[i]
            nbytes = t.numel() * t.element_size()
            cur = open_by_dtype.get(t.dtype)
            if cur is None or cur[1][0] + nbytes > self.bucket_bytes:
                cur = ([], [0])
                buckets.append(cur[0])
                open_by_dtype[t.dtype] = cur
            cur[0].append(i)
            cur[1][0] += nbytes
        works, plans = [], []
        for bi, idxs in enumerate(buckets):
            works.append(self._bucket(ts, idxs, op, group, n, r, scatter,
                                      f"{label}/bkt{bi}"))
            plans.append(("bucket", idxs))
        if rest:
            vals = _eager.all_reduce_host(
                [ts[i].detach().cpu().numpy() for i in rest], group=group,
                op=op)
            works.append(completed_work(vals, f"{label}/host"))
            plans.append(("rest", rest))

        def assemble(results):
            out: List = [None] * len(ts)
            for (kind_, idxs), res in zip(plans, results):
                if kind_ == "bucket":
                    for i, v in zip(idxs, res):
                        out[i] = v if scatter else v.reshape(ts[i].shape)
                    continue
                for i, v in zip(idxs, res):
                    v = torch.as_tensor(np.asarray(v), device=dev)
                    if scatter:
                        lo, hi = chunk_bounds(v.numel(), n)[r]
                        v = v.reshape(-1)[lo:hi].clone()
                    out[i] = v
            return out

        return BucketWork(treedef, assemble, works, label)

    def _bucket(self, ts, idxs, op, group, n, r, scatter, label) -> Work:
        """One bucket's collective, issued now: ``reduce_scatter_tensor``
        of the packed buffer (the owner divides for ``avg``), then, for an
        all-reduce, ``all_gather_into_tensor``.  The Work's result is the
        member leaves' flat values (or owned spans), in member order."""
        members = [ts[i].detach() for i in idxs]
        dt = members[0].dtype
        acc, out_dt = _acc_dtype(dt, op), _out_dtype(dt, op)
        lay = self.layout([t.numel() for t in members], n, members[0].device)
        buf = lay.pack(members, acc)
        chunk = buf.new_empty(lay.width)
        red = getattr(torch.distributed.ReduceOp, _TORCH_OP[op])
        tg = group.torch_group
        h = torch.distributed.reduce_scatter_tensor(chunk, buf, op=red,
                                                    group=tg, async_op=True)
        if op in ("avg", "mean"):
            h.wait()   # on NCCL a stream wait: the host goes on
            # a 0-d device divisor: the card divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            chunk = chunk / torch.tensor(float(n), dtype=acc,
                                         device=chunk.device)
            handles = []
        else:
            handles = [h]
        stream = group.backend == "nccl"
        if scatter:
            def then():
                return [v.to(out_dt) for v in lay.split_chunk(chunk, r)]
            return Work(label, handles, then, on_stream=stream)
        if handles:
            handles[0].wait()
        full = buf.new_empty(n * lay.width)
        h2 = torch.distributed.all_gather_into_tensor(full, chunk, group=tg,
                                                      async_op=True)
        return Work(label, [h2],
                    lambda: [v.to(out_dt) for v in lay.unpack(full)],
                    on_stream=stream)


def bucketed_all_reduce(tree, op: str = "avg", group=None,
                        bucket_bytes: Optional[int] = None):
    """Synchronous convenience: the bucketed all-reduce, waited inline."""
    return Bucketer(bucket_bytes=bucket_bytes).all_reduce(
        tree, op=op, group=group).wait_all()


def bucketed_reduce_scatter(tree, op: str = "avg", group=None,
                            bucket_bytes: Optional[int] = None):
    """Synchronous convenience: the bucketed reduce-scatter, waited inline —
    this rank's owned flat shard of every leaf."""
    return Bucketer(bucket_bytes=bucket_bytes).reduce_scatter(
        tree, op=op, group=group).wait_all()
