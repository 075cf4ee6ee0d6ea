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
path.

**The host ring.**  Where the JAX Bucketer's ``use_ring`` holds — pinned
mode (``dp=``, the in-process multi-rank rigs; ring only), or the JAX
routing of the eager collectives (a store, the data plane on and the group
not on its backend: :func:`~tpu_dist_torch.collectives.eager._use_backend`)
— buckets ride the JAX package's own path instead: packed chunk-major on
the host at issue (a CUDA leaf is copied into pinned host memory on the
caller's stream, and that copy is waited before the pack), each bucket one
:func:`~tpu_dist_torch.collectives.ring.ring_all_reduce` (or
``ring_reduce_scatter``) on the ordered engine with the leaves' own chunk
bounds, so the results are bit for bit the JAX Bucketer's; a result leaf
goes back to its leaf's device (a numpy leaf stays numpy).  Only there does
the wire compress: ``comm_dtype=`` in pinned mode, ``TPU_DIST_COMM_DTYPE``
otherwise (the JAX package reads it so), and ``error_feedback=`` (an
:class:`~tpu_dist_torch.collectives.quant.ErrorFeedback`) keeps the full
residual per bucket for the all-reduce and the owner residual per leaf for
the reduce-scatter.  On the backend path neither applies, as the JAX
Bucketer's mesh path applies neither.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _lowp, _tree
# the ring's flat chunk contract (``parallel.rules.chunk_bounds``)
from .ring import _bounds as chunk_bounds
from .work import (Work, completed_work, drain_pending, engine_for, wait_all,
                   wait_handle)

__all__ = ["Bucketer", "BucketWork", "bucketed_all_reduce",
           "bucketed_reduce_scatter", "chunk_bounds", "DEFAULT_BUCKET_BYTES"]

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024  # torch DDP bucket_cap_mb parity

_RING_OPS = ("sum", "avg", "mean", "max", "min")
_TORCH_OP = {"sum": "SUM", "avg": "SUM", "mean": "SUM", "max": "MAX",
             "min": "MIN"}


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

    def __init__(self, bucket_bytes: Optional[int] = None, dp=None,
                 comm_dtype=None):
        self.bucket_bytes = (int(bucket_bytes) if bucket_bytes
                             else _bucket_bytes_env())
        self._layouts: Dict[tuple, ChunkLayout] = {}
        # pinned mode: one DataPlane (an in-process rig's fake rank), its
        # own ordered engine, ring only; comm_dtype applies here only
        self._dp = dp
        self._comm_dtype = comm_dtype
        self._seq = 0
        self._seq_mu = threading.Lock()
        self._pinned: Dict[tuple, torch.Tensor] = {}
        # the host ring's staging times of the last issue and assemble
        # (seconds): the D2H copies, the pack, the H2D copies
        self.staging = {"d2h_s": 0.0, "pack_s": 0.0, "h2d_s": 0.0}

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
        op = str(op).lower()
        _eager._reduce_fn(op)  # validate before anything moves
        if self._dp is not None:
            return self._issue_ring(tree, op, None, scatter, error_feedback)
        group = _eager._default_group(group)
        n, r = group.num_processes, group.rank
        if n > 1 and _eager._dp_enabled() and not _eager._use_backend(
                group, _eager._coll_store()):
            return self._issue_ring(tree, op, group, scatter,
                                    error_feedback)
        kind = "bucket_reduce_scatter" if scatter else "bucket_all_reduce"
        leaves, treedef = _tree.flatten(tree)
        # a data-plane SubGroup (a role's group) has no device: numpy
        # leaves stay on the host there
        dev = getattr(group, "device", None)
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
                    v = torch.as_tensor(np.asarray(v), device=ts[i].device)
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
            wait_handle(h, tg)   # on NCCL a stream wait: the host goes on
            # a 0-d device divisor: the card divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            chunk = chunk / torch.tensor(float(n), dtype=acc,
                                         device=chunk.device)
            handles = []
        else:
            handles = [h]
        if scatter:
            def then():
                return [v.to(out_dt) for v in lay.split_chunk(chunk, r)]
            return Work(label, handles, then, group=tg)
        if handles:
            wait_handle(handles[0], tg)
        full = buf.new_empty(n * lay.width)
        h2 = torch.distributed.all_gather_into_tensor(full, chunk, group=tg,
                                                      async_op=True)
        return Work(label, [h2],
                    lambda: [v.to(out_dt) for v in lay.unpack(full)],
                    group=tg)

    # -- the host ring (the JAX Bucketer's path) ------------------------------

    def _issue_ring(self, tree, op: str, group, scatter: bool,
                    error_feedback) -> BucketWork:
        from . import eager as _eager
        pinned = self._dp is not None
        n = self._dp.num_processes if pinned else group.num_processes
        r = self._dp.rank if pinned else group.rank
        kind = "bucket_reduce_scatter" if scatter else "bucket_all_reduce"
        leaves, treedef = _tree.flatten(tree)
        arrs = self._snapshot(leaves)
        label = f"{kind}[{op}]x{len(arrs)}"

        def home(i, a):
            # a result leaf goes back to its leaf's device
            leaf = leaves[i]
            if not isinstance(leaf, torch.Tensor):
                return a
            return _lowp.to_torch(a, leaf.device)

        if n <= 1:
            out = [home(i, a.reshape(-1) if scatter else a)
                   for i, a in enumerate(arrs)]
            return BucketWork(treedef, lambda results: out,
                              [completed_work(None, label)], label)
        ring_set = {i for i, a in enumerate(arrs) if _host_ring_ok(a, op)}
        rest_idx = [i for i in range(len(arrs)) if i not in ring_set]
        if pinned and rest_idx:
            bad = {str(arrs[i].dtype) for i in rest_idx if arrs[i].size}
            raise ValueError(
                f"Bucketer(dp=...) is a ring-only harness; leaves with "
                f"dtypes {sorted(bad)} (or empty leaves) cannot ride it "
                f"for op {op!r}")
        # dtype-uniform buckets filled in REVERSE leaf order
        buckets: List[_HostBucket] = []
        open_by_dtype: Dict[np.dtype, _HostBucket] = {}
        for i in sorted(ring_set, reverse=True):
            a = arrs[i]
            b = open_by_dtype.get(a.dtype)
            if b is None or b.nbytes + a.nbytes > self.bucket_bytes:
                b = _HostBucket(a.dtype)
                buckets.append(b)
                open_by_dtype[a.dtype] = b
            b.add(i, a.reshape(-1))
        engine = engine_for(self._dp)
        issue_seq = self._next_issue_seq() if pinned else -1
        comm_spec = self._comm_dtype if pinned else _eager._comm_dtype()
        works, plans = [], []
        t0 = time.perf_counter()
        for bi, bucket in enumerate(buckets):
            # packed HERE, on the caller's thread: the bucket is the
            # issue-time snapshot the JAX Bucketer promises
            packed = bucket.pack(n)
            residuals = _bucket_residuals(bucket, bi, packed, n, r,
                                          error_feedback, comm_spec,
                                          scatter)
            works.append(engine.submit(
                self._bucket_body(packed, op, n, group, issue_seq, bi,
                                  scatter, comm_spec, residuals),
                label=f"{label}/bkt{bi}"))
            plans.append(("bucket", bucket))
        self.staging["pack_s"] = time.perf_counter() - t0
        if rest_idx:
            sub = [np.array(arrs[i]) for i in rest_idx]

            def rest_body(sub=sub, group=group, op=op):
                # one eager call: the small and exotic leaves batch into
                # one store round, as a synchronous tree call would
                return _eager.all_reduce_host(sub, group=group, op=op)

            works.append(engine.submit(rest_body, label=f"{label}/store"))
            plans.append(("rest", rest_idx))

        def assemble(results):
            t1 = time.perf_counter()
            out: List = [None] * len(arrs)
            for (kind_, plan), res in zip(plans, results):
                if kind_ == "bucket":
                    if scatter:
                        chunk, leaf_bounds = res
                        pos = 0
                        for idx, b in zip(plan.indices, leaf_bounds):
                            flo, fhi = b[r]
                            out[idx] = home(idx, np.array(
                                chunk[pos:pos + fhi - flo]))
                            pos += fhi - flo
                    else:
                        flats = plan.unpack(res[0], n, res[1])
                        for idx, flat in zip(plan.indices, flats):
                            out[idx] = home(idx, flat.reshape(
                                arrs[idx].shape))
                    continue
                for idx, val in zip(plan, res):
                    a = np.asarray(val)
                    if scatter:
                        lo, hi = chunk_bounds(a.size, n)[r]
                        a = np.array(a.reshape(-1)[lo:hi])
                    out[idx] = home(idx, a)
            self.staging["h2d_s"] = time.perf_counter() - t1
            return out

        return BucketWork(treedef, assemble, works, label)

    def _snapshot(self, leaves) -> List[np.ndarray]:
        """Host copies of the leaves, taken now.  CUDA leaves copy into
        pinned buffers (kept across steps) on the caller's current stream,
        and the copies are waited before anything reads them."""
        t0 = time.perf_counter()
        out: List = [None] * len(leaves)
        streams = set()
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                out[i] = np.array(leaf)
                continue
            t = leaf.detach()
            if t.device.type != "cuda":
                out[i] = np.array(_lowp.from_torch(t))
                continue
            key = (i, tuple(t.shape), t.dtype)
            host = self._pinned.get(key)
            if host is None:
                host = self._pinned[key] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
            out[i] = host
        for st in streams:
            st.synchronize()
        # the pinned buffers are reused next issue: the bucket pack (or
        # this copy, for leaves the ring does not take) is the snapshot
        out = [_lowp.from_torch(a) if isinstance(a, torch.Tensor) else a
               for a in out]
        self.staging["d2h_s"] = time.perf_counter() - t0
        return out

    def _next_issue_seq(self) -> int:
        with self._seq_mu:
            s = self._seq
            self._seq += 1
            return s

    def _bucket_body(self, packed, op: str, n: int, group, issue_seq: int,
                     bi: int, scatter: bool, comm_spec, residuals):
        """The deferred per-bucket ring collective on the ordered engine:
        returns ``(reduced_flat, leaf_bounds)``, or with ``scatter`` this
        rank's ``(owned_chunk, leaf_bounds)``."""
        buf, bucket_bounds, leaf_bounds = packed
        op_name = "bucket_reduce_scatter" if scatter else "bucket_all_reduce"

        def body():
            from . import eager as _eager
            from . import ring as _ring
            if self._dp is not None:
                dp = self._dp
                tag = f"bkt/i{issue_seq}/{bi}"
            else:
                store = _eager._coll_store()
                # drawn in engine order: every rank submits the same
                # buckets in the same order
                seq = _eager._next_seq("bucket_rs" if scatter
                                       else "bucket_ar", 0)
                tag = f"{_eager._ns()}/coll/bkt/{seq}"
                _eager._sanitize(op_name, group, store,
                                 value=buf, reduce_op=op)
                dp = _eager._maybe_data_plane(group, store)
            residual = leaf_res = None
            if residuals is not None:
                kind, payload = residuals
                if kind == "full":
                    residual = payload  # the ring updates it in place
                else:
                    leaf_res = payload
                    residual = (payload[0] if len(payload) == 1
                                else np.concatenate(
                                    [np.asarray(a) for a in payload]))
            with _eager._obs_span(op_name, value=buf, reduce_op=op):
                t0 = time.perf_counter()
                stats: dict = {}
                fn = _ring.ring_reduce_scatter if scatter else \
                    _ring.ring_all_reduce
                reduced = fn(dp, buf, op=op, tag=tag, comm_dtype=comm_spec,
                             bounds=bucket_bounds, quant_residual=residual,
                             stats=stats)
                _eager._record(
                    op_name, "dataplane", buf.nbytes, t0,
                    wire_bytes=stats.get("wire_bytes"),
                    raw_wire_bytes=stats.get("raw_wire_bytes"))
            if leaf_res is not None and len(leaf_res) > 1:
                # scatter the updated concatenation back into the per-leaf
                # residual arrays
                pos = 0
                for a in leaf_res:
                    a[...] = residual[pos:pos + a.size]
                    pos += a.size
            return reduced, leaf_bounds

        return body


def _host_ring_ok(a: np.ndarray, op: str) -> bool:
    """True iff the host ring can reduce this leaf (dtype and op only, so
    every rank answers the same; the JAX Bucketer's ``_ring_leaf_ok``)."""
    from . import ring as _ring
    if op not in _ring.RING_OPS or a.size == 0:
        return False
    return a.dtype.kind in "iuf" or _lowp.is_lowp(a.dtype)


class _HostBucket:
    """One dtype-uniform host bucket: member leaf indices and flat arrays,
    packed chunk-major (bucket chunk *c* = every member's own chunk *c*)."""

    __slots__ = ("dtype", "indices", "flats", "nbytes")

    def __init__(self, dtype: np.dtype):
        self.dtype = dtype
        self.indices: List[int] = []
        self.flats: List[np.ndarray] = []
        self.nbytes = 0

    def add(self, idx: int, flat: np.ndarray) -> None:
        self.indices.append(idx)
        self.flats.append(flat)
        self.nbytes += flat.nbytes

    def pack(self, n: int):
        """``(buf, bucket_bounds, leaf_bounds)``: the flat chunk-major
        bucket, the span of each bucket chunk, each leaf's ring bounds."""
        leaf_bounds = [chunk_bounds(f.size, n) for f in self.flats]
        buf = np.empty(sum(f.size for f in self.flats), dtype=self.dtype)
        bucket_bounds = []
        pos = 0
        for c in range(n):
            lo = pos
            for f, b in zip(self.flats, leaf_bounds):
                flo, fhi = b[c]
                if fhi > flo:
                    buf[pos:pos + (fhi - flo)] = f[flo:fhi]
                    pos += fhi - flo
            bucket_bounds.append((lo, pos))
        return buf, bucket_bounds, leaf_bounds

    def unpack(self, reduced: np.ndarray, n: int, leaf_bounds) -> List:
        """Invert :meth:`pack`: the members' flat reduced arrays."""
        outs = [np.empty(f.size, dtype=reduced.dtype) for f in self.flats]
        pos = 0
        for c in range(n):
            for out, b in zip(outs, leaf_bounds):
                flo, fhi = b[c]
                if fhi > flo:
                    out[flo:fhi] = reduced[pos:pos + (fhi - flo)]
                    pos += fhi - flo
        return outs


def _bucket_residuals(bucket, bi: int, packed, n: int, r: int,
                      error_feedback, comm_spec, scatter: bool):
    """A bucket's error-feedback residual(s), or None without a residual
    loop: ``("full", buf)`` (the all-reduce: every hop and the owner, in
    bucket layout) or ``("leaves", [arrays])`` (the reduce-scatter: each
    member's owned-chunk residual, possibly views into ``zstate["ef"]``).
    The arrays live in the caller's ErrorFeedback, keyed by bucket index
    (stable for one tree structure) or leaf index."""
    if error_feedback is None or comm_spec is None or n <= 1:
        return None
    buf, _, leaf_bounds = packed
    dt = np.dtype(bucket.dtype)
    if not _lowp.is_float(dt):  # a lossy wire never touches exact ints
        return None
    if not scatter:
        return ("full", error_feedback.residual_for(
            ("bucket", bi, dt.str), buf.size, dt))
    return ("leaves",
            [error_feedback.residual_for(idx, b[r][1] - b[r][0], dt)
             for idx, b in zip(bucket.indices, leaf_bounds)])


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
