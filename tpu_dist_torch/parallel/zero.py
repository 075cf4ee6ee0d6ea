"""ZeRO-1/2 on the group's collectives — counterpart of
``tpu_dist/parallel/zero.py``: reduce-scatter the gradients, shard the
optimizer update, all-gather the parameters asynchronously.

The :class:`~tpu_dist_torch.collectives.Bucketer` lays every bucket out
chunk-major, so its reduce-scatter leaves each rank exactly its chunk of
every reduced leaf, bit for bit the span the bucketed all-reduce gives
there.  :class:`ZeroOptimizer` stops there: it keeps the wrapped
optimizer's state (Adam's moments, SGD's momentum) only for the owned
chunks — optimizer-state memory ÷ world — runs the wrapped update on the
flat owned shard on the card (one multi-tensor group instead of one per
leaf), and redistributes the updated parameters with an **asynchronous**
``all_gather_into_tensor`` over the same chunk-major layout, waited lazily
(:meth:`ZeroParams.wait`), so the next step's input staging runs under it.

**Bitwise story.**  The wrapped optimizers are element-wise, so updating
the flat shard gives the parameters the replicated update gives, bit for
bit, at any world (the shard is the all-reduce's own span); only
``max_grad_norm`` couples elements, and
:func:`~tpu_dist_torch.optim.sharded_clip_grad_norm` is bitwise at world 1
and equal within rounding across worlds.

``init``'s state is the JAX package's pytree — ``{"shards": {dtype: flat},
"opt": <wrapped optimizer state over the shards>, "meta": {rank, world,
span_lo, span_hi, leaf_size, leaf_dtype}}`` with the dtype groups keyed by
numpy's dtype string (``"<f4"``) in leaf order — so a sharded checkpoint of
it (``resilience.TrainState(shard=, sharded_keys=("zero",))``) reshards at
another world size (``resilience/reshard.py``) and crosses packages.
Leaves are ordered as ``jax.tree`` orders them (sorted dict keys).

**On the host ring.**  Where the Bucketer takes the host ring (pinned
mode, ``dp=``, or the eager collectives' JAX routing), ZeRO does as the
JAX package does: the gradient reduce-scatter is the Bucketer's ring
reduce-scatter (``comm_dtype=`` in pinned mode, ``TPU_DIST_COMM_DTYPE``
otherwise), the parameter gather one
:func:`~tpu_dist_torch.collectives.ring.ring_chunk_all_gather` per dtype
group on the ordered engine (``gather_comm_dtype=`` compresses it, lossy
on the replicated parameters; the master shards stay exact), and
``error_feedback=True`` keeps the owner residual in ``zstate["ef"]``: one
flat host (CPU) tensor per dtype group in the shard layout, so it rides
the sharded checkpoint and the reshard manifest; the ring updates it in
place through numpy views.  On the backend path the wire is not
compressed and the residual stays zero.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..collectives import _lowp, _tree
from ..collectives.bucketer import BucketWork, Bucketer
from .rules import chunk_bounds
from ..collectives.work import (Work, completed_work, drain_pending,
                                engine_for, wait_all)

__all__ = ["ZeroOptimizer", "ZeroParams", "ZeroStateError"]


class ZeroStateError(RuntimeError):
    """A ZeRO optimizer state does not match this run's shard layout
    (another world size, rank or parameter structure).  A state built at
    another world size is carried over by elastic resharding
    (``resilience.TrainState.resume`` / ``resilience.reshard``), never
    loaded directly."""


def _dtype_key(dt: torch.dtype) -> str:
    """numpy's dtype string of a torch dtype (``"<f4"``; bfloat16 is
    ``"<V2"``, as ``ml_dtypes`` spells it): the key of a ZeRO dtype group
    and the ``leaf_dtype`` the reshard manifest records."""
    if dt == torch.bfloat16:
        return "<V2"
    return np.dtype(torch.empty((), dtype=dt).numpy().dtype).str


class _Plan:
    """The static shard layout of one parameter structure at one (rank,
    world): per-leaf owned spans and the dtype groups, each ONE flat shard
    (its member leaves' owned chunks concatenated in leaf order)."""

    def __init__(self, treedef, shapes, dtypes, rank: int, world: int,
                 groups, device):
        self.treedef = treedef
        self.shapes = shapes
        self.dtypes = dtypes
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        self.rank = rank
        self.world = world
        self.spans = [chunk_bounds(s, world)[rank] if s else (0, 0)
                      for s in self.sizes]
        self.groups: List[Tuple[str, List[int]]] = groups
        self.device = device
        # the layout metadata a state must carry (checked every update)
        self.meta = {
            "rank": rank, "world": world,
            "span_lo": [s[0] for s in self.spans],
            "span_hi": [s[1] for s in self.spans],
            "leaf_size": self.sizes,
            "leaf_dtype": [_dtype_key(d) for d in dtypes],
        }


class ZeroParams:
    """Handle for the in-flight parameter all-gather: ``wait(timeout)``
    returns the full parameter tree.  On NCCL ``wait`` orders the card's
    current stream after the gather and returns without blocking the host;
    read no parameter before it (a read would race the gather)."""

    def __init__(self, works: List[Work], assemble, label: str):
        self.works = list(works)
        self._assemble = assemble
        self._label = label
        self._result = None
        self._done = False

    def wait(self, timeout: Optional[float] = None):
        if self._done:
            return self._result
        self._result = self._assemble(wait_all(self.works, timeout))
        self._done = True
        return self._result

    wait_all = wait

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self.works)

    def exception(self) -> Optional[BaseException]:
        for w in self.works:
            exc = w.exception()
            if exc is not None:
                return exc
        return None

    def __repr__(self):
        state = "done" if self._done else f"{len(self.works)} gathers"
        return f"ZeroParams({self._label!r}, {state})"


class ZeroOptimizer:
    """Wrap a :mod:`tpu_dist_torch.optim` optimizer (``SGD``, ``AdamW``,
    ... — ``init(params)`` / ``update(grads, state, params)``, element-wise)
    with ZeRO-1/2 sharding over ``group`` (the default group when None).

    ``bucket_bytes``: the gradient reduce-scatter's bucket size (the
    Bucketer's default).  ``max_grad_norm``: a global-norm clip of the
    sharded gradients (one scalar all-reduce).  ``reduce_op``: ``"avg"``
    (the DDP convention) or ``"sum"``.  ``dp``: pin a DataPlane (the
    in-process multi-rank rigs; ring only).  ``comm_dtype``,
    ``error_feedback`` and ``gather_comm_dtype``: the host ring's wire, see
    the module docstring.

    Usage (the elastic loop's shape)::

        zopt = ZeroOptimizer(optim.SGD(0.01, momentum=0.9), group=pg)
        zstate = zopt.init(params)
        handle = None
        for step in range(start, n):
            x, y = batch(step)                     # overlaps the gather …
            if handle is not None:
                params = handle.wait(timeout=300)  # … waited lazily
            grads = fwd_bwd(params, x, y)
            handle, zstate = zopt.update(zopt.reduce_scatter(grads), zstate)
    """

    def __init__(self, opt, group=None, bucket_bytes: Optional[int] = None,
                 max_grad_norm: Optional[float] = None,
                 reduce_op: str = "avg", dp=None, comm_dtype=None,
                 error_feedback: bool = False, gather_comm_dtype=None):
        self.opt = opt
        self.max_grad_norm = max_grad_norm
        self.reduce_op = str(reduce_op).lower()
        self._dp = dp
        self._bucketer = Bucketer(bucket_bytes=bucket_bytes, dp=dp,
                                  comm_dtype=comm_dtype)
        self._group = group
        self.error_feedback = bool(error_feedback)
        self.gather_comm_dtype = gather_comm_dtype
        self._plan: Optional[_Plan] = None
        self._seq = 0   # pinned mode's gather tags, drawn at issue

    # -- plan -----------------------------------------------------------------

    def _resolve(self, group):
        if self._dp is not None:
            return None, self._dp.num_processes, self._dp.rank
        from ..collectives.eager import _default_group
        g = _default_group(group if group is not None else self._group)
        return g, g.num_processes, g.rank

    def _on_ring(self, group, n: int) -> bool:
        """Whether this run's collectives take the host ring (the JAX
        ``use_ring``)."""
        if n <= 1:
            return False
        if self._dp is not None:
            return True
        from ..collectives import eager as _eager
        return _eager._dp_enabled() and not _eager._use_backend(
            group, _eager._coll_store())

    def _build_plan(self, params) -> _Plan:
        group, n, r = self._resolve(None)
        leaves, treedef = _tree.flatten(params)
        groups: List[Tuple[str, List[int]]] = []
        by_key: Dict[str, List[int]] = {}
        for i, t in enumerate(leaves):
            key = _dtype_key(t.dtype)
            if key not in by_key:
                by_key[key] = []
                groups.append((key, by_key[key]))
            by_key[key].append(i)
        return _Plan(treedef, [tuple(t.shape) for t in leaves],
                     [t.dtype for t in leaves], r, n, groups,
                     leaves[0].device if leaves
                     else getattr(group, "device", torch.device("cpu")))

    def init(self, params) -> Dict[str, Any]:
        """The ZeRO state for ``params`` (a tree of tensors): this rank's
        flat parameter shards (new tensors), the wrapped optimizer's state
        over them, and the metadata that pins the layout."""
        plan = self._plan = self._build_plan(params)
        leaves = [t.detach().reshape(-1) for t in _tree.flatten(params)[0]]
        shards = {}
        for key, idxs in plan.groups:
            shards[key] = torch.cat([leaves[i][slice(*plan.spans[i])]
                                     for i in idxs]).clone()
        meta = {
            "rank": np.int64(plan.rank),
            "world": np.int64(plan.world),
            "span_lo": np.array(plan.meta["span_lo"], np.int64),
            "span_hi": np.array(plan.meta["span_hi"], np.int64),
            "leaf_size": np.array(plan.sizes, np.int64),
            "leaf_dtype": np.array(plan.meta["leaf_dtype"]),
        }
        state = {"shards": shards, "opt": self.opt.init(shards),
                 "meta": meta}
        if self.error_feedback:
            # the owner residual, one flat host tensor per dtype group in
            # the shard layout (it checkpoints and reshards with the shards)
            state["ef"] = {k: torch.zeros(v.shape, dtype=v.dtype)
                           for k, v in shards.items()}
        return state

    def _check_state(self, state, plan: _Plan) -> None:
        meta = state.get("meta") if isinstance(state, dict) else None
        if meta is None:
            raise ZeroStateError(
                "not a ZeroOptimizer state (no 'meta'): pass the pytree "
                "returned by ZeroOptimizer.init/update")
        for k, v in plan.meta.items():
            got = np.asarray(meta[k]).tolist() if k in meta else None
            if got != v:
                raise ZeroStateError(
                    f"ZeRO state layout mismatch on {k!r}: state has {got}, "
                    f"this run needs {v}.  A ZeRO state is valid only at "
                    f"the (rank, world) and parameter structure it was "
                    f"built for; to carry a checkpointed state to a "
                    f"different world size, restore it through elastic "
                    f"resharding (resilience.TrainState.resume or "
                    f"resilience.reshard.reshard_restore) into a fresh "
                    f"init(params) at the new world.")

    # -- step -----------------------------------------------------------------

    def _ef_views(self, state, plan: _Plan):
        """An ErrorFeedback whose per-leaf arrays are numpy views of
        ``state["ef"]``'s flat group tensors, so the ring's owner residual
        writes through to the checkpointed state.  A missing or mislaid
        residual (EF newly enabled, another layout) restarts from zeros:
        that costs one step of compression error, never correctness."""
        from ..collectives.quant import ErrorFeedback
        from ..utils.logging import log_event
        ef = ErrorFeedback()
        ef_state = state.get("ef")
        if not isinstance(ef_state, dict):
            ef_state = state["ef"] = {}
        for key, idxs in plan.groups:
            want = sum(plan.spans[i][1] - plan.spans[i][0] for i in idxs)
            dt = plan.dtypes[idxs[0]]
            flat = ef_state.get(key)
            if (not isinstance(flat, torch.Tensor) or flat.numel() != want
                    or flat.dtype != dt or flat.device.type != "cpu"):
                log_event("zero-ef-reset", group=key,
                          have=(int(flat.numel()) if isinstance(
                              flat, torch.Tensor) else None), want=want)
                flat = ef_state[key] = torch.zeros(want, dtype=dt)
            view = _lowp.from_torch(flat.reshape(-1))
            pos = 0
            for i in idxs:
                lo, hi = plan.spans[i]
                ef.residuals[i] = view[pos:pos + (hi - lo)]
                pos += hi - lo
        return ef

    def reduce_scatter(self, grads, group=None, state=None) -> BucketWork:
        """Issue the bucketed async reduce-scatter of ``grads``; the
        handle's ``wait_all()`` yields this rank's owned flat gradient
        shards.  Issue it right after the backward and hand it to
        :meth:`update`.  With ``error_feedback=True`` pass the current
        ``state``: its residual rides the owner-compression hook."""
        ef = None
        if self.error_feedback:
            if state is None:
                raise ZeroStateError(
                    "ZeroOptimizer(error_feedback=True).reduce_scatter "
                    "needs the current state: call reduce_scatter(grads, "
                    "state=zstate) so the shard-resident residual rides "
                    "the compression hook")
            if self._plan is None:
                raise ZeroStateError(
                    "ZeroOptimizer.reduce_scatter before init: call "
                    "init(params) in this process first")
            ef = self._ef_views(state, self._plan)
        return self._bucketer.reduce_scatter(grads, op=self.reduce_op,
                                             group=group, error_feedback=ef)

    @torch.no_grad()
    def update(self, grads, state, group=None,
               timeout: Optional[float] = None):
        """One sharded step.  ``grads``: the full gradient tree (reduce-
        scattered here) or :meth:`reduce_scatter`'s handle.  Returns
        ``(handle, new_state)``; ``handle.wait()`` yields the updated full
        parameter tree.  The shards update in place."""
        from ..optim.clip import sharded_clip_grad_norm
        group, n, r = self._resolve(group)
        plan = self._plan
        if plan is None or plan.world != n or plan.rank != r:
            raise ZeroStateError(
                "ZeroOptimizer.update before init (or the process group "
                "changed): call init(params) in this process first")
        self._check_state(state, plan)
        if isinstance(grads, (BucketWork, ZeroParams)):
            frag_tree = grads.wait_all(timeout)
        else:
            frag_tree = self.reduce_scatter(grads, group=group,
                                            state=state).wait_all(timeout)
        frags = _tree.flatten(frag_tree)[0]
        if len(frags) != len(plan.sizes):
            raise ZeroStateError(
                f"gradient tree has {len(frags)} leaves, ZeRO plan was "
                f"built for {len(plan.sizes)}")
        if self.max_grad_norm is not None:
            frags, _ = sharded_clip_grad_norm(list(frags),
                                              self.max_grad_norm,
                                              group=group,
                                              all_reduce=self._scalar_sum(
                                                  group, n))
        gshards = {key: torch.cat([frags[i].reshape(-1) for i in idxs])
                   for key, idxs in plan.groups}
        new_shards, new_opt = self.opt.update(gshards, state["opt"],
                                              state["shards"])
        handle = self._issue_gather(new_shards, plan, group)
        new_state = {"shards": new_shards, "opt": new_opt,
                     "meta": state["meta"]}
        if self.error_feedback:
            new_state["ef"] = state.get("ef") or {
                k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in new_shards.items()}
        return handle, new_state

    def _scalar_sum(self, group, n: int):
        """The clip's scalar all-reduce on the ring's transports (the JAX
        package's: the pinned plane, or the routed eager path); None keeps
        the backend's."""
        if not self._on_ring(group, n):
            return None
        if self._dp is not None:
            dp = self._dp

            def _sum(v):
                from ..collectives.ring import ring_all_reduce
                return ring_all_reduce(dp, v, op="sum", tag="zero_clip")
            return _sum
        from ..collectives.eager import all_reduce_host
        return lambda v: all_reduce_host(v, group=group, op="sum")

    def _issue_gather(self, shards, plan: _Plan, group) -> ZeroParams:
        """One async ``all_gather_into_tensor`` per dtype group over the
        chunk-major layout (this rank's updated shard, padded, is its
        chunk); the handle unpacks the full parameter tree on wait."""
        n, r = plan.world, plan.rank
        if self._on_ring(group, n):
            return self._issue_ring_gather(shards, plan, group)
        works, lays = [], []
        if n > 1:
            drain_pending()
        for key, idxs in plan.groups:
            shard = shards[key]
            lay = self._bucketer.layout([plan.sizes[i] for i in idxs], n,
                                        shard.device)
            lays.append((idxs, lay))
            if n <= 1:
                works.append(completed_work(shard.clone(), "zero_gather"))
                continue
            # a padded copy: the shard itself updates in place next step
            send = shard.new_zeros(lay.width)
            send[:shard.numel()] = shard
            full = shard.new_empty(n * lay.width)
            h = torch.distributed.all_gather_into_tensor(
                full, send, group=group.torch_group, async_op=True)
            works.append(Work(f"zero_gather/{key}", [h],
                              lambda full=full: full,
                              group=group.torch_group))

        def assemble(results):
            out: List = [None] * len(plan.sizes)
            for (idxs, lay), buf in zip(lays, results):
                flats = (list(buf.split([plan.sizes[i] for i in idxs]))
                         if n <= 1 else lay.unpack(buf))
                for i, f in zip(idxs, flats):
                    out[i] = f.view(plan.shapes[i])
            return _tree.unflatten(plan.treedef, out)

        return ZeroParams(works, assemble, f"zero_params x{len(works)}")

    def _issue_ring_gather(self, shards, plan: _Plan, group) -> ZeroParams:
        """One async :func:`ring_chunk_all_gather` per dtype group on the
        ordered engine, over the JAX package's unpadded chunk-major buffer
        (chunk *c* = every member leaf's chunk *c*); this rank's updated
        shard is copied into its chunk at issue."""
        from ..collectives import eager as _eager
        n, r = plan.world, plan.rank
        engine = engine_for(self._dp)
        works, plans = [], []
        for gi, (key, idxs) in enumerate(plan.groups):
            shard = shards[key]
            leaf_bounds = [chunk_bounds(plan.sizes[i], n) for i in idxs]
            bucket_bounds, pos = [], 0
            for c in range(n):
                lo = pos
                pos += sum(b[c][1] - b[c][0] for b in leaf_bounds)
                bucket_bounds.append((lo, pos))
            host = _lowp.from_torch(shard.reshape(-1))
            buf = np.empty(pos, dtype=host.dtype)
            lo, hi = bucket_bounds[r]
            buf[lo:hi] = host
            if self._dp is not None:
                tag = f"zag/i{self._seq}/{gi}"
            else:
                tag = None   # drawn in engine order, in the body
            works.append(engine.submit(
                self._gather_body(buf, bucket_bounds, group, tag),
                label=f"zero_gather/g{gi}"))
            plans.append((idxs, leaf_bounds, shard.device))
        self._seq += 1

        def assemble(results):
            out: List = [None] * len(plan.sizes)
            for (idxs, leaf_bounds, dev), buf in zip(plans, results):
                flats = [np.empty(plan.sizes[i], dtype=buf.dtype)
                         for i in idxs]
                pos = 0
                for c in range(n):
                    for f, b in zip(flats, leaf_bounds):
                        flo, fhi = b[c]
                        if fhi > flo:
                            f[flo:fhi] = buf[pos:pos + (fhi - flo)]
                            pos += fhi - flo
                for i, f in zip(idxs, flats):
                    out[i] = _lowp.to_torch(f, dev).view(plan.shapes[i])
            return _tree.unflatten(plan.treedef, out)

        return ZeroParams(works, assemble, f"zero_params x{len(works)}")

    def _gather_body(self, buf, bucket_bounds, group, tag):
        def body():
            from ..collectives import eager as _eager
            from ..collectives import ring as _ring
            import time as _time
            if self._dp is not None:
                dp, t = self._dp, tag
            else:
                store = _eager._coll_store()
                seq = _eager._next_seq("zero_ag", 0)
                t = f"{_eager._ns()}/coll/zag/{seq}"
                _eager._sanitize("zero_param_gather", group, store,
                                 value=buf)
                dp = _eager._maybe_data_plane(group, store)
            # on the engine: the span carries queue_ns, the time the gather
            # sat behind earlier collectives
            with _eager._obs_span("zero_param_gather", value=buf):
                t0 = _time.perf_counter()
                stats: dict = {}
                out = _ring.ring_chunk_all_gather(
                    dp, buf, bucket_bounds, tag=t,
                    comm_dtype=self.gather_comm_dtype, stats=stats)
                _eager._record(
                    "zero_param_gather", "dataplane", buf.nbytes, t0,
                    wire_bytes=stats.get("wire_bytes"),
                    raw_wire_bytes=stats.get("raw_wire_bytes"))
            return out

        return body
