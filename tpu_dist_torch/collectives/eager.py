"""Eager host-level collectives on a ProcessGroup — counterpart of
``tpu_dist/collectives/eager.py``.

torch call-style parity (``dist.all_reduce``, ``dist.reduce``,
``dist.gather``/``scatter``, ``dist.send``/``recv``, the ``*_object``
collectives) for out-of-step syncs: metric averaging, parameter broadcast,
control decisions.  Each function takes this process's value (a numpy array,
a Python scalar or a tensor, or a dict/list/tuple tree of them) and returns
numpy, as the JAX functions do; a group of one process returns at once.

**Which transport** (``TPU_DIST_HOST_TRANSPORT``, uniform across ranks;
:func:`_prefer_backend` stands where the JAX package's ``_prefer_mesh``
stands, the group's backend where XLA's mesh does):

- **the group's backend** — ``auto`` on an NCCL group (the card), and
  ``mesh``: the payload is pickled, moved as a uint8 tensor through
  ``torch.distributed`` on the group's device and reduced on the host in
  rank order with the JAX package's numpy ufuncs, so a reduction gives the
  JAX store path's result bit for bit;
- **the JAX routing** — ``auto`` on a gloo group (the CPU), and
  ``dataplane``/``store`` anywhere (CUDA leaves are staged through host
  memory): leaves below ``TPU_DIST_DP_THRESHOLD`` (64 KiB) batch into one
  round of pickled keys on the control-plane store, under the JAX keys and
  generation namespace; larger array leaves ride the host data plane
  (:mod:`.transport`) as ring all-reduces and all-gathers and tree
  broadcasts (:mod:`.ring`), ``TPU_DIST_ALGO`` choosing the flat or the
  hierarchical ring (:mod:`.topology`), ``TPU_DIST_COMM_DTYPE`` /
  ``TPU_DIST_COMM_DTYPE_GATHER`` compressing the wire; ``send``/``recv``
  of a large array go as one frame.  A data-plane setup failure raises
  rather than degrading one rank alone, and ``TPU_DIST_NO_DATAPLANE=1``
  keeps every leaf on the store.  This is the JAX package's code path, so
  the results agree with it bit for bit on both sides of the threshold,
  and a JAX rank can share the ring.

A group without the control-plane store (a ``tcp://`` rendezvous without
the store pre-flight) keeps the backend — where the JAX package refuses
(``eager.py`` ``_p2p_store``) or falls back to its mesh; a sub-group made
by ``dist.new_group`` also keeps its backend (the data plane's own groups
are :func:`.topology.new_group`).  Every collective opens a flight-recorder
span (:mod:`tpu_dist_torch.obs`; the backend route notes the path
``"mesh"``, the JAX package's word) and, under ``TPU_DIST_SANITIZE=1``, has
its signature checked across ranks before any payload moves
(:mod:`tpu_dist_torch.analysis.sanitizer`).  Objects are pickled: send
only what this job made.

``async_op=True`` (``all_reduce_host``, ``all_gather_host``,
``broadcast_host``, ``send``, ``recv``) returns a
:class:`~tpu_dist_torch.collectives.work.Work` run on the ordered executor,
its input copied at issue; every synchronous call first drains that queue.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs import recorder as _obs_rec
from ..obs.recorder import reset_transport_counters, transport_counters
from . import _lowp, _tree
from .work import completed_work, drain_pending, engine

__all__ = ["ReduceOp", "all_reduce_host", "all_gather_host",
           "broadcast_host", "reduce_host", "gather_host", "scatter_host",
           "send", "recv", "send_recv_device", "all_gather_object",
           "gather_object", "broadcast_object_list", "scatter_object_list",
           "all_to_all_host", "transport_counters",
           "reset_transport_counters"]


class ReduceOp:
    """torch.distributed.ReduceOp parity (string-valued; the ``*_host``
    collectives take these constants or the lowercase strings)."""
    SUM = "sum"
    AVG = "avg"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"


_REDUCE_UFUNCS = {
    "sum": np.add, "prod": np.multiply, "product": np.multiply,
    "min": np.minimum, "max": np.maximum, "band": np.bitwise_and,
    "bor": np.bitwise_or, "bxor": np.bitwise_xor,
}


def _reduce_fn(op: str):
    op = op.lower()
    if op in ("avg", "mean"):
        return lambda v: np.mean(v, axis=0)
    if op in _REDUCE_UFUNCS:
        ufunc = _REDUCE_UFUNCS[op]
        return lambda v: ufunc.reduce(v, axis=0)
    raise ValueError(f"Unknown reduce op {op!r}; one of "
                     f"{sorted(_REDUCE_UFUNCS) + ['avg']}")


def _default_group(group):
    if group is None:
        from .. import dist
        group = dist.get_default_group()
    elif getattr(group, "rank", 0) is None:
        # a data-plane SubGroup held by a non-member: fail before any
        # payload moves (a non-member would desynchronize the members)
        group.require_member()
    return group


def _check_peer(rank: int, group, what: str) -> None:
    if not 0 <= rank < group.num_processes:
        raise ValueError(f"{what} {rank} out of range "
                         f"(num_processes={group.num_processes})")


def _host(v) -> np.ndarray:
    """A leaf as numpy (a tensor is copied to the host; bfloat16 and
    float8 as :mod:`._lowp` arrays)."""
    if isinstance(v, torch.Tensor):
        return _lowp.from_torch(v)
    return np.asarray(v)


def _snapshot(x):
    """Issue-time copy of an async collective's input tree, so the caller
    may change its arrays the moment the Work returns."""
    return _tree.tree_map(lambda v: np.array(_host(v)), x)


# -- which transport ----------------------------------------------------------

def _host_transport() -> str:
    return os.environ.get("TPU_DIST_HOST_TRANSPORT",
                          "auto").strip().lower()


def _prefer_backend(group) -> bool:
    """True when host collectives stay on the group's own backend although
    a store is up (the JAX ``_prefer_mesh``): ``mesh`` forces it,
    ``dataplane``/``store`` force the JAX routing, and ``auto`` keeps an
    NCCL group on NCCL (as the JAX package keeps a TPU job on its mesh) and
    routes a gloo group (the CPU) as the JAX package routes its CPU
    backend."""
    mode = _host_transport()
    if mode == "mesh":
        return True
    if mode in ("dataplane", "store"):
        return False
    return getattr(group, "backend", None) == "nccl"


def _group_id(group) -> Optional[str]:
    """A data-plane SubGroup's id, None for the flat world."""
    return getattr(group, "group_id", None)


def _group_scope(group) -> str:
    gid = _group_id(group)
    return f"/grp{gid}" if gid else ""


def _use_backend(group, store) -> bool:
    """Whether this collective rides the group's backend.  A data-plane
    SubGroup never does (and needs the store); a group without the store,
    or a backend sub-group of ``dist.new_group``, always does."""
    if _group_id(group) is not None:
        if store is None:
            raise RuntimeError(
                "sub-group collectives need the control-plane store "
                "(launch with tpu_dist_torch.launch or set "
                f"TPU_DIST_STORE_ADDR): {group.describe()}")
        return False
    if store is None or getattr(group, "_parent", None) is not None:
        return True
    return _prefer_backend(group)


def _coll_store():
    from ..dist import get_store
    return get_store()


def _ns() -> str:
    """Store-key namespace of this gang incarnation (the JAX keys)."""
    from ..dist import generation
    return f"tpu_dist/g{generation()}"


# -- the backend --------------------------------------------------------------

def _stage(group) -> torch.device:
    """Where payloads are staged for the group's backend."""
    return group.device if group.backend == "nccl" else torch.device("cpu")


def _all_gather_bytes(raw: bytes, group) -> List[bytes]:
    """Every rank's ``raw`` in rank order: the lengths, then the payloads
    padded to the longest, each one all-gather through the backend."""
    dev, tg, n = _stage(group), group.torch_group, group.num_processes
    lens = torch.empty(n, dtype=torch.int64, device=dev)
    torch.distributed.all_gather_into_tensor(
        lens, torch.tensor([len(raw)], dtype=torch.int64, device=dev),
        group=tg)
    lens = [int(v) for v in lens.cpu()]
    width = max(max(lens), 1)
    buf = np.zeros(width, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    out = torch.empty(n * width, dtype=torch.uint8, device=dev)
    torch.distributed.all_gather_into_tensor(
        out, torch.from_numpy(buf).to(dev), group=tg)
    host = out.cpu().numpy()
    return [host[r * width:r * width + lens[r]].tobytes() for r in range(n)]


def _broadcast_bytes(raw: Optional[bytes], src: int, group) -> bytes:
    """Rank ``src``'s ``raw`` on every rank: its length, then the bytes."""
    dev, tg = _stage(group), group.torch_group
    root = group.ranks[src]
    size = torch.tensor([len(raw) if group.rank == src else 0],
                        dtype=torch.int64, device=dev)
    torch.distributed.broadcast(size, src=root, group=tg)
    n = int(size.item())
    if group.rank == src:
        buf = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
    else:
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        torch.distributed.broadcast(buf, src=root, group=tg)
    return raw if group.rank == src else buf.cpu().numpy().tobytes()


def _dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def _leaves_of_all(x, group):
    """``(rows, treedef)``: every rank's host leaves of ``x``, by rank."""
    leaves, treedef = _tree.flatten(x)
    raws = _all_gather_bytes(_dumps([_host(v) for v in leaves]), group)
    return [pickle.loads(r) for r in raws], treedef


def _submit(body, label: str, group, fast_path):
    if group.num_processes <= 1:
        return completed_work(fast_path(), label)
    return engine().submit(body, label=label)


# -- the collectives ----------------------------------------------------------

def all_reduce_host(x, group=None, op: str = ReduceOp.SUM,
                    async_op: bool = False):
    """Reduce a per-process value across the group; returns the reduced
    value (numpy tree) on every process.  On the JAX routing, leaves of at
    least ``TPU_DIST_DP_THRESHOLD`` bytes with a ring op (sum/avg/max/min)
    ride the ring, the rest one store round."""
    group = _default_group(group)
    fn = _reduce_fn(op)
    if async_op:
        x = _snapshot(x)
        return _submit(lambda: _all_reduce_body(x, group, op, fn),
                       f"all_reduce[{str(op).lower()}]", group, lambda: x)
    if group.num_processes <= 1:
        return _tree.tree_map(_host, x)
    drain_pending()
    return _all_reduce_body(x, group, op, fn)


def _all_reduce_body(x, group, op, fn):
    with _obs_span("all_reduce", value=x, reduce_op=op,
                   group=_group_id(group)):
        store = _coll_store()
        _sanitize("all_reduce", group, store, value=x, reduce_op=op)
        if not _use_backend(group, store):
            return _routed_all_reduce(x, group, store, op, fn)
        _obs_mesh()
        rows, treedef = _leaves_of_all(x, group)
        return _tree.unflatten(treedef, [
            fn(np.stack([row[i] for row in rows]))
            for i in range(len(rows[0]))])


def _routed_all_reduce(x, group, store, op, fn):
    from . import ring as _ring
    from . import topology as _topo
    n = group.num_processes
    leaves, treedef = _tree.flatten(x)
    arrs = [_host(v) for v in leaves]
    opl = str(op).lower()
    scope = _group_scope(group)
    seq = _next_seq(f"allreduce{scope}", 0)
    base = f"{_ns()}{scope}/coll/ar/{seq}"
    ring_idx, small, dp = _partition_and_dp(arrs, group, store, opl)
    out: List = [None] * len(arrs)
    if small:
        t0 = time.perf_counter()
        rows = _store_all_gather_payload([arrs[i] for i in small], group,
                                         store, base + "/sm")
        for pos, i in enumerate(small):
            out[i] = fn(np.stack([np.asarray(rows[r][pos])
                                  for r in range(n)]))
        _record("all_reduce", "store",
                         sum(arrs[i].nbytes for i in small), t0)
        _topo.record_algo("all_reduce", "store")
    comm = _comm_dtype()
    in_group = _group_id(group) is not None
    for j, i in enumerate(ring_idx):
        t0 = time.perf_counter()
        stats: dict = {}
        # per leaf: flat or two-level ring, and the compute-bound float32
        # fallback (size, store-agreed topology and env only, so every rank
        # picks the same); inside a SubGroup the ring has its own order
        if in_group:
            algo, comm_ok = "flat", True
        else:
            algo, comm_ok = _topo.select_algo(arrs[i].nbytes, dp=dp)
        leaf_comm = comm if comm_ok else None
        _topo.record_algo("all_reduce", algo)
        reduce = (_topo.hier_all_reduce if algo == "hier"
                  else _ring.ring_all_reduce)
        out[i] = reduce(dp, arrs[i], op=opl, tag=f"{base}/{j}",
                        comm_dtype=leaf_comm, stats=stats)
        _record("all_reduce", "dataplane", arrs[i].nbytes, t0,
                         wire_bytes=stats.get("wire_bytes"),
                         raw_wire_bytes=stats.get("raw_wire_bytes"))
    return _tree.unflatten(treedef, out)


def all_gather_host(x, group=None, async_op: bool = False):
    """Gather per-process values; returns the tree with a leading process
    axis."""
    group = _default_group(group)
    if async_op:
        x = _snapshot(x)
        return _submit(lambda: _all_gather_body(x, group), "all_gather",
                       group, lambda: _tree.tree_map(lambda v: v[None], x))
    if group.num_processes <= 1:
        return _tree.tree_map(lambda v: _host(v)[None], x)
    drain_pending()
    return _all_gather_body(x, group)


def _all_gather_body(x, group):
    with _obs_span("all_gather", value=x, group=_group_id(group)):
        store = _coll_store()
        _sanitize("all_gather", group, store, value=x)
        if not _use_backend(group, store):
            return _routed_all_gather(x, group, store)
        _obs_mesh()
        rows, treedef = _leaves_of_all(x, group)
        return _tree.unflatten(treedef, [
            np.stack([row[i] for row in rows]) for i in range(len(rows[0]))])


def _routed_all_gather(x, group, store):
    from . import ring as _ring
    n = group.num_processes
    leaves, treedef = _tree.flatten(x)
    arrs = [_host(v) for v in leaves]
    scope = _group_scope(group)
    seq = _next_seq(f"allgather{scope}", 0)
    base = f"{_ns()}{scope}/coll/ag/{seq}"
    ring_idx, small, dp = _partition_and_dp(arrs, group, store)
    out: List = [None] * len(arrs)
    if small:
        t0 = time.perf_counter()
        rows = _store_all_gather_payload([arrs[i] for i in small], group,
                                         store, base + "/sm")
        for pos, i in enumerate(small):
            out[i] = np.stack([np.asarray(rows[r][pos]) for r in range(n)])
        _record("all_gather", "store",
                         sum(arrs[i].nbytes for i in small), t0)
    comm = _gather_comm_dtype()  # its own knob: gathers are often exact
    for j, i in enumerate(ring_idx):
        t0 = time.perf_counter()
        stats: dict = {}
        out[i] = _ring.ring_all_gather(dp, arrs[i], tag=f"{base}/{j}",
                                       comm_dtype=comm, stats=stats)
        _record("all_gather", "dataplane", arrs[i].nbytes, t0,
                         wire_bytes=stats.get("wire_bytes"),
                         raw_wire_bytes=stats.get("raw_wire_bytes"))
    return _tree.unflatten(treedef, out)


def broadcast_host(x, group=None, src: int = 0, async_op: bool = False):
    """Process ``src``'s value on every process (DDP's wrap-time rank-0
    parameter broadcast).  Every rank passes a value of the broadcast
    structure; non-src leaves are templates."""
    group = _default_group(group)
    if async_op:
        if group.num_processes > 1:
            _check_peer(src, group, "src")
        x = _snapshot(x)
        return _submit(lambda: _broadcast_body(x, group, src), "broadcast",
                       group, lambda: x)
    if group.num_processes <= 1:
        return _tree.tree_map(_host, x)
    drain_pending()
    return _broadcast_body(x, group, src)


def _broadcast_body(x, group, src):
    with _obs_span("broadcast", value=x, src=src, group=_group_id(group)):
        store = _coll_store()
        _sanitize("broadcast", group, store, value=x, src=src)
        _check_peer(src, group, "src")
        if not _use_backend(group, store):
            return _routed_broadcast(x, group, store, src)
        _obs_mesh()
        leaves, treedef = _tree.flatten(x)
        raw = (_dumps([np.array(_host(v)) for v in leaves])
               if group.rank == src else None)
        vals = pickle.loads(_broadcast_bytes(raw, src, group))
        return _tree.unflatten(treedef, [np.asarray(v) for v in vals])


def _routed_broadcast(x, group, store, src):
    from . import ring as _ring
    n, me = group.num_processes, group.rank
    leaves, treedef = _tree.flatten(x)
    arrs = [_host(v) for v in leaves]
    scope = _group_scope(group)
    seq = _next_seq(f"bcast{scope}", src)
    base = f"{_ns()}{scope}/coll/bc/{seq}"
    tree_idx, small, dp = _partition_and_dp(arrs, group, store)
    out: List = [None] * len(arrs)
    if small:
        t0 = time.perf_counter()
        key = f"{base}/sm"
        if me == src:
            store.set(key, _seal(_dumps([arrs[i] for i in small])))
            # copies: the source must not hand back aliases of its input
            vals = [np.array(arrs[i]) for i in small]
        else:
            _wait_peer_keys(store, [key])  # bounded: src may have died
            vals = pickle.loads(_unseal(store.get(key), "store-broadcast"))
        if me != src and store.add(f"{key}/ack", 1) >= n - 1:
            store.delete_key(key)
            store.delete_key(f"{key}/ack")
        for pos, i in enumerate(small):
            out[i] = np.asarray(vals[pos])
        _record("broadcast", "store",
                         sum(arrs[i].nbytes for i in small), t0)
    for j, i in enumerate(tree_idx):
        t0 = time.perf_counter()
        out[i] = _ring.tree_broadcast(dp, arrs[i], src=src,
                                      tag=f"{base}/{j}")
        _record("broadcast", "dataplane", arrs[i].nbytes, t0)
    return _tree.unflatten(treedef, out)


def reduce_host(x, dst: int = 0, group=None, op: str = ReduceOp.SUM):
    """torch ``dist.reduce`` parity: the reduced value on process ``dst``,
    ``None`` elsewhere."""
    group = _default_group(group)
    fn = _reduce_fn(op)
    _check_peer(dst, group, "dst")
    if group.num_processes <= 1:
        return _tree.tree_map(_host, x)
    drain_pending()
    with _obs_span("reduce", value=x, reduce_op=op, dst=dst,
                   group=_group_id(group)):
        store = _coll_store()
        _sanitize("reduce", group, store, value=x, reduce_op=op, dst=dst)
        if _use_backend(group, store):
            _obs_mesh()
        gathered = gather_host(x, dst=dst, group=group)
        if gathered is None:
            return None
        leaves = [_tree.flatten(g)[0] for g in gathered]
        treedef = _tree.flatten(gathered[0])[1]
        return _tree.unflatten(treedef, [
            fn(np.stack([row[i] for row in leaves]))
            for i in range(len(leaves[0]))])


def gather_host(x, dst: int = 0, group=None) -> Optional[List]:
    """torch ``dist.gather`` parity: process ``dst`` returns the list of
    every process's value (index = rank; shapes may differ by rank); every
    other process returns ``None``.  On the JAX routing each rank posts
    one store key and ``dst`` collects them."""
    group = _default_group(group)
    _check_peer(dst, group, "dst")
    n = group.num_processes
    if n <= 1:
        return [_tree.tree_map(_host, x)]
    drain_pending()
    with _obs_span("gather", value=x, dst=dst, group=_group_id(group)):
        store = _coll_store()
        # no leaf signature: a gather moves per-rank shapes
        _sanitize("gather", group, store, dst=dst)
        if not _use_backend(group, store):
            return _routed_gather(x, dst, group, store, n)
        _obs_mesh()
        rows = _all_gather_bytes(_dumps(_tree.tree_map(_host, x)), group)
        if group.rank != dst:
            return None
        return [pickle.loads(r) for r in rows]


def _routed_gather(x, dst, group, store, n):
    seq = _next_seq(f"gather{_group_scope(group)}", dst)
    t0 = time.perf_counter()
    if group.rank != dst:
        store.set(_coll_key("gather", dst, seq, group.rank, group),
                  _tree_to_bytes(x))
        return None
    keys = [_coll_key("gather", dst, seq, r, group) for r in range(n)
            if r != dst]
    _wait_peer_keys(store, keys)
    out, nbytes = [], 0
    for r in range(n):
        if r == dst:
            out.append(_tree.tree_map(_host, x))
            continue
        key = _coll_key("gather", dst, seq, r, group)
        raw = store.get(key)
        nbytes += len(raw)
        out.append(_tree_from_bytes(raw))
        store.delete_key(key)
    _record("gather", "store", nbytes, t0)
    return out


def scatter_host(output_template, scatter_list: Optional[List] = None,
                 src: int = 0, group=None):
    """torch ``dist.scatter`` parity: process ``src`` supplies one entry per
    process, each of ``output_template``'s shapes; every process returns
    its entry.  Other processes pass ``scatter_list=None``."""
    group = _default_group(group)
    n = group.num_processes
    _check_peer(src, group, "src")
    payload = None
    if group.rank == src:
        if scatter_list is None or len(scatter_list) != n:
            raise ValueError(
                f"scatter src must pass scatter_list with num_processes="
                f"{n} entries, got "
                f"{None if scatter_list is None else len(scatter_list)}")
        payload = [_tree.tree_map(_host, e) for e in scatter_list]
        tshape = _tree.tree_map(lambda v: _host(v).shape, output_template)
        for i, e in enumerate(payload):
            eshape = _tree.tree_map(lambda v: v.shape, e)
            if eshape != tshape:
                raise ValueError(
                    f"scatter_list[{i}] shape {eshape} != output_template "
                    f"shape {tshape}: entries must be uniform (NCCL scatter "
                    f"semantics)")
        if n <= 1:
            return payload[0]
    drain_pending()
    with _obs_span("scatter", value=output_template, src=src,
                   group=_group_id(group)):
        store = _coll_store()
        _sanitize("scatter", group, store, value=output_template, src=src)
        if not _use_backend(group, store):
            return _routed_scatter(payload, src, group, store, n)
        _obs_mesh()
        full = pickle.loads(_broadcast_bytes(
            _dumps(payload) if group.rank == src else None, src, group))
        return full[group.rank]


def _routed_scatter(payload, src, group, store, n):
    # src posts one store key a destination; each rank fetches its own
    seq = _next_seq(f"scatter{_group_scope(group)}", src)
    t0 = time.perf_counter()
    if group.rank == src:
        nbytes = 0
        for dst in range(n):
            if dst != src:
                raw = _tree_to_bytes(payload[dst])
                nbytes += len(raw)
                store.set(_coll_key("scatter", src, seq, dst, group), raw)
        _record("scatter", "store", nbytes, t0)
        return payload[src]
    key = _coll_key("scatter", src, seq, group.rank, group)
    raw = store.get(key)       # blocks until src posts it
    store.delete_key(key)
    _record("scatter", "store", len(raw), t0)
    return _tree_from_bytes(raw)


# -- object collectives -------------------------------------------------------

def _obj_to_u8(obj: Any) -> np.ndarray:
    return np.frombuffer(pickle.dumps(obj), np.uint8)


def _all_gather_u8(obj: Any, group) -> tuple:
    """The JAX routing's object gather: pickle, pad, all-gather; returns
    ``(rows, lens)``."""
    payload = _obj_to_u8(obj)
    lens = all_gather_host(np.int64(payload.size), group)
    padded = np.zeros(int(lens.max()), np.uint8)
    padded[:payload.size] = payload
    return all_gather_host(padded, group), lens


def _object_rows(obj: Any, group) -> List[bytes]:
    """Every rank's pickled ``obj``, by rank, on either transport."""
    if not _use_backend(group, _coll_store()):
        rows, lens = _all_gather_u8(obj, group)
        return [rows[r, :int(lens[r])].tobytes()
                for r in range(group.num_processes)]
    drain_pending()
    return _all_gather_bytes(_dumps(obj), group)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """torch ``dist.all_gather_object`` parity: every process returns the
    list of all processes' objects (index = rank)."""
    group = _default_group(group)
    if group.num_processes <= 1:
        return [obj]
    return [pickle.loads(r) for r in _object_rows(obj, group)]


def gather_object(obj: Any, dst: int = 0, group=None) -> Optional[List[Any]]:
    """torch ``dist.gather_object`` parity: process ``dst`` returns the
    rank-indexed object list, every other process ``None``."""
    group = _default_group(group)
    _check_peer(dst, group, "dst")
    if group.num_processes <= 1:
        return [obj] if group.rank == dst else None
    rows = _object_rows(obj, group)
    if group.rank != dst:
        return None
    return [pickle.loads(r) for r in rows]


def broadcast_object_list(object_list: List[Any], src: int = 0,
                          group=None) -> List[Any]:
    """torch ``dist.broadcast_object_list`` in the JAX package's functional
    form: returns process ``src``'s list on every process (same length)."""
    group = _default_group(group)
    _check_peer(src, group, "src")
    if group.num_processes <= 1:
        return list(object_list)
    is_src = group.rank == src
    if not _use_backend(group, _coll_store()):
        payload = (_obj_to_u8(list(object_list)) if is_src
                   else np.zeros(0, np.uint8))
        size = int(broadcast_host(np.int64(payload.size), group, src=src))
        buf = np.zeros(size, np.uint8)
        buf[:payload.size] = payload
        out = broadcast_host(buf, group, src=src)
        return pickle.loads(np.asarray(out).tobytes())
    drain_pending()
    raw = _dumps(list(object_list)) if is_src else None
    return pickle.loads(_broadcast_bytes(raw, src, group))


def scatter_object_list(scatter_object_input_list: Optional[List[Any]] = None,
                        src: int = 0, group=None) -> Any:
    """torch ``dist.scatter_object_list`` in functional form: process
    ``src`` supplies one object per process; every process returns its
    own."""
    group = _default_group(group)
    n = group.num_processes
    _check_peer(src, group, "src")
    if group.rank == src:
        if (scatter_object_input_list is None
                or len(scatter_object_input_list) != n):
            got = (None if scatter_object_input_list is None
                   else len(scatter_object_input_list))
            raise ValueError(
                f"scatter src must pass scatter_object_input_list with "
                f"num_processes={n} entries, got {got}")
        if n <= 1:
            return scatter_object_input_list[0]
    store = _coll_store()
    if not _use_backend(group, store):
        # one store key a destination (see gather_host)
        drain_pending()
        seq = _next_seq(f"scatter_obj{_group_scope(group)}", src)
        if group.rank == src:
            for dst in range(n):
                if dst != src:
                    store.set(_coll_key("scatter_obj", src, seq, dst, group),
                              pickle.dumps(scatter_object_input_list[dst]))
            return scatter_object_input_list[src]
        key = _coll_key("scatter_obj", src, seq, group.rank, group)
        obj = pickle.loads(store.get(key))
        store.delete_key(key)
        return obj
    full = broadcast_object_list(
        scatter_object_input_list if group.rank == src else [None] * n,
        src=src, group=group)
    return full[group.rank]


def all_to_all_host(input_list: List[Any], group=None) -> List[Any]:
    """torch ``dist.all_to_all`` parity: process p sends ``input_list[q]``
    to process q; returns entry r = what rank r addressed to this process.
    Entries may be arrays of any per-pair shape or any objects."""
    group = _default_group(group)
    n = group.num_processes
    if len(input_list) != n:
        raise ValueError(f"all_to_all needs one entry per process "
                         f"(num_processes={n}), got {len(input_list)}")
    if n <= 1:
        return list(input_list)
    drain_pending()
    with _obs_span("all_to_all", value=input_list, group=_group_id(group)):
        store = _coll_store()
        _sanitize("all_to_all", group, store)
        if not _use_backend(group, store):
            return _routed_all_to_all(input_list, group, store, n)
        rows = all_gather_object(list(input_list), group)
        return [rows[r][group.rank] for r in range(n)]


def _routed_all_to_all(input_list, group, store, n):
    # pairwise store keys: rank p moves only its row and its column
    me = group.rank
    seq = _next_seq(f"a2a{_group_scope(group)}", 0)
    t0 = time.perf_counter()
    nbytes = 0
    for q in range(n):
        if q != me:
            store.set(_coll_key("a2a", q, seq, me, group),
                      pickle.dumps(input_list[q]))
    out = []
    for r in range(n):
        if r == me:
            out.append(input_list[me])
            continue
        key = _coll_key("a2a", me, seq, r, group)
        raw = store.get(key)
        nbytes += len(raw)
        out.append(pickle.loads(raw))
        store.delete_key(key)
    _record("all_to_all", "store", nbytes, t0)
    return out


# -- the JAX routing: store keys, sealing, the data plane ---------------------

_coll_seq: dict = {}    # (op, root) -> next sequence number


def _next_seq(op: str, root: int) -> int:
    seq = _coll_seq.get((op, root), 0)
    _coll_seq[(op, root)] = seq + 1
    return seq


def _coll_key(op: str, root: int, seq: int, peer: int, group=None) -> str:
    return f"{_ns()}{_group_scope(group)}/coll/{op}/{root}/{seq}/{peer}"


# sealed store payloads: the frame checksum over a pickled payload, so a
# flipped bit fails as a named FrameCorruptError at the consumer; the magic
# cannot collide with pickle (protocol 2+ starts with 0x80)
_SEAL_MAGIC = b"TPCK"


def _seal(raw: bytes) -> bytes:
    from .transport import frame_checksum, frame_crc_enabled
    if not frame_crc_enabled():
        return raw
    return _SEAL_MAGIC + struct.pack("<I", frame_checksum((raw,))) + raw


def _unseal(raw: bytes, what: str) -> bytes:
    if raw[:4] != _SEAL_MAGIC:
        return raw  # posted by a checksum-disabled peer: deliver as-is
    from .transport import FrameCorruptError, frame_checksum
    (expected,) = struct.unpack("<I", raw[4:8])
    body = raw[8:]
    got = frame_checksum((body,))
    if got != expected:
        raise FrameCorruptError(None, what, len(body), expected, got, 0)
    return body


def _tree_to_bytes(tree) -> bytes:
    return _seal(_dumps(_tree.tree_map(_host, tree)))


def _tree_from_bytes(raw: bytes):
    return pickle.loads(_unseal(raw, "store-tree"))


def _wait_peer_keys(store, keys) -> None:
    """Bounded wait for peer-posted store keys: ``TPU_DIST_COLL_TIMEOUT``
    (a named CollectiveTimeoutError) when armed, else the per-frame
    ``TPU_DIST_DP_TIMEOUT``."""
    from .transport import (CollectiveTimeoutError, _default_timeout,
                            coll_timeout)
    ct = coll_timeout()
    if ct > 0:
        try:
            store.wait(keys, timeout=ct)
        except TimeoutError as e:
            raise CollectiveTimeoutError(
                f"store collective wedged: peer key never posted within "
                f"TPU_DIST_COLL_TIMEOUT={ct:.0f}s — a peer is dead or "
                f"partitioned: {e}") from e
        return
    timeout = _default_timeout()
    try:
        store.wait(keys, timeout=timeout if timeout > 0 else None)
    except TimeoutError as e:
        raise TimeoutError(
            f"store collective: peer key never posted within "
            f"{timeout:.0f}s (TPU_DIST_DP_TIMEOUT) — a peer likely died "
            f"mid-collective: {e}") from e


def _store_all_gather_payload(payload, group, store, base: str) -> dict:
    """All-gather a pickled payload through the store: post one key, wait
    for the peers' keys, fetch.  The last reader of a key deletes it."""
    n, me = group.num_processes, group.rank
    store.set(f"{base}/{me}", _seal(_dumps(payload)))
    peers = [r for r in range(n) if r != me]
    _wait_peer_keys(store, [f"{base}/{r}" for r in peers])
    rows = {me: payload}
    for r in peers:
        rows[r] = pickle.loads(_unseal(store.get(f"{base}/{r}"),
                                       "store-allgather"))
        if store.add(f"{base}/{r}/ack", 1) >= n - 1:
            store.delete_key(f"{base}/{r}")
            store.delete_key(f"{base}/{r}/ack")
    return rows


def _dp_threshold() -> int:
    try:
        return int(os.environ.get("TPU_DIST_DP_THRESHOLD", str(64 * 1024)))
    except ValueError:
        return 64 * 1024


def _comm_dtype():
    """``TPU_DIST_COMM_DTYPE``: a dtype name (cast wire) or a quant scheme
    (``int8_block256``), resolved as the JAX package resolves it."""
    name = os.environ.get("TPU_DIST_COMM_DTYPE", "").strip()
    if not name:
        return None
    from . import quant as _quant
    return _quant.resolve_wire(name)


def _gather_comm_dtype():
    """``TPU_DIST_COMM_DTYPE_GATHER``: the all-gather's own, explicit wire
    compression (gathered values are often exact-value exchanges)."""
    name = os.environ.get("TPU_DIST_COMM_DTYPE_GATHER", "").strip()
    if not name:
        return None
    from . import quant as _quant
    return _quant.resolve_wire(name)


def _host_transport_is_store_only() -> bool:
    return _host_transport() == "store"


def _dp_enabled() -> bool:
    if os.environ.get("TPU_DIST_NO_DATAPLANE"):
        return False
    return not _host_transport_is_store_only()


def _maybe_data_plane(group, store):
    """The process's data plane (a group view for a SubGroup), or None when
    disabled.  A rank whose setup fails raises: degrading alone would leave
    its peers waiting on the ring."""
    if _host_transport_is_store_only():
        return None
    from . import transport
    sub = _group_id(group) is not None
    rank = group.parent_rank if sub else group.rank
    world = group.parent_world if sub else group.num_processes
    try:
        dp = transport.get_data_plane(store, rank, world)
    except Exception as e:
        raise RuntimeError(
            f"rank {rank}: p2p data-plane setup failed ({e!r}); "
            f"failing fast rather than degrading one-sidedly (peers would "
            f"deadlock routing this rank's payloads to the ring).  Set "
            f"TPU_DIST_NO_DATAPLANE=1 on ALL ranks to run store-only."
        ) from e
    if dp is not None and sub:
        return group.view(dp)
    return dp


def _dp_leaf_ok(a: np.ndarray, reduce_op: Optional[str] = None) -> bool:
    """The per-leaf routing decision: True iff this array leaf rides the
    data plane (dtype, size and launcher-uniform env only, so every rank
    answers the same)."""
    if not _dp_enabled() or a.nbytes < _dp_threshold():
        return False
    from . import topology as _topo
    if _topo.algo_mode() == "store":
        return False
    dt = a.dtype
    if reduce_op is not None:
        from . import ring as _ring
        if reduce_op not in _ring.RING_OPS:
            return False
        return dt.kind in "iuf" or _lowp.is_lowp(dt)
    return dt.kind in "iufb" or _lowp.is_lowp(dt)


def _partition_and_dp(arrs, group, store, reduce_op=None):
    """Split leaves into (data-plane indices, store indices) and bring up
    the data plane only when a leaf needs it."""
    big = {i for i, a in enumerate(arrs) if _dp_leaf_ok(a, reduce_op)}
    dp = _maybe_data_plane(group, store) if big else None
    return sorted(big), [i for i in range(len(arrs)) if i not in big], dp


# -- transport counters and the flight recorder ------------------------------

def _record(op: str, path: str, nbytes: int, t0: float,
            wire_bytes=None, raw_wire_bytes=None) -> None:
    """Account one transport leg of ``op`` over ``path`` begun at ``t0``
    (``perf_counter``): the single ingestion point of the per-(op, path)
    counters and of the enclosing flight-recorder span.  ``wire_bytes`` is
    what crossed the wire, ``raw_wire_bytes`` the same traffic
    uncompressed."""
    _obs_rec.record_transport(op, path, nbytes, time.perf_counter() - t0,
                              wire_bytes=wire_bytes,
                              raw_wire_bytes=raw_wire_bytes)


def _obs_span(op: str, value=None, reduce_op=None, src=None, dst=None,
              peer=None, kind: str = "collective", group=None):
    """Flight-recorder span around one eager collective; disarmed, a shared
    no-op context after one env lookup.  ``group`` is a SubGroup's id
    (None for the flat world)."""
    from ..obs import hooks as _hooks
    return _hooks.collective_span(op, value=value, reduce_op=reduce_op,
                                  src=src, dst=dst, peer=peer, kind=kind,
                                  group=group)


def _obs_mesh() -> None:
    """Mark the enclosing span as having ridden the group's backend: the
    path ``"mesh"``, the JAX package's word for its device collectives."""
    from ..obs import hooks as _hooks
    _hooks.note_path("mesh")


# the armed values sanitizer.enabled() recognizes: the gate here parses
# identically, or TPU_DIST_SANITIZE=0 would arm the check one-sidedly
_SANITIZE_ON = ("1", "true", "yes", "on")


def _sanitize(op: str, group, store=None, **fields) -> None:
    """Cross-rank signature check before a collective moves any payload
    (:mod:`tpu_dist_torch.analysis.sanitizer`), under
    ``TPU_DIST_SANITIZE=1``; off, one env lookup.  The signatures ride the
    control-plane store whatever the payload's route, so a job without
    the store skips the check."""
    if (os.environ.get("TPU_DIST_SANITIZE", "").strip().lower()
            not in _SANITIZE_ON):
        return
    if store is None:
        store = _coll_store()
    if store is None or group.num_processes <= 1:
        return
    from ..analysis import sanitizer
    # the wire format is signed: ranks that disagree on it would exchange
    # frames they cannot read
    fields.setdefault("comm", _comm_name())
    sanitizer.check_collective(group, store, op, **fields)


def _comm_name() -> Optional[str]:
    """The configured wire formats as one spec string (the JAX
    package's), which the sanitizer signs; the gather knob is in it too."""
    from . import quant as _quant
    reduce_spec = _quant.wire_name(_comm_dtype())
    gather_spec = _quant.wire_name(_gather_comm_dtype())
    if gather_spec is None:
        return reduce_spec
    return f"{reduce_spec or 'f32'}+gather:{gather_spec}"


# -- point to point -----------------------------------------------------------

_p2p_send_seq: dict = {}   # (me, dst, tag, group) -> next sequence number
_p2p_recv_seq: dict = {}   # (src, me, tag, group) -> next sequence number


def _check_p2p(peer: int, group, what: str) -> None:
    if peer == group.rank:
        raise ValueError(f"{what} self deadlocks (torch semantics)")
    if not 0 <= peer < group.num_processes:
        raise ValueError(f"{'dst' if what == 'send to' else 'src'} {peer} "
                         f"out of range (num_processes="
                         f"{group.num_processes})")


def _p2p_key(src: int, dst: int, tag: int, seq: int, group=None) -> str:
    return f"{_ns()}{_group_scope(group)}/p2p/{src}->{dst}/t{tag}/{seq}"


def _p2p_wire_tag(tag: int, seq: int) -> str:
    return f"p2p/t{tag}/{seq}"


def send(x, dst: int, group=None, tag: int = 0, async_op: bool = False):
    """torch ``dist.send`` parity: deliver this process's array to process
    ``dst``, matched by program order per (src, dst, tag).  On the JAX
    routing an array of at least ``TPU_DIST_DP_THRESHOLD`` bytes goes as
    one data-plane frame and a smaller one through a store key; on the
    backend it rides ``torch.distributed.send`` (``np.save`` framing).
    ``async_op=True`` returns a Work; the payload is copied at issue."""
    group = _default_group(group)
    _check_p2p(dst, group, "send to")
    arr = np.array(_host(x))
    if async_op:
        return engine().submit(lambda: _send_body(arr, dst, group, tag),
                               label=f"send->r{dst}")
    drain_pending()
    return _send_body(arr, dst, group, tag)


def _send_body(arr: np.ndarray, dst: int, group, tag: int) -> None:
    with _obs_span("send", value=arr, dst=dst, kind="p2p"):
        store = _coll_store()
        if not _use_backend(group, store):
            return _routed_send(arr, dst, group, tag, store)
        _obs_mesh()
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        raw = np.frombuffer(buf.getvalue(), np.uint8).copy()
        dev, peer = _stage(group), group.ranks[dst]
        torch.distributed.send(torch.tensor([raw.size], dtype=torch.int64,
                                            device=dev), dst=peer,
                               group=group.torch_group, tag=tag)
        torch.distributed.send(torch.from_numpy(raw).to(dev), dst=peer,
                               group=group.torch_group, tag=tag)


def _routed_send(arr, dst: int, group, tag: int, store) -> None:
    me = group.rank
    # the sequence number is consumed only on a successful handoff, so a
    # caller that recovers and retries stays matched with the receiver
    key = (me, dst, tag, _group_id(group))
    seq = _p2p_send_seq.get(key, 0)
    t0 = time.perf_counter()
    if _dp_leaf_ok(arr):
        dp = _maybe_data_plane(group, store)
        if dp is not None:
            dp.send_array(dst, _p2p_wire_tag(tag, seq), arr)
            _p2p_send_seq[key] = seq + 1
            _record("send", "dataplane", arr.nbytes, t0)
            return
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    store.set(_p2p_key(me, dst, tag, seq, group), buf.getvalue())
    _p2p_send_seq[key] = seq + 1
    _record("send", "store", arr.nbytes, t0)


def recv(src: int, group=None, tag: int = 0, async_op: bool = False):
    """torch ``dist.recv`` parity: block until the matching :func:`send`
    from ``src`` arrives; returns the array.  On the JAX routing it waits
    on the data-plane frame and the store key together.  ``async_op=True``
    returns a Work whose ``wait()`` yields it."""
    group = _default_group(group)
    _check_p2p(src, group, "recv from")
    if async_op:
        return engine().submit(lambda: _recv_body(src, group, tag),
                               label=f"recv<-r{src}")
    drain_pending()
    return _recv_body(src, group, tag)


def _recv_body(src: int, group, tag: int) -> np.ndarray:
    with _obs_span("recv", src=src, kind="p2p"):
        store = _coll_store()
        if not _use_backend(group, store):
            return _routed_recv(src, group, tag, store)
        _obs_mesh()
        dev, peer = _stage(group), group.ranks[src]
        size = torch.empty(1, dtype=torch.int64, device=dev)
        torch.distributed.recv(size, src=peer, group=group.torch_group,
                               tag=tag)
        buf = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
        torch.distributed.recv(buf, src=peer, group=group.torch_group,
                               tag=tag)
        return np.load(io.BytesIO(buf.cpu().numpy().tobytes()),
                       allow_pickle=False)


def _routed_recv(src: int, group, tag: int, store) -> np.ndarray:
    me = group.rank
    # consumed only on delivery (mirrors send)
    skey = (src, me, tag, _group_id(group))
    seq = _p2p_recv_seq.get(skey, 0)
    key = _p2p_key(src, me, tag, seq, group)
    t0 = time.perf_counter()

    def delivered(out, path):
        _p2p_recv_seq[skey] = seq + 1
        _record("recv", path, out.nbytes, t0)
        return out

    def from_store():
        raw = store.get(key)
        store.delete_key(key)
        return delivered(np.load(io.BytesIO(raw), allow_pickle=False),
                         "store")

    dp = _maybe_data_plane(group, store) if _dp_enabled() else None
    if dp is None:
        return from_store()
    try:
        path, arr = dp.recv_array_dual(src, _p2p_wire_tag(tag, seq),
                                       alt_check=lambda: store.check(key))
    except TimeoutError as e:
        raise TimeoutError(
            f"recv from rank {src} tag {tag} seq {seq} got neither a "
            f"data-plane frame nor a store key before the "
            f"TPU_DIST_DP_TIMEOUT deadline: {e}") from e
    if path == "dataplane":
        return delivered(arr, "dataplane")
    return from_store()


def send_recv_device(x: torch.Tensor, src: int, dst: int, group=None):
    """Tensor point to point between two ranks' devices, no host copy:
    every rank passes its own block ``x``; rank ``dst`` gets ``src``'s block
    in place of its own, every other rank keeps its own (the JAX function's
    result over the mesh, seen from one rank)."""
    group = _default_group(group)
    src, dst = int(src), int(dst)
    n = group.size()
    for name, r in (("src", src), ("dst", dst)):
        if not 0 <= r < n:
            raise ValueError(f"{name} {r} out of range (mesh size {n})")
    if src == dst:
        raise ValueError("send to self deadlocks (torch semantics)")
    me = group.rank
    if me == src:
        torch.distributed.send(x.contiguous(), dst=group.ranks[dst],
                               group=group.torch_group)
        return x
    if me == dst:
        out = torch.empty_like(x).contiguous()
        torch.distributed.recv(out, src=group.ranks[src],
                               group=group.torch_group)
        return out
    return x
