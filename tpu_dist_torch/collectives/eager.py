"""Eager host-level collectives on a ProcessGroup — counterpart of
``tpu_dist/collectives/eager.py``.

torch call-style parity (``dist.all_reduce``, ``dist.reduce``,
``dist.gather``/``scatter``, ``dist.send``/``recv``, the ``*_object``
collectives) for out-of-step syncs: metric averaging, parameter broadcast,
control decisions.  Each function takes this process's value (a numpy array,
a Python scalar or a tensor, or a dict/list/tuple tree of them) and returns
numpy, as the JAX functions do; a group of one process returns at once.

**Transport.**  Everything rides the group's own ``torch.distributed``
backend, staged through the group's device (NCCL: the rank's card; gloo:
the CPU): the payload is pickled, moved as a uint8 tensor (an all-gather of
the lengths, then of the padded payloads, or a broadcast of the length and
then of the payload) and reduced on the host in rank order with the JAX
package's numpy ufuncs (``np.mean`` for ``avg``), so each reduction gives
the JAX store path's result bit for bit.  The JAX routing layer (store keys,
the socket data plane, the sanitizer) belongs to the host data plane,
ROADMAP A9.1b; :func:`send`/:func:`recv` ride ``torch.distributed.send``/
``recv`` with the tag.  The objects are pickled: send only what this job
made.

``async_op=True`` (``all_reduce_host``, ``all_gather_host``,
``broadcast_host``, ``send``, ``recv``) returns a
:class:`~tpu_dist_torch.collectives.work.Work` run on the ordered executor,
its input copied at issue; every synchronous call first drains that queue.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, List, Optional

import numpy as np
import torch

from . import _tree
from .work import completed_work, drain_pending, engine

__all__ = ["ReduceOp", "all_reduce_host", "all_gather_host",
           "broadcast_host", "reduce_host", "gather_host", "scatter_host",
           "send", "recv", "send_recv_device", "all_gather_object",
           "gather_object", "broadcast_object_list", "scatter_object_list",
           "all_to_all_host"]


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
    return group


def _check_peer(rank: int, group, what: str) -> None:
    if not 0 <= rank < group.num_processes:
        raise ValueError(f"{what} {rank} out of range "
                         f"(num_processes={group.num_processes})")


def _host(v) -> np.ndarray:
    """A leaf as numpy (a tensor is copied to the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _snapshot(x):
    """Issue-time copy of an async collective's input tree, so the caller
    may change its arrays the moment the Work returns."""
    return _tree.tree_map(lambda v: np.array(_host(v)), x)


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


def all_reduce_host(x, group=None, op: str = ReduceOp.SUM,
                    async_op: bool = False):
    """Reduce a per-process value across the group; returns the reduced
    value (numpy tree) on every process, reduced in rank order."""
    group = _default_group(group)
    fn = _reduce_fn(op)
    if async_op:
        x = _snapshot(x)
        return _submit(lambda: _all_reduce_body(x, group, fn),
                       f"all_reduce[{str(op).lower()}]", group, lambda: x)
    if group.num_processes <= 1:
        return _tree.tree_map(_host, x)
    drain_pending()
    return _all_reduce_body(x, group, fn)


def _all_reduce_body(x, group, fn):
    rows, treedef = _leaves_of_all(x, group)
    return _tree.unflatten(treedef, [
        fn(np.stack([row[i] for row in rows])) for i in range(len(rows[0]))])


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
    rows, treedef = _leaves_of_all(x, group)
    return _tree.unflatten(treedef, [
        np.stack([row[i] for row in rows]) for i in range(len(rows[0]))])


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
    _check_peer(src, group, "src")
    leaves, treedef = _tree.flatten(x)
    raw = (_dumps([np.array(_host(v)) for v in leaves])
           if group.rank == src else None)
    vals = pickle.loads(_broadcast_bytes(raw, src, group))
    return _tree.unflatten(treedef, [np.asarray(v) for v in vals])


def reduce_host(x, dst: int = 0, group=None, op: str = ReduceOp.SUM):
    """torch ``dist.reduce`` parity: the reduced value on process ``dst``,
    ``None`` elsewhere."""
    group = _default_group(group)
    fn = _reduce_fn(op)
    _check_peer(dst, group, "dst")
    if group.num_processes <= 1:
        return _tree.tree_map(_host, x)
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
    other process returns ``None``."""
    group = _default_group(group)
    _check_peer(dst, group, "dst")
    if group.num_processes <= 1:
        return [_tree.tree_map(_host, x)]
    drain_pending()
    rows = _all_gather_bytes(_dumps(_tree.tree_map(_host, x)), group)
    if group.rank != dst:
        return None
    return [pickle.loads(r) for r in rows]


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
    full = pickle.loads(_broadcast_bytes(
        _dumps(payload) if group.rank == src else None, src, group))
    return full[group.rank]


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """torch ``dist.all_gather_object`` parity: every process returns the
    list of all processes' objects (index = rank)."""
    group = _default_group(group)
    if group.num_processes <= 1:
        return [obj]
    drain_pending()
    return [pickle.loads(r) for r in _all_gather_bytes(_dumps(obj), group)]


def gather_object(obj: Any, dst: int = 0, group=None) -> Optional[List[Any]]:
    """torch ``dist.gather_object`` parity: process ``dst`` returns the
    rank-indexed object list, every other process ``None``."""
    group = _default_group(group)
    _check_peer(dst, group, "dst")
    if group.num_processes <= 1:
        return [obj] if group.rank == dst else None
    drain_pending()
    rows = _all_gather_bytes(_dumps(obj), group)
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
    drain_pending()
    raw = _dumps(list(object_list)) if group.rank == src else None
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
    rows = all_gather_object(list(input_list), group)
    return [rows[r][group.rank] for r in range(n)]


# -- point to point -----------------------------------------------------------

def _check_p2p(peer: int, group, what: str) -> None:
    if peer == group.rank:
        raise ValueError(f"{what} self deadlocks (torch semantics)")
    if not 0 <= peer < group.num_processes:
        raise ValueError(f"{'dst' if what == 'send to' else 'src'} {peer} "
                         f"out of range (num_processes="
                         f"{group.num_processes})")


def send(x, dst: int, group=None, tag: int = 0, async_op: bool = False):
    """torch ``dist.send`` parity: deliver this process's array to process
    ``dst``, matched by program order per (src, dst, tag).  The array's
    shape and dtype travel with it (``np.save`` framing).  ``async_op=True``
    returns a Work; the payload is copied at issue."""
    group = _default_group(group)
    _check_p2p(dst, group, "send to")
    arr = np.array(_host(x))
    if async_op:
        return engine().submit(lambda: _send_body(arr, dst, group, tag),
                               label=f"send->r{dst}")
    drain_pending()
    return _send_body(arr, dst, group, tag)


def _send_body(arr: np.ndarray, dst: int, group, tag: int) -> None:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    raw = np.frombuffer(buf.getvalue(), np.uint8).copy()
    dev, peer = _stage(group), group.ranks[dst]
    torch.distributed.send(torch.tensor([raw.size], dtype=torch.int64,
                                        device=dev), dst=peer,
                           group=group.torch_group, tag=tag)
    torch.distributed.send(torch.from_numpy(raw).to(dev), dst=peer,
                           group=group.torch_group, tag=tag)


def recv(src: int, group=None, tag: int = 0, async_op: bool = False):
    """torch ``dist.recv`` parity: block until the matching :func:`send`
    from ``src`` arrives; returns the array.  ``async_op=True`` returns a
    Work whose ``wait()`` yields it."""
    group = _default_group(group)
    _check_p2p(src, group, "recv from")
    if async_op:
        return engine().submit(lambda: _recv_body(src, group, tag),
                               label=f"recv<-r{src}")
    drain_pending()
    return _recv_body(src, group, tag)


def _recv_body(src: int, group, tag: int) -> np.ndarray:
    dev, peer = _stage(group), group.ranks[src]
    size = torch.empty(1, dtype=torch.int64, device=dev)
    torch.distributed.recv(size, src=peer, group=group.torch_group, tag=tag)
    buf = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    torch.distributed.recv(buf, src=peer, group=group.torch_group, tag=tag)
    return np.load(io.BytesIO(buf.cpu().numpy().tobytes()),
                   allow_pickle=False)


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
