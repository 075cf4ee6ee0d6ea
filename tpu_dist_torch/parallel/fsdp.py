"""Fully-sharded data parallelism (ZeRO-3) — counterpart of
``tpu_dist/parallel/fsdp.py``.

The JAX package makes FSDP a placement: every parameter and its optimizer
state stored sharded over an axis, and XLA's partitioner turns the ordinary
global step into the ZeRO-3 schedule.  The port keeps the placement half as
it is — :func:`fsdp_specs` picks, per leaf, its largest dim that the axis
divides (the first on ties); leaves under ``min_size`` elements or with no
divisible dim stay whole; a leaf that another placement already splits
(the tp rules on a ``("data", "fsdp", "model")`` mesh) keeps its axes and
gains the fsdp axis on its largest still-free divisible dim — and
:func:`fsdp_shard` gives this rank its slice of each leaf.

The schedule half is ``parallel.make_gspmd_train_step``'s, through
:class:`Gatherer`: a leaf whose slice is smaller than its parameter is an
fsdp shard; each layer's shards are gathered over the fsdp line right
before the layer runs (a forward pre-hook) and dropped after it (the
gathered tensors autograd would keep are packed back into their shards,
``saved_tensors_hooks``), gathered again when the layer's backward needs
them, and the gathered parameter's gradient is reduce-scattered into the
shard.  The optimizer steps on the shards (its state, ``optimizer.init`` of
the shards, is sharded with them).

The collectives: NCCL takes ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; gloo takes ``all_gather_into_tensor`` and, for
the reduce-scatter, ``all_reduce`` and this rank's slice (gloo on CUDA
tensors has no reduce-scatter the port relies on).

Usage (1-D, over ``data``)::

    pg = dist.init_process_group(...)
    model = TransformerLM(...)
    params = fsdp_shard(dict(model.named_parameters()), pg)
    opt_state = opt.init(params)                  # sharded with them
    step = make_gspmd_train_step(model, loss_fn, opt)
    params, opt_state, metrics = step(params, opt_state, x_rows, y_rows)

On a ``("data", "fsdp", "model")`` mesh, build the model with
``model_axis="model"`` (its layers hold their tp slices) and shard those
with ``axis="fsdp"``; :func:`tpu_dist_torch.interop.shard_jax_params` slices
a JAX package tree exactly as the JAX placement does.  The module's own
parameters are templates of the gathered shapes; the shards need not live
there (``model.to("meta")`` frees them).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["fsdp_specs", "fsdp_shard", "Gatherer", "gather_dim",
           "reduce_scatter_dim"]


def _rule_spec_fn(rules):
    """keystr → base spec (or None) from a rule source: a rule table dict
    (``parallel/rules.py``), a :class:`~.gspmd.PartitionRules`, or None."""
    if rules is None:
        return lambda key: None
    if isinstance(rules, dict):
        from .rules import spec_for_key

        def from_table(key):
            spec = spec_for_key(key, rules)
            return spec if any(a is not None for a in spec) else None
        return from_table

    def from_rules(key):
        spec = rules.spec_for(key)
        return spec if any(a is not None for a in spec) else None
    return from_rules


def _leaf_spec(shape, axis: str, size: int, min_size: int,
               base: Optional[tuple]) -> tuple:
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if base is not None:
        # already placed: keep its axes, add the fsdp axis on the largest
        # still-replicated divisible dim (2-D weight sharding); no free
        # dim, or the axis already placed: leave it
        if axis not in base and n >= min_size:
            free = [d for d in range(len(shape))
                    if d >= len(base) or base[d] is None]
            for d in sorted(free, key=lambda d: shape[d], reverse=True):
                if shape[d] % size == 0:
                    spec = list(base) + [None] * (len(shape) - len(base))
                    spec[d] = axis
                    return tuple(spec)
        return tuple(base)
    if not shape or n < min_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda d: shape[d],
                    reverse=True):
        if shape[d] % size == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def _axis_size(mesh, axis: str) -> int:
    if mesh is None:
        from .. import dist
        return dist.axis_group(axis).size
    if isinstance(getattr(mesh, "shape", None), dict):  # a parallel.Mesh
        return mesh.shape[axis]
    return mesh.axis_group(axis).size


def fsdp_specs(tree, mesh=None, axis: str = "data", min_size: int = 2 ** 12,
               rules=None):
    """A spec tree (tuples, as ``PartitionRules`` gives) with ``tree``'s
    structure: each leaf's largest ``axis``-divisible dim on ``axis``;
    leaves under ``min_size`` elements or with no divisible dim ``()``.
    ``rules`` (a rule table dict or a ``PartitionRules``) gives each leaf a
    base spec first, by its JAX keystr, which keeps its axes and gains
    ``axis`` on its largest free divisible dim.  ``mesh``: a port process
    group (default: the default group) or a ``parallel.Mesh``."""
    from .gspmd import _keystr, _tree_map
    size = _axis_size(mesh, axis)
    base_of = _rule_spec_fn(rules)
    return _tree_map(
        lambda keys, leaf: () if leaf is None else _leaf_spec(
            tuple(leaf.shape), axis, size, min_size,
            base_of(_keystr(keys))), tree)


def fsdp_shard(tree, mesh=None, axis: str = "data", min_size: int = 2 ** 12,
               specs=None, rules=None):
    """This rank's slice of every leaf of ``tree`` by :func:`fsdp_specs`
    (or explicit ``specs``), each a copy (``None`` passes through).  With
    ``rules`` the base axes slice too (the tp rules' factored qkv
    included), so a JAX package tree gives the JAX placement's shard."""
    from .gspmd import PartitionRules, _slice, _tree_map
    if mesh is None:
        from .. import dist
        mesh = dist.get_default_group()
    if specs is None:
        specs = fsdp_specs(tree, mesh, axis, min_size, rules)
    binding = rules.binding if isinstance(rules, PartitionRules) else rules

    def place(keys, leaf):
        spec = specs
        for k in keys:
            spec = spec[k]
        return None if leaf is None else _slice(leaf, spec, mesh, keys,
                                                binding)

    return _tree_map(place, tree)


# ---------------------------------------------------------------------------
# the schedule: gather before use, reduce-scatter the gradient
# ---------------------------------------------------------------------------

def _backend(line) -> str:
    return torch.distributed.get_backend(line.group)


def gather_dim(shard: torch.Tensor, line, dim: int) -> torch.Tensor:
    """Every rank's ``shard`` concatenated along ``dim`` in line order: a
    tensor that owns its storage (no view), so that the tensors autograd
    saves from it are views of it alone (:meth:`Gatherer._pack`)."""
    shape = tuple(shard.shape)
    out = shard.new_empty((line.size * shape[0],) + shape[1:] if dim == 0
                          else (line.size,) + shape)
    torch.distributed.all_gather_into_tensor(
        out.view(-1), shard.contiguous().view(-1), group=line.group)
    if dim == 0:
        return out
    # moving the ranks' axis in front of ``dim`` copies
    return out.movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter_dim(full: torch.Tensor, line, dim: int) -> torch.Tensor:
    """The sum over ``line`` of ``full``, this rank's slice along ``dim``
    (NCCL: ``reduce_scatter_tensor``; gloo: ``all_reduce`` and the slice)."""
    src = full.unflatten(dim, (line.size, -1)).movedim(dim, 0).contiguous()
    if _backend(line) == "gloo":
        torch.distributed.all_reduce(src, group=line.group)
        return src[line.index].clone()
    out = src.new_empty(src.shape[1:])
    torch.distributed.reduce_scatter_tensor(out, src, group=line.group)
    return out


class _Gather(torch.autograd.Function):
    """Gather forward, reduce-scatter (sum) backward."""

    @staticmethod
    def forward(ctx, shard, line, dim):
        ctx.line, ctx.dim = line, dim
        return gather_dim(shard, line, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.line, ctx.dim), None, None


class Gatherer:
    """The ZeRO-3 schedule of a step over ``model``: ``shards`` maps
    parameter names to ``dim`` — the dim along which the step's slice of
    that parameter is split over ``line`` (an
    :class:`~tpu_dist_torch.dist.AxisGroup`).  Installs a forward pre-hook
    and a forward hook on each owning layer; they act only inside
    :meth:`active`, where each layer's shards (the tensors the step's
    ``functional_call`` put in place) are gathered before it runs and put
    back after it, and every gathered tensor autograd saves is packed back
    into its shard and gathered again when the backward reads it."""

    def __init__(self, model: torch.nn.Module, shards: Dict[str, int], line):
        self.line = line
        self._on = False
        self._gathered: dict = {}
        owners: Dict[str, Dict[str, int]] = {}
        for name, dim in shards.items():
            path, _, leaf = name.rpartition(".")
            owners.setdefault(path, {})[leaf] = dim
        self._handles = []
        for path, leaves in owners.items():
            mod = model.get_submodule(path)
            self._handles.append(mod.register_forward_pre_hook(
                self._pre(leaves)))
            self._handles.append(mod.register_forward_hook(
                self._post(leaves)))

    def _pre(self, leaves):
        def hook(mod, args):
            if not self._on:
                return
            put = {}
            for leaf, dim in leaves.items():
                shard = mod._parameters[leaf]
                full = _Gather.apply(shard, self.line, dim)
                self._gathered[id(full)] = (weakref.ref(full), shard, dim)
                put[leaf] = shard
                mod._parameters[leaf] = full
            mod._fsdp_shards = put
        return hook

    @staticmethod
    def _post(leaves):
        def hook(mod, args, out):
            put = mod.__dict__.pop("_fsdp_shards", None)
            if put:
                mod._parameters.update(put)
        return hook

    def _pack(self, t):
        base = t if t._base is None else t._base
        got = self._gathered.get(id(base))
        if got is None or got[0]() is not base:
            return t
        _, shard, dim = got
        return ("fsdp", shard, dim, t.size(), t.stride(),
                t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, tuple):
            _, shard, dim, size, stride, offset = packed
            with torch.no_grad():
                full = gather_dim(shard.detach(), self.line, dim)
            return full.as_strided(size, stride, offset)
        return packed

    def active(self):
        """The context a step's forward and backward run in."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self._on = True
            try:
                with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                              self._unpack):
                    yield
            finally:
                self._on = False
                self._gathered.clear()
        return ctx()

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
