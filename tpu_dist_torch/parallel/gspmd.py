"""The GSPMD step — counterpart of ``tpu_dist/parallel/gspmd.py`` for its
expert-parallel use, on a ``("data", "expert")`` mesh of ranks.

The JAX package writes one global training step and lets XLA's SPMD
partitioner cut it by the placement of its inputs: parameters placed by a
rule table (:class:`PartitionRules`, :data:`MOE_EP_RULES`), the batch split
over ``data``.  Torch has no partitioner, so the port runs the same global
function as a per-rank program:

- :func:`shard_pytree` gives this rank its slice of every leaf, by the
  leaf's spec (``("expert",)``: its rows of the leading dim along the
  ``expert`` axis; ``()``: the whole leaf);
- the MoE layers built with ``expert_axis="expert"`` hold only their
  rank's experts and carry the expert axis themselves (``nn/moe.py``:
  routing and capacity over the global batch, the partial outputs summed
  over the expert line);
- the step's gradient sync averages each leaf over the ranks that hold the
  same piece of it: a replicated leaf over the world, the expert bank of
  a layer that holds a slice of its experts over its ``data`` line.  The
  layers say which leaves those are; :data:`MOE_EP_RULES` places the JAX
  package's trees (``interop``, :func:`shard_pytree`).

Each rank of an expert line holds the same rows (the batch is split over
``data`` only), so its loss is the global mean's term for those rows; the
average of the ranks' gradients is the global step's gradient.

Attention keeps the port's dispatch (K2f/K2b on the card at 1024 positions
and more).  The JAX step forces dense attention because XLA's partitioner
cannot cut a Pallas call; a per-rank torch program has no such limit, and
the CPU tests hold the port's attention to JAX's dense attention within
tolerance.

Tensor parallelism (a ``model`` axis, :data:`TRANSFORMER_TP_RULES`) is
ROADMAP A9.6: the step raises on such a mesh.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rules as _rules

__all__ = ["PartitionRules", "shard_pytree", "make_gspmd_train_step",
           "TRANSFORMER_TP_RULES", "MOE_EP_RULES"]


def _keystr(keys) -> str:
    """The JAX ``keystr`` of a leaf at ``keys`` of a nested dict, list or
    tuple (``['block0.mlp']['w1']``); a port parameter name at the top of
    a flat dict (``block0.mlp.w1``) reads as its module path and leaf."""
    if len(keys) == 1 and isinstance(keys[0], str) and "." in keys[0]:
        keys = keys[0].rpartition(".")[::2]
    return "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]"
                   for k in keys)


def _tree_map(fn, tree, keys=()):
    """``fn(keys, leaf)`` over a nested dict, list or tuple."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, keys + (i,))
                          for i, v in enumerate(tree))
    return fn(keys, tree)


class PartitionRules:
    """Ordered (path regex → spec) rules; the first match wins.

    Paths are JAX ``keystr`` paths (``"['block0.attn']['qkv_weight']"``);
    regexes are searched, not fullmatched.  A spec is the port's plain
    partition spec: a tuple with a mesh-axis name or ``None`` per leading
    dim; an unmatched leaf gets ``()``, replicated."""

    def __init__(self, rules: Sequence[Tuple[str, tuple]]):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str, leaf=None) -> tuple:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return ()

    def tree_specs(self, tree):
        """A tree of specs with ``tree``'s structure."""
        return _tree_map(lambda keys, leaf: self.spec_for(_keystr(keys),
                                                          leaf), tree)


# Megatron-style transformer sharding over a 'model' axis (qkv and MLP-in
# column-wise, attention-out and MLP-out row-wise, the vocab tables on the
# vocab), from the rule plane; its step is ROADMAP A9.6
TRANSFORMER_TP_RULES = PartitionRules(_rules.partition_pairs())

# expert parallelism over an 'expert' axis: every stacked MoE leaf
# (w1/b1/w2/b2, leading dim the experts) splits its expert dim; the router
# and everything else replicate
MOE_EP_RULES = PartitionRules(_rules.partition_pairs({"expert": "expert"}))


def _slice(leaf, spec: tuple, mesh):
    if not isinstance(leaf, torch.Tensor):
        leaf = np.asarray(leaf)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        line = mesh.axis_group(axis)
        n = leaf.shape[dim]
        if n % line.size:
            raise _rules.ShardLayoutError(
                f"dim {dim} of {tuple(leaf.shape)} does not split over the "
                f"{line.size} ranks of mesh axis {axis!r}")
        per = n // line.size
        index = (slice(None),) * dim + (
            slice(line.index * per, (line.index + 1) * per),)
        leaf = leaf[index]
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    return leaf.copy()


def shard_pytree(tree, mesh=None, rules: Optional[PartitionRules] = None):
    """This rank's slice of every leaf of ``tree`` (tensors or numpy arrays;
    ``None`` passes through) on ``mesh`` (a port process group; default:
    the default group) by ``rules`` (default: replicate everything).  Each
    slice is a copy, never a view of the leaf."""
    if rules is None:
        return _tree_map(lambda keys, leaf: None if leaf is None
                         else _slice(leaf, (), mesh), tree)
    if mesh is None:
        from .. import dist
        mesh = dist.get_default_group()
    specs = rules.tree_specs(tree)

    def place(keys, leaf):
        spec = specs
        for k in keys:
            spec = spec[k]
        return None if leaf is None else _slice(leaf, spec, mesh)

    return _tree_map(place, tree)


def _bank_lines(moes) -> dict:
    """``{parameter name: the mesh line its gradient is averaged over}`` of
    the leaves not averaged over the world: the expert banks of every MoE
    layer that holds a slice of its experts, over its data line.  The
    layers decide (``MoELayer(expert_axis=)``), not the names."""
    return {f"{path}.{leaf}" if path else leaf: m.data_line
            for path, m in moes if m.local_experts < m.num_experts
            for leaf in ("w1", "b1", "w2", "b2")}


def make_gspmd_train_step(model: torch.nn.Module, loss_fn, optimizer,
                          aux_loss_coeff: float = 0.0,
                          compute_dtype=None) -> Callable:
    """Build the step: ``step(params, opt_state, x, y) -> (params,
    opt_state, metrics)``, or, for a model with MoE layers (module state:
    their aux losses), ``step(params, opt_state, mstate, x, y) -> (params,
    opt_state, new_mstate, metrics)``.

    ``params`` are this rank's parameters by name (the module's own, or
    :func:`shard_pytree`'s slices), updated in place;
    ``x``/``y`` this rank's rows of the global batch (its ``data`` shard;
    every rank of an expert line passes the same rows).  ``mstate`` is
    ``{path: {"aux_loss": scalar}}`` per MoE layer.  ``metrics``: ``loss``
    (the global mean) and ``correct`` (the global count), device scalars.

    ``aux_loss_coeff`` weighs the sum of the MoE layers' aux losses in the
    objective, once.  ``compute_dtype`` runs the forward and backward in
    that dtype over the float32 parameters (the DDP's option).  The mesh is
    the default group's (world 1 without one).  A mesh with a ``model``
    axis raises (ROADMAP A9.6); so does a BatchNorm, whose global batch
    statistics are not ported."""
    from .. import dist
    from ..nn.layers import BatchNorm2d
    from ..nn.moe import MoELayer

    group = dist.get_default_group() if dist.is_initialized() else None
    if group is not None and "model" in group.axis_names:
        raise NotImplementedError(
            "a 'model' mesh axis: tensor parallelism under the GSPMD step "
            "is not in the port yet (ROADMAP A9.6)")
    if any(isinstance(m, BatchNorm2d) for m in model.modules()):
        raise NotImplementedError(
            "BatchNorm under the GSPMD step (global batch statistics) is "
            "not in the port yet (ROADMAP A9.6)")
    moes = [(p, m) for p, m in model.named_modules()
            if isinstance(m, MoELayer)]
    world = (dist.AxisGroup("world", 1, 0, (0,)) if group is None else
             dist.AxisGroup("world", group.size(), group.rank,
                            tuple(range(group.size())), group.torch_group))
    lines = _bank_lines(moes)
    data = (group.axis_group(dist.DATA_AXIS)
            if group is not None and dist.DATA_AXIS in group.axis_names
            else None)

    @torch.no_grad()
    def average(grads: Dict[str, torch.Tensor]):
        """Each gradient averaged over its line, one flat all-reduce per
        line and dtype."""
        buckets: Dict[tuple, list] = {}
        for k in grads:
            line = lines.get(k, world)
            if line.size > 1:
                buckets.setdefault((line.ranks, grads[k].dtype),
                                   []).append(k)
        out = dict(grads)
        for names in buckets.values():
            line = lines.get(names[0], world)
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            torch.distributed.all_reduce(flat, group=line.group)
            # a 0-d device divisor: the card divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            flat /= torch.tensor(float(line.size), dtype=flat.dtype,
                                 device=flat.device)
            for k, v in zip(names, flat.split([grads[k].numel()
                                               for k in names])):
                out[k] = v.view_as(grads[k])
        return out

    def run(params, opt_state, x, y):
        model.train()
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            cast = leaves
            if compute_dtype is not None:
                cast = {k: v.to(compute_dtype) if v.is_floating_point()
                        else v for k, v in leaves.items()}
                if x.is_floating_point():
                    x = x.to(compute_dtype)
            out = torch.func.functional_call(model, cast, (x,))
            loss = loss_fn(out, y)
            objective = loss
            if moes and aux_loss_coeff:
                objective = objective + aux_loss_coeff * sum(
                    m.aux_loss for _, m in moes)
            grads = torch.autograd.grad(objective, list(leaves.values()))
        with torch.no_grad():
            grads = average(dict(zip(leaves, grads)))
            loss = loss.detach().float()
            correct = (out.argmax(-1) == y).sum()
            if data is not None and data.size > 1:
                for t in (loss, correct):
                    torch.distributed.all_reduce(t, group=data.group)
                loss /= data.size
            new_params, new_opt = optimizer.update(grads, opt_state, params)
            mstate = {p: {"aux_loss": m.aux_loss.detach().to(
                torch.float32, copy=True)} for p, m in moes}
        return new_params, new_opt, mstate, {"loss": loss, "correct": correct}

    if moes:
        def stateful_step(params, opt_state, mstate, x, y):
            return run(params, opt_state, x, y)
        return stateful_step

    def stateless_step(params, opt_state, x, y):
        new_params, new_opt, _, metrics = run(params, opt_state, x, y)
        return new_params, new_opt, metrics
    return stateless_step
