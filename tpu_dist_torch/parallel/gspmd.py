"""The GSPMD step — counterpart of ``tpu_dist/parallel/gspmd.py`` on a mesh
of ranks: ``("data", "expert")`` (expert parallelism), ``("data",
"model")`` (tensor parallelism), an fsdp axis (``parallel/fsdp.py``), or
``("data", "fsdp", "model")``.

The JAX package writes one global training step and lets XLA's SPMD
partitioner cut it by the placement of its inputs: parameters placed by a
rule table (:class:`PartitionRules`, :data:`TRANSFORMER_TP_RULES`,
:data:`MOE_EP_RULES`), the batch split over ``data``.  Torch has no
partitioner, so the port runs the same global function as a per-rank
program:

- :func:`shard_pytree` gives this rank its slice of every leaf of a JAX
  package tree, by the leaf's spec (``("expert",)``: its rows of the
  leading dim along the ``expert`` axis; ``(None, "model")``: its columns,
  the fused qkv's factored ``(qkv3, heads, head_dim)`` so that a rank holds
  ``[q_heads_r | k_heads_r | v_heads_r]``; ``()``: the whole leaf);
- the layers carry the axes: MoE layers built with ``expert_axis=`` hold
  their rank's experts (``nn/moe.py``), a model built with ``model_axis=``
  holds its rank's heads, MLP columns and vocab rows and runs the Megatron
  column/row pairs (``nn/tensor_parallel.py``: the loss on logits split on
  the vocab, K1f/K1b on the slice);
- a parameter passed as a slice smaller than the layer's parameter is an
  fsdp shard: gathered over the fsdp line before its layer runs and again
  for its backward, its gradient reduce-scattered
  (:class:`~tpu_dist_torch.parallel.fsdp.Gatherer`);
- the step's gradient sync averages each leaf over the ranks that hold the
  same piece of it and see other rows: the expert bank of a layer that
  holds a slice of its experts over its ``data`` line; under a ``model`` or
  fsdp axis every leaf over its ``data`` line (the model line's ranks hold
  equal gradients of a replicated leaf: the combines make them so); with
  neither, a replicated leaf over the world.  The layers and the shapes say
  which leaves those are, not the names.

Each rank of an expert, model or fsdp line holds the same rows (the batch
is split over ``data`` only), so its loss is the global mean's term for
those rows; the average of the ranks' gradients is the global step's
gradient.

Attention keeps the port's dispatch (K2f/K2b on the card at 1024 positions
and more, on a rank's local heads under a model axis).  The JAX step forces
dense attention because XLA's partitioner cannot cut a Pallas call; a
per-rank torch program has no such limit, and the CPU tests hold the port's
attention to JAX's dense attention within tolerance.
"""

from __future__ import annotations

import contextlib
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
    dim; an unmatched leaf gets ``()``, replicated.  ``binding``: the rule
    table the pairs came from (``partition_pairs(binding)``), which lets
    :func:`shard_pytree` slice a factored dim by its factor (the fused
    qkv); None slices every split dim in contiguous blocks."""

    def __init__(self, rules: Sequence[Tuple[str, tuple]],
                 binding: Optional[dict] = None):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
        self.binding = binding

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
# vocab), from the rule plane
TRANSFORMER_TP_RULES = PartitionRules(_rules.partition_pairs(),
                                      binding=_rules.DEFAULT_RULES)

# expert parallelism over an 'expert' axis: every stacked MoE leaf
# (w1/b1/w2/b2, leading dim the experts) splits its expert dim; the router
# and everything else replicate
MOE_EP_RULES = PartitionRules(_rules.partition_pairs({"expert": "expert"}),
                              binding={"expert": "expert"})


def _parts(keys, dim: int, axis: str, binding) -> int:
    """How many equal groups dim ``dim`` of the leaf at ``keys`` holds
    before the factor that ``binding`` puts on ``axis`` (3 for the fused
    qkv's ``qkv3``), each split separately; 1 without a layout."""
    if binding is None:
        return 1
    m = _rules._KEY_RE.match(_keystr(keys))
    lay = None if m is None else _rules.layout_for(m.group(1), m.group(2))
    if lay is None or dim >= len(lay.dims):
        return 1
    factors = lay.dims[dim]
    for j, f in enumerate(factors):
        if binding.get(f) == axis:
            from ..nn.tensor_parallel import _FIXED
            return int(np.prod([_FIXED[g] for g in factors[:j]],
                               dtype=np.int64))
    return 1


def _slice(leaf, spec: tuple, mesh, keys=(), binding=None):
    """This rank's slice of ``leaf`` by ``spec`` (a copy); a dim that
    ``binding``'s layout factors is split by its factor."""
    if not isinstance(leaf, torch.Tensor):
        leaf = np.asarray(leaf)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        line = mesh.axis_group(axis)
        parts = _parts(keys, dim, axis, binding)
        n = leaf.shape[dim]
        if n % (parts * line.size):
            raise _rules.ShardLayoutError(
                f"dim {dim} of {tuple(leaf.shape)} does not split over the "
                f"{line.size} ranks of mesh axis {axis!r}")
        per = n // parts // line.size
        shape = leaf.shape[:dim] + (parts, n // parts) + leaf.shape[dim + 1:]
        index = (slice(None),) * (dim + 1) + (
            slice(line.index * per, (line.index + 1) * per),)
        leaf = leaf.reshape(shape)[index]
        leaf = leaf.reshape(leaf.shape[:dim] + (parts * per,)
                            + leaf.shape[dim + 2:])
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    return leaf.copy()


def shard_pytree(tree, mesh=None, rules: Optional[PartitionRules] = None):
    """This rank's slice of every leaf of ``tree`` (tensors or numpy arrays;
    ``None`` passes through) on ``mesh`` (a port process group; default:
    the default group) by ``rules`` (default: replicate everything).  Each
    slice is a copy, never a view of the leaf.  The specs are the JAX
    package's, so a tree under :data:`TRANSFORMER_TP_RULES` is in the JAX
    layouts (``interop`` maps a port model's slices to torch's)."""
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
        return None if leaf is None else _slice(leaf, spec, mesh, keys,
                                                rules.binding)

    return _tree_map(place, tree)


def _bank_lines(moes) -> dict:
    """``{parameter name: the mesh line its gradient is averaged over}`` of
    the leaves not averaged over the world: the expert banks of every MoE
    layer that holds a slice of its experts, over its data line.  The
    layers decide (``MoELayer(expert_axis=)``), not the names."""
    return {f"{path}.{leaf}" if path else leaf: m.data_line
            for path, m in moes if m.local_experts < m.num_experts
            for leaf in ("w1", "b1", "w2", "b2")}


def _fsdp_leaves(model: torch.nn.Module, params: dict, line) -> dict:
    """``{name: dim}`` of the leaves of ``params`` passed as fsdp shards:
    smaller than the module's parameter in one dim, by the fsdp line's
    size.  The shapes decide, not the names."""
    shards = {}
    for k, v in params.items():
        want = tuple(model.get_parameter(k).shape)
        got = tuple(v.shape)
        if got == want:
            continue
        diff = [d for d in range(len(want)) if got[d] != want[d]]
        if (line is None or len(got) != len(want) or len(diff) != 1
                or got[diff[0]] * line.size != want[diff[0]]):
            raise ValueError(
                f"{k}: a slice {got} of the layer's {want} is not an fsdp "
                f"shard over "
                f"{'no fsdp axis' if line is None else line.size} ranks")
        shards[k] = diff[0]
    return shards


class _BatchLine:
    """A data line as a BatchNorm's ``process_group`` (``size()`` and
    ``torch_group``): the statistics are averaged over its ranks."""

    def __init__(self, line):
        self.torch_group = line.group
        self._size = line.size

    def size(self) -> int:
        return self._size


@torch.no_grad()
def _load_bn_state(bns, mstate) -> None:
    """Copy ``mstate``'s ``{path: {"mean", "var"}}`` into the BatchNorm
    layers' running buffers (a path it lacks keeps the layer's own)."""
    for path, m in bns:
        st = (mstate or {}).get(path)
        if st is None or not m.track_running_stats:
            continue
        m.running_mean.copy_(torch.as_tensor(st["mean"]))
        m.running_var.copy_(torch.as_tensor(st["var"]))


def make_gspmd_train_step(model: torch.nn.Module, loss_fn, optimizer,
                          aux_loss_coeff: float = 0.0,
                          compute_dtype=None) -> Callable:
    """Build the step: ``step(params, opt_state, x, y) -> (params,
    opt_state, metrics)``, or, for a model with MoE or BatchNorm layers
    (module state: aux losses, running statistics), ``step(params,
    opt_state, mstate, x, y) -> (params, opt_state, new_mstate,
    metrics)``.

    ``params`` are this rank's parameters by name (the module's own, or
    slices: :func:`shard_pytree`'s, ``interop``'s, or fsdp shards from
    :func:`~tpu_dist_torch.parallel.fsdp_shard`), updated in place;
    ``x``/``y`` this rank's rows of the global batch (its ``data`` shard;
    every rank of an expert, model or fsdp line passes the same rows).
    ``mstate`` is ``{path: {"aux_loss": scalar}}`` per MoE layer and
    ``{path: {"mean", "var"}}`` per BatchNorm.
    ``metrics``: ``loss`` (the global mean) and ``correct`` (the global
    count), device scalars.

    ``aux_loss_coeff`` weighs the sum of the MoE layers' aux losses in the
    objective, once.  ``compute_dtype`` runs the forward and backward in
    that dtype over the float32 parameters (the DDP's option; fsdp shards
    are gathered in it).  The mesh is the default group's (world 1 without
    one); the fsdp axis is its ``"fsdp"`` axis, else ``"data"``.

    BatchNorm takes the **global** batch's statistics, as the JAX step
    does (its program is written globally): each BatchNorm's mean and mean
    of squares are all-reduced over the data line (the layer's
    ``E[x²] − E[x]²`` in the compute dtype, differentiably), ``n`` counts
    every rank's rows, and the running statistics update alike on every
    rank.  A model with BatchNorm layers takes the stateful signature:
    ``mstate`` carries ``{path: {"mean", "var"}}`` for each (the JAX
    package's model state), loaded into the layers' buffers before the
    forward and read back after it."""
    from .. import dist
    from ..nn.layers import BatchNorm2d
    from ..nn.moe import MoELayer
    from .fsdp import Gatherer

    group = dist.get_default_group() if dist.is_initialized() else None
    bns = [(p, m) for p, m in model.named_modules()
           if isinstance(m, BatchNorm2d)]
    moes = [(p, m) for p, m in model.named_modules()
            if isinstance(m, MoELayer)]
    axes = () if group is None else group.axis_names
    data = (group.axis_group(dist.DATA_AXIS)
            if dist.DATA_AXIS in axes else None)
    fsdp_axis = "fsdp" if "fsdp" in axes else dist.DATA_AXIS
    fsdp = group.axis_group(fsdp_axis) if fsdp_axis in axes else None
    none = dist.AxisGroup("none", 1, 0, ())
    # the ranks a replicated leaf is averaged over: those that see other
    # rows (under a model or fsdp axis the others hold equal gradients)
    if group is None:
        world = none
    elif "model" in axes or "fsdp" in axes:
        world = data or none
    else:
        world = dist.AxisGroup("world", group.size(), group.rank,
                               tuple(range(group.size())), group.torch_group)
    lines = _bank_lines(moes)
    gatherers: dict = {}

    def gatherer(shards: dict):
        key = tuple(sorted(shards.items()))
        if key not in gatherers:
            for g in gatherers.values():
                g.remove()
            gatherers.clear()
            gatherers[key] = Gatherer(model, shards, fsdp)
        return gatherers[key]

    def sync_of(k: str, shards: dict):
        """``(line summed over, divisor)`` of leaf ``k``'s gradient.  An
        fsdp shard's arrives summed over the fsdp line (its gather's
        reduce-scatter): over ``data`` that is the whole sum; over an
        ``fsdp`` axis whose ranks see the same rows, it is summed over the
        data line too and divided by both."""
        if k not in shards:
            line = lines.get(k, world)
            return line, line.size
        if fsdp_axis == dist.DATA_AXIS:
            return none, fsdp.size
        line = data or none
        return line, line.size * fsdp.size

    @torch.no_grad()
    def average(grads: Dict[str, torch.Tensor], shards: dict):
        """Each gradient averaged over its line, one flat all-reduce per
        line, divisor and dtype."""
        out = dict(grads)
        buckets: Dict[tuple, list] = {}
        for k in grads:
            line, div = sync_of(k, shards)
            if div > 1:
                buckets.setdefault((line, div, grads[k].dtype),
                                   []).append(k)
        for (line, div, _), names in buckets.items():
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            if line.size > 1:
                torch.distributed.all_reduce(flat, group=line.group)
            # a 0-d device divisor: the card divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            flat /= torch.tensor(float(div), dtype=flat.dtype,
                                 device=flat.device)
            for k, v in zip(names, flat.split([grads[k].numel()
                                               for k in names])):
                out[k] = v.view_as(grads[k])
        return out

    bn_line = _BatchLine(data) if data is not None and data.size > 1 \
        else None

    def run(params, opt_state, x, y, mstate=None):
        model.train()
        if bns:
            _load_bn_state(bns, mstate)
        saved = [m.process_group for _, m in bns]
        for _, m in bns:
            m.process_group = bn_line
        try:
            return _run(params, opt_state, x, y)
        finally:
            for (_, m), g in zip(bns, saved):
                m.process_group = g

    def _run(params, opt_state, x, y):
        shards = _fsdp_leaves(model, params, fsdp)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        scope = (gatherer(shards).active() if shards
                 else contextlib.nullcontext())
        with torch.enable_grad(), scope:
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
            grads = average(dict(zip(leaves, grads)), shards)
            loss = loss.detach().float()
            correct = (out.argmax(-1) == y).sum()
            if data is not None and data.size > 1:
                for t in (loss, correct):
                    torch.distributed.all_reduce(t, group=data.group)
                loss /= data.size
            new_params, new_opt = optimizer.update(grads, opt_state, params)
            mstate = {p: {"aux_loss": m.aux_loss.detach().to(
                torch.float32, copy=True)} for p, m in moes}
            mstate.update({p: {"mean": m.running_mean.detach().clone(),
                               "var": m.running_var.detach().clone()}
                           for p, m in bns if m.track_running_stats})
        return new_params, new_opt, mstate, {"loss": loss, "correct": correct}

    if moes or bns:
        def stateful_step(params, opt_state, mstate, x, y):
            return run(params, opt_state, x, y, mstate)
        return stateful_step

    def stateless_step(params, opt_state, x, y):
        new_params, new_opt, _, metrics = run(params, opt_state, x, y)
        return new_params, new_opt, metrics
    return stateless_step
