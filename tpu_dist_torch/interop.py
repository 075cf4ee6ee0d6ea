"""Weights from the JAX package — counterpart of ``tpu_dist/interop.py``.

:func:`load_jax_params` loads a ``tpu_dist`` parameter tree
``{module_path: {leaf: array}}`` (numpy arrays, or anything ``np.asarray``
takes) into a port module; :func:`jax_params` gives a port module's
parameters back in that tree and those layouts.  Module paths are the same
in both packages; the layouts differ by module class:

====================  ======================  ==========================
module                tpu_dist layout         tpu_dist_torch layout
====================  ======================  ==========================
Linear weight         (in, out)               (out, in)
MultiheadSelfAttn     qkv_weight (d, 3d)      qkv_weight (3d, d)
                      out_weight (d, d)       out_weight (d, d), .T
Embedding, LayerNorm, identical               identical
RMSNorm
ViT tokens            class_token, pos_embed- identical
                      ding (1, n, d)
Conv2d weight         HWIO (kh, kw, in, out)  OIHW, ``transpose(3, 2, 0, 1)``
BatchNorm2d           weight, bias            identical
Linear after a        (h*w*c, out): NHWC      (out, c*h*w): NCHW flattens
flattened map         flattens (h, w, c)      (c, h, w); the rows permute
                                              (:func:`flatten_linear_to_torch`)
MoELayer              router (d, E)           router (d, E)
                      w1 (E, d, h), b1 (E, h) identical
                      w2 (E, h, d), b2 (E, d) identical
MoELayer under an      w1, b1, w2, b2 (E, ...) this rank's E/ep rows
expert axis
MoELayer state        aux_loss                not a parameter: skipped
QuantLinear           q_weight (in, out) int8 q_weight (out, in) int8
                      scale (out,)            identical
QuantMultiheadSelf-   qkv_q (d, 3d) int8      qkv_q (3d, d) int8
Attention             out_q (d, d) int8       out_q (d, d) int8, .T
                      qkv_scale, out_scale    identical
QuantEmbedding        q_weight, scale         identical
====================  ======================  ==========================

int8 leaves load as int8; every other leaf goes through float32 into the
parameter's dtype.  A rope model has no ``pos`` table on either side, and
an ``nn.Remat`` keeps its module's leaves under ``inner.`` on both.

A MoE layer built with an ``expert_axis`` (``nn/moe.py``) holds its
rank's slice of each expert bank: :func:`load_jax_params` takes the layer's
own rows (``first_expert``, ``local_experts``) from the full JAX tree, and
:func:`jax_params` all-gathers the banks over the expert line (every rank
of the line calls it), so both trees are the unsplit model's.

A model split over a model axis (``TransformerLM(model_axis=)``,
``nn/tensor_parallel.py``) holds its rank's slices: :func:`load_jax_params`
takes them from the full JAX tree by ``parallel.TRANSFORMER_TP_RULES``
(``shard_pytree``: the fused qkv's ``[q_r | k_r | v_r]`` columns), and
:func:`jax_params` gathers them back over the model line.  Under FSDP the
step's parameters are shards (``parallel/fsdp.py``):
:func:`shard_jax_params` slices a JAX tree for this rank exactly as the
JAX placement does (the tp rules first, then ``fsdp_specs``), and
``jax_params(model, params)`` gathers them back over the fsdp line.

A Linear whose input is a flattened (c, h, w) feature map is named in its
model's ``flattened_inputs`` (``ConvNet.flattened_inputs = {"fc1": (128, 4,
4)}``): a plain transpose would give the right shape and the wrong columns.

Module state: the JAX package keeps each BatchNorm's running statistics in
its ``model_state`` as ``{path: {"mean", "var"}}``; the port keeps them in
the layer's ``running_mean``/``running_var`` buffers, and its DDP
``TrainState.model_state`` has the JAX layout.  :func:`load_jax_state`
copies a JAX state in, :func:`jax_state` gives the port's out as numpy.

Optimizer state: :func:`load_jax_opt_state` carries a JAX optimizer's (or
EMA's) state over, its per-parameter trees through the same layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nn

__all__ = ["load_jax_params", "jax_params", "shard_jax_params",
           "load_jax_opt_state", "load_jax_pipe_params", "jax_pipe_params",
           "load_jax_state", "jax_state", "jax_leaf_order",
           "flatten_linear_from_torch", "flatten_linear_to_torch"]

_TRANSPOSED = {nn.Linear: ("weight",),
               nn.MultiheadSelfAttention: ("qkv_weight", "out_weight"),
               nn.QuantLinear: ("q_weight",),
               nn.QuantMultiheadSelfAttention: ("qkv_q", "out_q")}


def _join(path: str, leaf: str) -> str:
    return f"{path}.{leaf}" if path else leaf


def jax_leaf_order(names):
    """Parameter names (``block0.attn.qkv_weight``) in the order
    ``jax.tree.leaves`` visits the JAX package's tree ``{module_path:
    {leaf: array}}``: sorted by module path, then by leaf name — which is
    not the sorted order of the dotted names (``a.bz`` comes before
    ``a.b.c``)."""
    return sorted(names, key=lambda k: (k.rpartition(".")[0],
                                        k.rpartition(".")[2]))


def flatten_linear_from_torch(c: int, h: int, w: int):
    """The JAX layout of a Linear weight whose input is a flattened
    feature map: torch's (out, c*h*w), in NCHW flatten order, to the JAX
    package's (h*w*c, out), in NHWC flatten order."""
    def f(t: np.ndarray) -> np.ndarray:
        out = t.shape[0]
        return (t.reshape(out, c, h, w).transpose(2, 3, 1, 0)
                .reshape(h * w * c, out))
    return f


def flatten_linear_to_torch(c: int, h: int, w: int):
    """Inverse of :func:`flatten_linear_from_torch`: the JAX package's
    (h*w*c, out) to torch's (out, c*h*w)."""
    def f(a: np.ndarray) -> np.ndarray:
        out = a.shape[1]
        return (a.reshape(h, w, c, out).transpose(3, 2, 0, 1)
                .reshape(out, c * h * w))
    return f


def _layouts(model: torch.nn.Module) -> dict:
    """``{parameter key: transform}`` for every leaf whose JAX layout is not
    torch's."""
    out, flattened = {}, {}
    for path, mod in model.named_modules():
        for cls, leaves in _TRANSPOSED.items():
            if isinstance(mod, cls):
                for leaf in leaves:
                    out[_join(path, leaf)] = np.transpose
        if isinstance(mod, nn.Conv2d):
            out[_join(path, "weight")] = lambda a: a.transpose(3, 2, 0, 1)
        for sub, chw in getattr(mod, "flattened_inputs", {}).items():
            flattened[_join(_join(path, sub), "weight")] = \
                flatten_linear_to_torch(*chw)
    # a flattened input's permutation replaces the Linear's plain transpose
    return {**out, **flattened}


def _inverse_layouts(model: torch.nn.Module) -> dict:
    """``{parameter key: transform}`` from torch's layout to the JAX
    package's, for every leaf whose layouts differ (:func:`_layouts`'
    inverse)."""
    inverse, flattened = {}, {}
    for path, mod in model.named_modules():
        for cls, leaves in _TRANSPOSED.items():
            if isinstance(mod, cls):
                for leaf in leaves:
                    inverse[_join(path, leaf)] = np.transpose
        if isinstance(mod, nn.Conv2d):
            inverse[_join(path, "weight")] = lambda a: a.transpose(2, 3, 1, 0)
        for sub, chw in getattr(mod, "flattened_inputs", {}).items():
            flattened[_join(_join(path, sub), "weight")] = \
                flatten_linear_from_torch(*chw)
    return {**inverse, **flattened}


def _copy_tree(model: torch.nn.Module, ours: dict, params) -> None:
    """Copy a JAX per-parameter tree ``{module_path: {leaf: array}}`` into
    ``ours`` (``{parameter key: tensor}`` laid out as ``model``'s
    parameters) in place, through the layouts of ``model``'s modules."""
    # aux_loss is MoE module state, never a parameter (a tree that merges
    # the JAX state in may carry it)
    theirs = {_join(path, leaf): np.asarray(a)
              for path, leaves in params.items() for leaf, a in leaves.items()
              if leaf != "aux_loss"}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise KeyError(f"parameter trees do not match: missing keys "
                       f"{missing}, unexpected keys {extra}")
    layouts = _layouts(model)
    for key, p in ours.items():
        a = layouts[key](theirs[key]) if key in layouts else theirs[key]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{key}: JAX shape {theirs[key].shape} does not "
                             f"map to {tuple(p.shape)}")
        if p.dtype == torch.int8 and a.dtype != np.int8:
            raise ValueError(f"{key}: an int8 parameter takes an int8 leaf, "
                             f"got {a.dtype}")
        a = np.ascontiguousarray(
            a, dtype=np.int8 if a.dtype == np.int8 else np.float32)
        p.copy_(torch.tensor(a).to(p.dtype))


def _split_moes(model: torch.nn.Module) -> list:
    """``(path, layer)`` of every MoE layer that holds a slice of its
    experts."""
    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, nn.MoELayer)
            and m.local_experts < m.num_experts]


def _tp_splits(model: torch.nn.Module) -> list:
    """``(path, layer)`` of every layer split over a model axis."""
    return [(path, m) for path, m in model.named_modules()
            if getattr(m, "tp", None) is not None]


def _tp_rules(model: torch.nn.Module):
    """The JAX placement of ``model``'s model axis
    (``TRANSFORMER_TP_RULES``, its ``"model"`` read as the axis's name),
    or None for an unsplit model."""
    split = _tp_splits(model)
    if not split:
        return None
    from .parallel import gspmd, rules
    axis = split[0][1].tp.line.name
    binding = {k: (axis if v == "model" else v)
               for k, v in rules.DEFAULT_RULES.items()}
    return gspmd.PartitionRules(rules.partition_pairs(binding),
                                binding=binding)


def _expert_rows(model: torch.nn.Module, params) -> dict:
    """``params`` (a full JAX tree) with each split MoE layer's banks cut
    to this rank's experts."""
    split = _split_moes(model)
    if split:
        params = {path: dict(leaves) for path, leaves in params.items()}
        for path, m in split:
            rows = slice(m.first_expert, m.first_expert + m.local_experts)
            for leaf in ("w1", "b1", "w2", "b2"):
                params[path][leaf] = np.asarray(params[path][leaf])[rows]
    return params


def _local_tree(model: torch.nn.Module, params) -> dict:
    """``params`` (a full JAX tree) cut to this rank's layers: each split
    MoE layer's rows, each tensor-parallel layer's slices."""
    params = _expert_rows(model, params)
    tp = _tp_rules(model)
    if tp is not None:
        from .parallel import shard_pytree
        params = shard_pytree(
            {path: {leaf: np.asarray(a) for leaf, a in leaves.items()}
             for path, leaves in params.items()}, None, tp)
    return params


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters in place (keeping their
    dtype and device) and return ``model``; under an expert axis each
    expert bank's slice of this rank, under a model axis each split
    layer's.  Raises ``KeyError`` on any missing or extra key and
    ``ValueError`` on a shape that does not map or a non-int8 leaf for an
    int8 parameter."""
    _copy_tree(model, dict(model.named_parameters()),
               _local_tree(model, params))
    return model


@torch.no_grad()
def shard_jax_params(model: torch.nn.Module, params, axis: str = "data",
                     min_size: int = 2 ** 12, mesh=None) -> dict:
    """This rank's FSDP parameters ``{name: tensor}`` of ``model`` (on its
    parameters' device and dtype, torch layouts) from a full JAX tree: the
    JAX placement's slices, by ``parallel.fsdp_specs(tree, mesh, axis,
    min_size, rules=TRANSFORMER_TP_RULES)`` on a model split over a model
    axis (its tp slices keep their axis and gain ``axis`` on their largest
    free dim) and by ``fsdp_specs`` alone otherwise.  Pass the result to
    ``parallel.make_gspmd_train_step``'s step."""
    from .parallel import fsdp_shard, fsdp_specs
    tree = _expert_rows(model, {
        path: {leaf: np.asarray(a, dtype=np.float32)
               for leaf, a in leaves.items() if leaf != "aux_loss"}
        for path, leaves in params.items()})
    rules = _tp_rules(model)
    specs = fsdp_specs(tree, mesh, axis, min_size, rules=rules)
    sliced = fsdp_shard(tree, mesh, axis, specs=specs, rules=rules)
    layouts = _layouts(model)
    ours = dict(model.named_parameters())
    out = {}
    for key, p in ours.items():
        path, _, leaf = key.rpartition(".")
        a = sliced[path][leaf]
        a = layouts[key](a) if key in layouts else a
        out[key] = torch.tensor(np.ascontiguousarray(a)).to(p.device,
                                                           p.dtype)
    return out


@torch.no_grad()
def jax_params(model: torch.nn.Module, params=None) -> dict:
    """``model``'s parameters as a JAX package tree ``{module_path: {leaf:
    array}}`` in the JAX layouts — the inverse of :func:`load_jax_params`,
    as host numpy (int8 leaves int8, every other leaf float32); the whole
    expert banks under an expert axis and the whole leaves of a split
    layer under a model axis (collectives over the lines: call it on
    every rank).  ``params``: the step's parameters by name in place of the
    module's; FSDP shards among them (smaller than their parameter) are
    gathered over the step's fsdp axis (the default group's ``"fsdp"``
    axis, else ``"data"``)."""
    inverse = _inverse_layouts(model)
    ours = dict(model.named_parameters())
    if params is not None:
        from . import dist
        from .parallel.fsdp import gather_dim
        ours = {k: v.detach() for k, v in params.items()}
        for k, v in ours.items():
            want = tuple(model.get_parameter(k).shape)
            if tuple(v.shape) != want:
                axis = ("fsdp" if "fsdp" in
                        dist.get_default_group().axis_names
                        else dist.DATA_AXIS)
                d = next(i for i, (a, b) in enumerate(zip(v.shape, want))
                         if a != b)
                ours[k] = gather_dim(v, dist.axis_group(axis), d)
    banks = {}
    for path, m in _split_moes(model):
        from .collectives import ops
        for leaf in ("w1", "b1", "w2", "b2"):
            banks[_join(path, leaf)] = ops.all_gather(
                ours[_join(path, leaf)].detach(), m.expert_line, tiled=True)
    for path, m in _tp_splits(model):
        for leaf in m.tp.leaves:
            key = _join(path, leaf)
            banks[key] = m.tp.gather(leaf, ours[key].detach())
    out: dict = {}
    for key, p in ours.items():
        path, _, leaf = key.rpartition(".")
        t = banks.get(key, p).detach().cpu()
        a = (t.numpy() if t.dtype == torch.int8
             else t.to(torch.float32).numpy())
        if key in inverse:
            a = inverse[key](a)
        out.setdefault(path, {})[leaf] = np.ascontiguousarray(a)
    return out


def _check_stages(pp, packed) -> None:
    """``packed``'s stacked stage leaves must hold ``pp``'s stage count."""
    for canon, leaves in packed["stages"].items():
        for leaf, a in leaves.items():
            n = np.shape(a)[0] if np.ndim(a) else None
            if n != pp.num_stages:
                raise ValueError(
                    f"stages.{canon}.{leaf}: a stacked stage axis of {n} "
                    f"does not map to {pp.num_stages} pipeline stages")


@torch.no_grad()
def load_jax_pipe_params(pp, params, step: int = 0):
    """A rank's :class:`~tpu_dist_torch.parallel.PipeTrainState` for
    :class:`~tpu_dist_torch.parallel.PipelineParallel` ``pp`` from a JAX
    ``PipeTrainState.params`` (``{"repl", "stages"}``, numpy, the stage
    leaves stacked on a leading axis of ``pp.num_stages``): the whole tree
    goes into ``pp.model`` through :func:`load_jax_params` as ``pp.init``'s
    ``init_params`` (``KeyError`` on a missing or extra key, ``ValueError``
    on a shape that does not map), and this rank keeps its stage row and
    the repl leaves, with a fresh optimizer state."""
    _check_stages(pp, params)
    state = pp.init(init_params=lambda model: load_jax_params(
        model, pp.unpack_params(params)))
    return state._replace(step=step)


@torch.no_grad()
def jax_pipe_params(pp, state) -> dict:
    """The JAX package's packed ``{"repl", "stages"}`` tree (numpy float32,
    JAX layouts, stage leaves stacked over every stage) of a rank's
    ``PipeTrainState``: gathered over the pipe line (every rank of the line
    calls it) — the inverse of :func:`load_jax_pipe_params`."""
    whole = pp.unpack_params(pp.gather_params(state))
    inverse = _inverse_layouts(pp.model)
    out = {}
    for path, leaves in whole.items():
        for leaf, a in leaves.items():
            key = _join(path, leaf)
            a = np.asarray(a, dtype=np.float32)
            out.setdefault(path, {})[leaf] = np.ascontiguousarray(
                inverse[key](a) if key in inverse else a)
    return pp.pack_params(out)


@torch.no_grad()
def load_jax_opt_state(optimizer, jax_opt_state, model: torch.nn.Module):
    """The port's state of ``optimizer`` (or of an :class:`~tpu_dist_torch.
    optim.EMA`) for ``model``'s parameters, carried over from a JAX
    package's state of its counterpart: a new state from
    ``optimizer.init``, each per-parameter tree (``momentum``, ``m``,
    ``v``, ``square_avg``, ``sum``, ``shadow``, ...) mapped exactly as
    :func:`load_jax_params` maps the parameters, each scalar (``step``)
    taken as it is in the port's dtype.  Raises ``KeyError`` on a missing
    or extra key and ``ValueError`` on a mismatched shape."""
    state = optimizer.init(dict(model.named_parameters()))
    missing = sorted(set(state) - set(jax_opt_state))
    extra = sorted(set(jax_opt_state) - set(state))
    if missing or extra:
        raise KeyError(f"optimizer states do not match: missing keys "
                       f"{missing}, unexpected keys {extra}")
    for key, ours in state.items():
        if isinstance(ours, dict):
            _copy_tree(model, ours, jax_opt_state[key])
            continue
        a = np.asarray(jax_opt_state[key])
        if a.shape != tuple(ours.shape):
            raise ValueError(f"{key}: JAX shape {a.shape} does not match "
                             f"{tuple(ours.shape)}")
        ours.copy_(torch.from_numpy(a.copy()).to(ours.dtype))
    return state


def _bn_layers(model: torch.nn.Module) -> dict:
    return {path: m for path, m in model.named_modules()
            if isinstance(m, nn.BatchNorm2d) and m.track_running_stats}


@torch.no_grad()
def load_jax_state(model: torch.nn.Module, state) -> torch.nn.Module:
    """Copy a JAX ``model_state`` (``{path: {"mean", "var"}}`` for each
    BatchNorm; MoE ``aux_loss`` leaves are skipped) into ``model``'s running
    statistics in place and return ``model``.  Raises ``KeyError`` on a
    missing or extra BatchNorm path and ``ValueError`` on a shape that
    does not match."""
    ours = _bn_layers(model)
    theirs = {p: v for p, v in state.items() if "aux_loss" not in v}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise KeyError(f"state trees do not match: missing paths {missing}, "
                       f"unexpected paths {extra}")
    for path, m in ours.items():
        for leaf, buf in (("mean", m.running_mean), ("var", m.running_var)):
            a = np.asarray(theirs[path][leaf], dtype=np.float32)
            if a.shape != tuple(buf.shape):
                raise ValueError(f"{path}.{leaf}: JAX shape {a.shape} does "
                                 f"not match {tuple(buf.shape)}")
            buf.copy_(torch.tensor(a))
    return model


def jax_state(model: torch.nn.Module) -> dict:
    """A copy of ``model``'s BatchNorm running statistics in the JAX
    package's ``model_state`` layout, ``{path: {"mean", "var"}}``, as float32
    numpy."""
    return {path: {"mean": m.running_mean.detach().cpu().numpy().copy(),
                   "var": m.running_var.detach().cpu().numpy().copy()}
            for path, m in _bn_layers(model).items()}
