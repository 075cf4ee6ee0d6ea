"""Weights from the JAX package — counterpart of ``tpu_dist/interop.py``.

:func:`load_jax_params` loads a ``tpu_dist`` parameter tree
``{module_path: {leaf: array}}`` (numpy arrays, or anything ``np.asarray``
takes) into a port module.  Module paths are the same in both packages; the
layouts differ by module class:

====================  ======================  ==========================
module                tpu_dist layout         tpu_dist_torch layout
====================  ======================  ==========================
Linear weight         (in, out)               (out, in)
MultiheadSelfAttn     qkv_weight (d, 3d)      qkv_weight (3d, d)
                      out_weight (d, d)       out_weight (d, d), .T
Embedding, LayerNorm  identical               identical
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
MoELayer state        aux_loss                not a parameter: skipped
QuantLinear           q_weight (in, out) int8 q_weight (out, in) int8
                      scale (out,)            identical
QuantMultiheadSelf-   qkv_q (d, 3d) int8      qkv_q (3d, d) int8
Attention             out_q (d, d) int8       out_q (d, d) int8, .T
                      qkv_scale, out_scale    identical
QuantEmbedding        q_weight, scale         identical
====================  ======================  ==========================

int8 leaves load as int8; every other leaf goes through float32 into the
parameter's dtype.

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

__all__ = ["load_jax_params", "load_jax_opt_state", "load_jax_state",
           "jax_state", "flatten_linear_from_torch",
           "flatten_linear_to_torch"]

_TRANSPOSED = {nn.Linear: ("weight",),
               nn.MultiheadSelfAttention: ("qkv_weight", "out_weight"),
               nn.QuantLinear: ("q_weight",),
               nn.QuantMultiheadSelfAttention: ("qkv_q", "out_q")}


def _join(path: str, leaf: str) -> str:
    return f"{path}.{leaf}" if path else leaf


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


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters in place (keeping their
    dtype and device) and return ``model``.  Raises ``KeyError`` on any
    missing or extra key and ``ValueError`` on a shape that does not map
    or a non-int8 leaf for an int8 parameter."""
    _copy_tree(model, dict(model.named_parameters()), params)
    return model


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
