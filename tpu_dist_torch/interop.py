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
"""

from __future__ import annotations

import numpy as np
import torch

from . import nn

__all__ = ["load_jax_params"]

_TRANSPOSED = {nn.Linear: ("weight",),
               nn.MultiheadSelfAttention: ("qkv_weight", "out_weight"),
               nn.QuantLinear: ("q_weight",),
               nn.QuantMultiheadSelfAttention: ("qkv_q", "out_q")}


def _join(path: str, leaf: str) -> str:
    return f"{path}.{leaf}" if path else leaf


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters in place (keeping their
    dtype and device) and return ``model``.  Raises ``KeyError`` on any
    missing or extra key and ``ValueError`` on a shape that does not map
    or a non-int8 leaf for an int8 parameter."""
    ours = dict(model.named_parameters())
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
    transposed = {_join(path, leaf)
                  for path, mod in model.named_modules()
                  for cls, leaves in _TRANSPOSED.items()
                  if isinstance(mod, cls) for leaf in leaves}
    for key, p in ours.items():
        a = theirs[key].T if key in transposed else theirs[key]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{key}: JAX shape {theirs[key].shape} does not "
                             f"map to {tuple(p.shape)}")
        if p.dtype == torch.int8 and a.dtype != np.int8:
            raise ValueError(f"{key}: an int8 parameter takes an int8 leaf, "
                             f"got {a.dtype}")
        a = np.ascontiguousarray(
            a, dtype=np.int8 if a.dtype == np.int8 else np.float32)
        p.copy_(torch.tensor(a).to(p.dtype))
    return model
