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
====================  ======================  ==========================
"""

from __future__ import annotations

import numpy as np
import torch

from . import nn

__all__ = ["load_jax_params"]

_TRANSPOSED = {nn.Linear: ("weight",),
               nn.MultiheadSelfAttention: ("qkv_weight", "out_weight")}


def _join(path: str, leaf: str) -> str:
    return f"{path}.{leaf}" if path else leaf


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters in place (keeping their
    dtype and device) and return ``model``.  Raises ``KeyError`` on any
    missing or extra key and ``ValueError`` on a shape that does not map."""
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
        p.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                .to(p.dtype))
    return model
