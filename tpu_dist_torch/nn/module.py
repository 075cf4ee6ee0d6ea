"""Module system — counterpart of ``tpu_dist/nn/module.py``.

The JAX package builds its own functional module tree; the port uses
``torch.nn.Module`` as it is.  ``Sequential`` names its children ``0``,
``1``, ``2``…, so parameter paths match the JAX ones (``block0.mlp.0``) and
``interop.load_jax_params`` can key on them.  Parameters live on the
modules; :func:`reset_parameters` re-draws every port leaf's parameters from
one explicit generator (the JAX package's ``Module.init(key)``)."""

from __future__ import annotations

import torch
from torch.nn import Module, Sequential

__all__ = ["Module", "Sequential", "reset_parameters"]


def reset_parameters(module: Module, generator: torch.Generator) -> None:
    """Re-initialize, in ``named_modules`` order, every submodule that owns
    parameters directly, from ``generator``.  Deterministic given the
    generator's seed and the module tree."""
    for _, mod in module.named_modules():
        if mod._parameters:
            mod.reset_parameters(generator)
