"""Module system — counterpart of ``tpu_dist/nn/module.py``.

The JAX package builds its own functional module tree; the port uses
``torch.nn.Module`` as it is.  ``Sequential`` names its children ``0``,
``1``, ``2``…, so parameter paths match the JAX ones (``block0.mlp.0``) and
``interop.load_jax_params`` can key on them.  Parameters live on the
modules; :func:`reset_parameters` re-draws every port leaf's parameters (and
resets its state, such as BatchNorm's running statistics) from one explicit
generator (the JAX package's ``Module.init(key)`` and ``init_state()``).

Randomness inside a forward (dropout) comes from :func:`rng_scope`, the
counterpart of ``apply(..., rng=key)``: the ``i``-th call of
:func:`next_rng` in the scope returns ``fold_in(key, i)``, as the JAX
package's apply context does."""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.nn import Module, Sequential

__all__ = ["Module", "Sequential", "reset_parameters", "rng_scope",
           "next_rng"]

_TLS = threading.local()


def reset_parameters(module: Module, generator: torch.Generator) -> None:
    """Re-initialize, in ``named_modules`` order, every submodule that owns
    parameters or buffers directly, from ``generator``.  Deterministic given
    the generator's seed and the module tree."""
    for _, mod in module.named_modules():
        if mod._parameters or mod._buffers:
            mod.reset_parameters(generator)


class _Rng:
    def __init__(self, key):
        self._key = key
        self.count = 0

    @property
    def key(self):
        # a callable key is made at first use: the threefry passes that
        # derive it cost launches a model without dropout never needs
        if callable(self._key):
            self._key = self._key()
        return self._key


@contextlib.contextmanager
def rng_scope(key):
    """Make ``key`` (a JAX key's data, int64 ``(2,)``, or a callable that
    returns one) the source of :func:`next_rng` for the forwards run inside
    the scope, on this thread."""
    outer = getattr(_TLS, "rng", None)
    _TLS.rng = _Rng(key)
    try:
        yield
    finally:
        _TLS.rng = outer


def next_rng():
    """The next key of the current :func:`rng_scope`: ``fold_in(key, i)``
    for its ``i``-th call.  Raises outside a scope."""
    from .. import random
    rng = getattr(_TLS, "rng", None)
    if rng is None:
        raise ValueError(
            "a module asked for randomness (dropout) in training mode "
            "outside nn.rng_scope(key); the DDP train step opens one")
    key = random.fold_in(rng.key, rng.count)
    rng.count += 1
    return key
