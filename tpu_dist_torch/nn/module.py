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
package's apply context does.

:func:`checkpoint` and :class:`Remat` recompute a module's activations in
backward (``torch.utils.checkpoint``), the counterpart of ``jax.checkpoint``
and ``nn.Remat``."""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.nn import Module, Sequential

__all__ = ["Module", "Sequential", "reset_parameters", "rng_scope",
           "next_rng", "checkpoint", "Remat"]

_TLS = threading.local()


def reset_parameters(module: Module, generator: torch.Generator) -> None:
    """Re-initialize, in ``named_modules`` order, every submodule that owns
    parameters or buffers directly, from ``generator``.  Deterministic given
    the generator's seed and the module tree; a layer split over a model
    axis draws its whole parameters and keeps its slice."""
    for _, mod in module.named_modules():
        if mod._parameters or mod._buffers:
            split = getattr(mod, "tp", None)
            if split is None:
                mod.reset_parameters(generator)
            else:  # split over a model axis: the unsplit layer's draws
                split.reset(mod, generator)


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


def checkpoint(module: Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations recomputed in
    backward instead of kept: ``torch.utils.checkpoint`` (non-reentrant),
    made to replay the first forward exactly, as ``jax.checkpoint`` does.

    - The tensors the module holds at the call (under ``functional_call``,
      the caller's: the DDP's compute-dtype casts) are inputs of the
      checkpointed function and bound again for the recompute, which runs
      in backward, after any ``functional_call`` around this one has
      ended.
    - The recompute draws the same keys from the first forward's
      :func:`rng_scope` (dropout masks are equal).
    - What the first forward left behind stays: the attributes a module
      lists in ``forward_state`` (MoE ``aux_loss``, ``routing``) and every
      buffer (BatchNorm statistics, updated in place) are put back after
      the recompute, so a reader after backward sees the first forward's
      values, which the JAX package publishes once."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    params = dict(module.named_parameters())
    # buffers ride in the closure, not as inputs: a BatchNorm updates them
    # in place during the forward, which a saved input may not see
    buffers = dict(module.named_buffers())
    n_args = len(args)
    holders = [m for m in module.modules() if getattr(m, "forward_state", ())]
    rng = getattr(_TLS, "rng", None)
    rng_start = None if rng is None else rng.count
    first: list = []

    def run(*flat):
        bound = {**dict(zip(params, flat[n_args:])), **buffers}
        if not first:
            out = torch.func.functional_call(module, bound, flat[:n_args],
                                             kwargs)
            first.append([{a: getattr(m, a) for a in m.forward_state}
                          for m in holders])
            return out
        # the recompute, inside backward (it may stop early, once it has
        # recomputed every tensor backward needs)
        outer, kept = getattr(_TLS, "rng", None), None
        if rng is not None:
            kept, rng.count, _TLS.rng = rng.count, rng_start, rng
        saved = [t.clone() for t in buffers.values()]
        try:
            return torch.func.functional_call(module, bound, flat[:n_args],
                                              kwargs)
        finally:
            if rng is not None:
                rng.count = kept
            _TLS.rng = outer
            for m, state in zip(holders, first[0]):
                for a, v in state.items():
                    setattr(m, a, v)
            with torch.no_grad():
                for t, v in zip(buffers.values(), saved):
                    t.copy_(v)

    return _checkpoint(run, *args, *params.values(), use_reentrant=False)


class Remat(Module):
    """Activation checkpointing as a wrapper module — counterpart of the JAX
    package's ``nn.Remat``: ``Remat(module)(x)`` is ``module(x)`` with its
    activations recomputed in backward (:func:`checkpoint`), trading
    operations for memory.  Under ``torch.no_grad`` there is nothing to
    keep, and the module runs as it is.

    The wrapped module lives under ``inner``, so its parameter paths read
    ``<name>.inner.X`` as in the JAX package.  ``policy`` (which results
    ``jax.checkpoint`` may keep) has no ``torch.utils.checkpoint``
    counterpart; anything but ``None`` raises."""

    def __init__(self, module: Module, policy=None):
        super().__init__()
        if policy is not None:
            raise NotImplementedError(
                f"Remat(policy={policy!r}): torch.utils.checkpoint keeps no "
                f"chosen results, so only policy=None (recompute the whole "
                f"module) is ported (ROADMAP A-S)")
        self.inner = module
        self.policy = policy

    def forward(self, *args, **kwargs):
        if not torch.is_grad_enabled():
            return self.inner(*args, **kwargs)
        return checkpoint(self.inner, *args, **kwargs)
