"""DistributedDataParallel — counterpart of ``tpu_dist/parallel/ddp.py``.

The JAX package compiles forward, loss, gradient all-reduce and optimizer
update into one program under ``shard_map``.  The port runs the same step
eagerly: float32 master parameters (the module's own) are cast to
``compute_dtype`` for the forward and backward, the gradients land in float32
on the masters through the cast's backward, and with world > 1 they are
averaged over the group with ``torch.distributed.all_reduce`` before the
optimizer updates the masters in place.

``train_step`` consumes its state: the parameters and optimizer buffers are
updated in place (the JAX package donates them), and the returned
:class:`TrainState` holds the same tensors.

Module state: each :class:`~tpu_dist_torch.nn.MoELayer` keeps its last
load-balancing loss as its ``aux_loss`` attribute; the step collects it into
``model_state`` as ``{path: {"aux_loss": float32 scalar}}`` (averaged over
the group at world > 1), the JAX package's ``state[path]["aux_loss"]``.  As
there, it is reported, not added to the objective."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..nn.module import reset_parameters
from ..nn.moe import MoELayer

__all__ = ["TrainState", "DistributedDataParallel"]


class TrainState(NamedTuple):
    """Training state: ``params`` are the module's float32 master parameters
    by name; ``model_state`` holds ``{path: {"aux_loss": float32 scalar}}``
    for each MoE layer (the last step's value; zeros after ``init``) and is
    ``{}`` for a dense model; ``opt_state`` the optimizer's buffers; ``step``
    the update count."""
    params: Dict[str, torch.Tensor]
    model_state: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: int


class DistributedDataParallel:
    """Data-parallel training over a process group.

    Usage (the JAX package's loop shape)::

        pg = dist.init_process_group()
        ddp = DistributedDataParallel(model, optimizer=SGD(lr),
                                      loss_fn=nn.CrossEntropyLoss(), group=pg)
        state = ddp.init(seed=0)
        for xb, yb in batches:
            state, metrics = ddp.train_step(state, xb, yb)

    ``metrics`` holds ``loss`` (global mean) and ``correct`` (global count)
    as device scalars; reading them every step makes the host wait for the
    card, so log every N steps."""

    def __init__(self, module: torch.nn.Module, optimizer=None, loss_fn=None,
                 group=None, sync_batchnorm: bool = False,
                 compute_dtype=None, accum_steps: int = 1,
                 shard_optimizer: bool = False, comm_dtype=None):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        for flag, what in ((accum_steps > 1, "accum_steps > 1"),
                           (shard_optimizer, "shard_optimizer (ZeRO-1)"),
                           (comm_dtype is not None, "comm_dtype"),
                           (sync_batchnorm, "sync_batchnorm")):
            if flag:
                raise NotImplementedError(
                    f"{what} comes with the optim/ZeRO slice of the port")
        if group is None:
            from .. import dist as _dist
            group = _dist.get_default_group() if _dist.is_initialized() \
                else None
        self.module = module
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.group = group
        self.world_size = group.size() if group is not None else 1
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init(self, seed: int = 0) -> TrainState:
        """Initialize the module's parameters from ``seed`` and return the
        state over them.  Deterministic given ``seed``: every rank builds
        the same parameters, as in the JAX package."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        reset_parameters(self.module, generator)
        params = dict(self.module.named_parameters())
        opt_state = self.optimizer.init(params) if self.optimizer else {}
        model_state = {path: {"aux_loss": torch.zeros((), device=self.device)}
                       for path, _ in self._moe_layers()}
        return TrainState(params, model_state, opt_state, 0)

    def _moe_layers(self):
        return [(path, m) for path, m in self.module.named_modules()
                if isinstance(m, MoELayer)]

    def train_step(self, state: TrainState, x, y):
        """One forward + backward + all-reduce + update step; returns
        ``(new_state, {"loss": scalar, "correct": count})``."""
        if self.optimizer is None or self.loss_fn is None:
            raise ValueError("train_step requires optimizer= and loss_fn=")
        params = state.params
        cdtype = self.compute_dtype
        with torch.enable_grad():
            cast = params
            if cdtype is not None:
                cast = {k: v.to(cdtype) if v.is_floating_point() else v
                        for k, v in params.items()}
                if x.is_floating_point():
                    x = x.to(cdtype)
            out = torch.func.functional_call(self.module, cast, (x,))
            loss = self.loss_fn(out, y)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        with torch.no_grad():
            loss = loss.detach()
            correct = (out.argmax(-1) == y).sum()
            # the aux losses in float32 under any compute dtype, as the JAX
            # package keeps its state masters
            model_state = {path: {"aux_loss": m.aux_loss.detach().to(
                               torch.float32, copy=True)}
                           for path, m in self._moe_layers()}
            if self.world_size > 1:
                for g in grads.values():
                    torch.distributed.all_reduce(g)
                    g.div_(self.world_size)
                torch.distributed.all_reduce(loss)
                loss.div_(self.world_size)
                torch.distributed.all_reduce(correct)
                for leaves in model_state.values():
                    torch.distributed.all_reduce(leaves["aux_loss"])
                    leaves["aux_loss"].div_(self.world_size)
            new_params, new_opt = self.optimizer.update(
                grads, state.opt_state, params)
        return (TrainState(new_params, model_state, new_opt,
                           state.step + 1),
                {"loss": loss, "correct": correct})
