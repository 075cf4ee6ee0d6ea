"""DistributedDataParallel — counterpart of ``tpu_dist/parallel/ddp.py``.

The JAX package compiles forward, loss, gradient all-reduce and optimizer
update into one program under ``shard_map``.  The port runs the same step
eagerly: float32 master parameters (the module's own) are cast to
``compute_dtype`` for the forward and backward, the gradients land in float32
on the masters through the cast's backward, and with world > 1 they are
averaged over the group before the optimizer updates the masters in place.
Each rank steps on its own rows of the global batch (the JAX package's
device shard).

**The gradient sync.**  The gradients are concatenated in the JAX package's
leaf order (``interop.jax_leaf_order``: its parameter tree's sorted keys,
not torch's registration order) into one flat vector per dtype, zero-padded
to a multiple of the world size, and averaged as one
``reduce_scatter_tensor`` (each rank divides its chunk's sum by the world
size) and one ``all_gather_into_tensor``.  ``shard_optimizer=True`` (ZeRO-1,
the JAX option) stops after the reduce-scatter: each rank updates only its
chunk of the flat float32 parameters, with optimizer state ``{"flat":
chunk}`` (1/world of the replicated state), and all-gathers the updated
parameters; the module's parameters are views of one flat buffer, so the
gather lands in place.  Both paths sum every element in the same order, and
the optimizers are element-wise, so ZeRO-1's parameters are the replicated
path's bit for bit at any world.  ``comm_dtype`` (torch's
``bf16_compress_hook``) divides by the world size before casting, reduces in
``comm_dtype`` and casts back; at world 1 it still rounds the gradients
through ``comm_dtype``, as the JAX package does.

``train_step`` consumes its state: the parameters, module state and
optimizer buffers are updated in place (the JAX package donates them), and
the returned :class:`TrainState` holds the same tensors.

Module state (``TrainState.model_state``, the JAX package's layout):

- each :class:`~tpu_dist_torch.nn.BatchNorm2d` keeps its running statistics
  as ``{path: {"mean", "var"}}``, float32 under any compute dtype; these
  are the layer's own buffers, which the step passes to the forward and
  the layer updates in place from this rank's batch statistics.  Batch
  statistics stay per-replica (``sync_batchnorm=True`` makes them
  cross-replica), and at world > 1 the updated running statistics are
  averaged over the group, as the JAX package's ``pmean`` does (torch's
  DDP would keep rank 0's instead);
- each :class:`~tpu_dist_torch.nn.MoELayer` keeps its last load-balancing
  loss as its ``aux_loss`` attribute; the step collects it as ``{path:
  {"aux_loss": float32 scalar}}``, averaged over the group.  As in the JAX
  package it is reported, not added to the objective.

Randomness: ``TrainState.rng`` is the JAX package's base key data
(``fold_in(key(seed), 0x5eed)``); micro-batch ``i`` of step ``s`` on rank
``r`` runs its forward under ``nn.rng_scope(fold_in(fold_in(rng, s * accum
+ i), r))`` (``accum = accum_steps``; ``i = 0`` without accumulation), so
dropout draws the JAX package's masks, distinct on every rank, step and
micro-batch.

Every method reads the state it is given, never the module's own tensors:
a state restored from a checkpoint (new tensors,
:func:`tpu_dist_torch.checkpoint.restore`) trains and evaluates as the
state it was saved from, while the module's parameters stay where
:meth:`DistributedDataParallel.init` left them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import random
from ..nn.layers import BatchNorm2d
from ..nn.module import reset_parameters, rng_scope
from ..nn.moe import MoELayer

__all__ = ["TrainState", "DistributedDataParallel", "convert_sync_batchnorm",
           "Placement"]


class TrainState(NamedTuple):
    """Training state: ``params`` are the module's float32 master parameters
    by name; ``model_state`` holds ``{path: {"mean", "var"}}`` for each
    BatchNorm and ``{path: {"aux_loss"}}`` for each MoE layer (``{}`` for a
    model with neither); ``opt_state`` the optimizer's buffers; ``step`` the
    update count; ``rng`` the base key data, an int64 ``(2,)`` CPU tensor."""
    params: Dict[str, torch.Tensor]
    model_state: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: int
    rng: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a state leaf lives (the port's counterpart of a JAX
    ``NamedSharding``): its ``device``, and whether each rank holds its own
    shard of it (``sharded``: ZeRO-1's optimizer state) or a replica.
    ``checkpoint.restore(device=ddp.state_shardings(state))`` puts each
    restored leaf on its device."""
    device: torch.device
    sharded: bool = False


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def convert_sync_batchnorm(module: torch.nn.Module, group) -> torch.nn.Module:
    """Make every BatchNorm of ``module`` reduce its batch statistics over
    ``group`` (torch ``SyncBatchNorm.convert_sync_batchnorm``); returns the
    module, changed in place."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return module


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
        """``shard_optimizer``: ZeRO-1 — the optimizer state and update of
        each rank cover 1/world of the flattened parameters (module
        docstring).  ``comm_dtype``: compress the gradient sync to this
        dtype (divide by the world size first, reduce, cast back); composes
        with ``accum_steps`` (one compression, at sync time) and ZeRO-1 (the
        reduce-scatter runs compressed)."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if group is None:
            from .. import dist as _dist
            group = _dist.get_default_group() if _dist.is_initialized() \
                else None
        self.module = module
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.group = group
        self.world_size = group.size() if group is not None else 1
        self.rank = group.rank if group is not None else 0
        # a sub-group's collectives take its torch group (None: the world)
        self._tg = group.torch_group if group is not None else None
        self.compute_dtype = compute_dtype
        self.accum_steps = accum_steps
        self.shard_optimizer = shard_optimizer
        self.comm_dtype = comm_dtype
        self._flat = None      # ZeRO-1: the flat parameter buffer
        self._flat_ptrs = None
        if sync_batchnorm and group is not None:
            convert_sync_batchnorm(module, group)
        # the module tree is fixed once wrapped: find its stateful layers once
        modules = list(module.named_modules())
        self._bns = [(p, m) for p, m in modules if isinstance(m, BatchNorm2d)
                     and m.track_running_stats]
        self._moes = [(p, m) for p, m in modules if isinstance(m, MoELayer)]

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init(self, seed: int = 0) -> TrainState:
        """Initialize the module's parameters and state from ``seed`` and
        return the state over them.  Deterministic given ``seed``: every
        rank builds the same parameters, as in the JAX package."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        reset_parameters(self.module, generator)
        params = dict(self.module.named_parameters())
        if self.optimizer is None:
            opt_state = {}
        elif self.shard_optimizer:
            opt_state = self._zero1_init(params)
        else:
            opt_state = self.optimizer.init(params)
        model_state = {path: {"mean": m.running_mean, "var": m.running_var}
                       for path, m in self._bns}
        model_state.update(
            {path: {"aux_loss": torch.zeros((), device=self.device)}
             for path, _ in self._moes})
        rng = random.fold_in(random.key(seed), 0x5EED)
        return TrainState(params, model_state, opt_state, 0, rng)

    # -- the flat gradient sync and ZeRO-1 -----------------------------------

    def _order(self, params) -> list:
        from ..interop import jax_leaf_order
        return jax_leaf_order(params)

    @torch.no_grad()
    def _zero1_init(self, params) -> Dict[str, Any]:
        """Make the module's parameters views of one flat float32 buffer
        (JAX leaf order, padded to a multiple of the world size) and build
        this rank's optimizer state over its chunk of it."""
        order = self._order(params)
        dtypes = {params[k].dtype for k in order}
        if dtypes != {torch.float32}:
            raise ValueError(f"shard_optimizer needs float32 master "
                             f"parameters, got {sorted(map(str, dtypes))}")
        numel = sum(params[k].numel() for k in order)
        padded = _ceil_to(numel, self.world_size)
        flat = torch.zeros(padded, dtype=torch.float32, device=self.device)
        off = 0
        for k in order:
            p = params[k]
            view = flat[off:off + p.numel()].view_as(p)
            view.copy_(p)
            p.data = view
            off += p.numel()
        self._flat = flat
        self._flat_ptrs = [params[k].data_ptr() for k in order]
        chunk = padded // self.world_size
        return self.optimizer.init(
            {"flat": torch.zeros(chunk, dtype=torch.float32,
                                 device=self.device)})

    def _divisor(self, t: torch.Tensor) -> torch.Tensor:
        # a 0-d device divisor: the card divides by a host scalar as a
        # multiply by its reciprocal, which rounds otherwise
        return torch.tensor(float(self.world_size), dtype=t.dtype,
                            device=t.device)

    def _reduce_scatter_avg(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the group average of the padded ``flat``
        (``comm_dtype``: divided first, reduced in ``comm_dtype``, cast
        back)."""
        n, cd = self.world_size, self.comm_dtype
        div = self._divisor(flat)
        src = flat if cd is None else (flat / div).to(cd)
        if n == 1:
            shard = src
        else:
            shard = src.new_empty(src.numel() // n)
            torch.distributed.reduce_scatter_tensor(shard, src,
                                                    group=self._tg)
        return shard / div if cd is None else shard.to(flat.dtype)

    @torch.no_grad()
    def _sync_grads(self, grads: Dict[str, torch.Tensor]):
        """The group average of ``grads``: per dtype, one flat reduce-
        scatter and all-gather in JAX leaf order (module docstring)."""
        n = self.world_size
        order = self._order(grads)
        out = {}
        for dt in dict.fromkeys(grads[k].dtype for k in order):
            names = [k for k in order if grads[k].dtype == dt]
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            numel = flat.numel()
            flat = torch.nn.functional.pad(flat, (0, _ceil_to(numel, n)
                                                  - numel))
            shard = self._reduce_scatter_avg(flat)
            if n > 1:
                full = shard.new_empty(flat.numel())
                torch.distributed.all_gather_into_tensor(full, shard,
                                                         group=self._tg)
            else:
                full = shard
            for k, v in zip(names, full[:numel].split(
                    [grads[k].numel() for k in names])):
                out[k] = v.view_as(grads[k])
        return {k: out[k] for k in grads}

    @torch.no_grad()
    def _zero1_update(self, grads, state: "TrainState"):
        """ZeRO-1: reduce-scatter the flat gradients, update this rank's
        chunk of the flat parameters with its optimizer state, all-gather
        the parameters (in place when they are the flat buffer's views)."""
        params = state.params
        order = self._order(params)
        n, me = self.world_size, self.rank
        g = torch.cat([grads[k].reshape(-1) for k in order])
        numel = g.numel()
        padded = _ceil_to(numel, n)
        g = torch.nn.functional.pad(g, (0, padded - numel))
        g_shard = self._reduce_scatter_avg(g)
        in_place = (self._flat is not None and self._flat_ptrs
                    == [params[k].data_ptr() for k in order])
        flat = (self._flat if in_place else torch.nn.functional.pad(
            torch.cat([params[k].detach().reshape(-1) for k in order]),
            (0, padded - numel)))
        chunk = padded // n
        p_shard = flat[me * chunk:(me + 1) * chunk]
        _, new_opt = self.optimizer.update({"flat": g_shard},
                                           state.opt_state, {"flat": p_shard})
        if n > 1:
            torch.distributed.all_gather_into_tensor(flat, p_shard.clone(),
                                                     group=self._tg)
        if not in_place:
            views = flat[:numel].split([params[k].numel() for k in order])
            torch._foreach_copy_([params[k].data for k in order],
                                 [v.view_as(params[k]) for k, v in
                                  zip(order, views)])
        return params, new_opt

    def state_shardings(self, state: "TrainState") -> "TrainState":
        """A tree of :class:`Placement` mirroring ``state``: every leaf
        replicated on its device, except ZeRO-1's optimizer state (its
        tensors of one or more dimensions are this rank's shard; scalar
        counters stay replicated).  Feed it to
        ``checkpoint.restore(device=...)`` so a restored state lands where
        this one lives."""
        from .. import checkpoint

        def place(path, leaf):
            dev = (leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu"))
            sharded = (self.shard_optimizer and path.startswith(".opt_state")
                       and getattr(leaf, "ndim", 0) >= 1)
            return Placement(dev, sharded)

        flat = checkpoint._flatten(state)
        return checkpoint._unflatten(state, {k: place(k, v)
                                             for k, v in flat.items()})

    def _call(self, params, model_state, x):
        """The module's forward on ``params`` with the BatchNorm statistics
        of ``model_state`` as its buffers (updated in place in training
        mode)."""
        tensors = dict(params)
        for path, _ in self._bns:
            tensors[f"{path}.running_mean"] = model_state[path]["mean"]
            tensors[f"{path}.running_var"] = model_state[path]["var"]
        return torch.func.functional_call(self.module, tensors, (x,))

    def _micro_key(self, state: TrainState, i: int):
        """Micro-batch ``i``'s key: ``fold_in(fold_in(rng, step * accum +
        i), rank)``, the JAX package's."""
        return random.fold_in(random.fold_in(
            state.rng, state.step * self.accum_steps + i), self.rank)

    def _average_state(self, model_state) -> None:
        """Average every module-state leaf over the group, in place."""
        for leaves in model_state.values():
            for t in leaves.values():
                torch.distributed.all_reduce(t, group=self._tg)
                t.div_(self.world_size)

    def _micro_grads(self, state: TrainState, x, y, i: int):
        """Forward and backward of micro-batch ``i`` (rows ``x``/``y``):
        ``(grads, loss, correct)``, the gradients local to this rank."""
        params = state.params
        cdtype = self.compute_dtype
        with torch.enable_grad(), rng_scope(
                lambda: self._micro_key(state, i)):
            cast = params
            if cdtype is not None:
                cast = {k: v.to(cdtype) if v.is_floating_point() else v
                        for k, v in params.items()}
                if x.is_floating_point():
                    x = x.to(cdtype)
            out = self._call(cast, state.model_state, x)
            loss = self.loss_fn(out, y)
            grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            return grads, loss.detach(), (out.argmax(-1) == y).sum()

    def train_step(self, state: TrainState, x, y):
        """One forward + backward + all-reduce + update step; returns
        ``(new_state, {"loss": scalar, "correct": count})``.

        With ``accum_steps = k > 1`` this rank's rows are split into k
        micro-batches, run in turn (the BatchNorm statistics carried from
        one to the next), their float32 gradients summed and divided by k,
        the loss averaged and the correct counts summed; the gradients are
        all-reduced once, after the last (torch DDP ``no_sync``)."""
        if self.optimizer is None or self.loss_fn is None:
            raise ValueError("train_step requires optimizer= and loss_fn=")
        params = state.params
        accum = self.accum_steps
        rows = x.shape[0]
        if rows % accum:
            raise ValueError(f"this rank's {rows} rows do not split into "
                             f"accum_steps={accum} micro-batches")
        self.module.train()
        if accum == 1:
            grads, loss, correct = self._micro_grads(state, x, y, 0)
        else:
            grads, loss, correct = None, None, None
            for i, (xb, yb) in enumerate(zip(x.chunk(accum), y.chunk(accum))):
                g, lb, cb = self._micro_grads(state, xb, yb, i)
                with torch.no_grad():
                    if grads is None:
                        grads = [t.float() for t in g]
                        loss, correct = lb.float(), cb
                    else:
                        torch._foreach_add_(grads, list(g))
                        loss, correct = loss + lb, correct + cb
            with torch.no_grad():
                torch._foreach_div_(grads, float(accum))
                loss = loss / accum
        grads = dict(zip(params, grads))
        with torch.no_grad():
            # the BatchNorm statistics were updated in place by the forwards;
            # the aux losses (the last micro-batch's) in float32 under any
            # compute dtype, as the JAX package keeps its state masters
            model_state = dict(state.model_state)
            model_state.update({path: {"aux_loss": m.aux_loss.detach().to(
                                    torch.float32, copy=True)}
                                for path, m in self._moes})
            if self.world_size > 1:
                torch.distributed.all_reduce(loss, group=self._tg)
                loss.div_(self.world_size)
                torch.distributed.all_reduce(correct, group=self._tg)
                self._average_state(model_state)
            if self.shard_optimizer:
                new_params, new_opt = self._zero1_update(grads, state)
            else:
                if self.world_size > 1 or self.comm_dtype is not None:
                    grads = self._sync_grads(grads)
                new_params, new_opt = self.optimizer.update(
                    grads, state.opt_state, params)
        return (TrainState(new_params, model_state, new_opt,
                           state.step + 1, state.rng),
                {"loss": loss, "correct": correct})

    def train_chunk(self, state: TrainState, xs, ys):
        """``xs.shape[0]`` train steps, step ``i`` on ``xs[i]``/``ys[i]``
        (this rank's rows): the same as that many :meth:`train_step` calls.
        Returns ``(new_state, metrics)`` with each metric stacked per step,
        shape ``(k,)``."""
        losses, corrects = [], []
        for x, y in zip(xs, ys):
            state, m = self.train_step(state, x, y)
            losses.append(m["loss"])
            corrects.append(m["correct"])
        return state, {"loss": torch.stack(losses),
                       "correct": torch.stack(corrects)}

    def train_repeat(self, state: TrainState, x, y, num_steps: int):
        """``num_steps`` train steps on the same batch: what that many
        :meth:`train_step` calls return (the step counter still advances,
        so dropout draws anew).  Returns ``(new_state, metrics)`` with each
        metric stacked per step, shape ``(num_steps,)``."""
        if self.optimizer is None or self.loss_fn is None:
            raise ValueError("train_repeat requires optimizer= and loss_fn=")
        losses, corrects = [], []
        for _ in range(num_steps):
            state, m = self.train_step(state, x, y)
            losses.append(m["loss"])
            corrects.append(m["correct"])
        return state, {"loss": torch.stack(losses),
                       "correct": torch.stack(corrects)}

    @torch.no_grad()
    def forward(self, state: TrainState, x):
        """Inference forward (eval mode: BatchNorm on its running
        statistics, which stay as they are) on this rank's rows; returns
        their logits (torch ``ddp_model(images)``)."""
        self.module.eval()
        return self._call(state.params, state.model_state, x)

    @torch.no_grad()
    def eval_step(self, state: TrainState, x, y, n_valid=None):
        """Loss and accuracy sums of this rank's rows ``x``/``y`` in eval
        mode, summed over the group.  Rows from ``n_valid`` on (default:
        none) are padding and count nothing.  Returns ``{"loss" (sum over
        scored labels / scored), "loss_sum", "correct", "scored"}``, where
        ``scored`` counts the labels the loss scores (padding and
        ``ignore_index`` labels excluded)."""
        if self.loss_fn is None:
            raise ValueError("eval_step requires loss_fn=")
        out = self.forward(state, x)
        rows = y.shape[0]
        n_valid = rows if n_valid is None else n_valid
        row_keep = (torch.arange(rows, device=y.device) < n_valid).reshape(
            (rows,) + (1,) * (y.dim() - 1))
        hit = out.argmax(-1) == y
        ignore = getattr(self.loss_fn, "ignore_index", None)
        if ignore is not None:
            # padding rows carry ignore_index, so the loss skips them and
            # its mean times the kept count is the sum over scored labels;
            # the hits are masked too (ignore_index may be a class id)
            keep = (y != ignore) & row_keep
            kept = keep.sum()
            loss_sum = self.loss_fn(out, y) * kept
            hit = hit & keep
        else:
            # a loss without ignore_index would score the padding rows:
            # each row's own loss (a batch of one), summed over real rows
            per_row = torch.func.vmap(
                lambda o, t: self.loss_fn(o[None], t[None]))(out, y)
            elems = y[0].numel() if y.dim() > 1 else 1
            keep_rows = row_keep.reshape(rows)
            loss_sum = (per_row * keep_rows).sum() * elems
            kept = keep_rows.sum() * elems
            hit = hit & row_keep
        correct = hit.sum()
        if self.world_size > 1:
            for t in (loss_sum, correct, kept):
                torch.distributed.all_reduce(t, group=self._tg)
        return {"loss": loss_sum / kept.clamp_min(1), "loss_sum": loss_sum,
                "correct": correct, "scored": kept}

    def evaluate(self, state: TrainState, loader) -> dict:
        """Drive :meth:`eval_step` over ``loader``'s ``(x, y)`` batches of
        this rank's rows (``data.DeviceLoader(local_shards=False)``: each
        rank's contiguous slice of the identical global batch); returns the
        global ``{"loss", "accuracy", "count"}``, the same on every rank.

        A batch with fewer rows than the first is padded up to it (the JAX
        package pads the global batch to a multiple of the world size; its
        per-rank share is the port's row count): padded rows carry the
        loss's ``ignore_index``, or label 0 and are masked by position.
        ``count`` is the number of labels the loss scored, and the loss is
        the sum over them divided by it, exact under any padding.  The sums
        stay on the device; the host reads them once, at the end."""
        ignore = getattr(self.loss_fn, "ignore_index", None)
        pad_label = 0 if ignore is None else ignore
        pad_rows = None
        totals = None
        for x, y in loader:
            b = int(x.shape[0])
            pad_rows = b if pad_rows is None else max(pad_rows, b)
            if b < pad_rows:
                x = torch.cat([x, x.new_zeros((pad_rows - b,) + x.shape[1:])])
                y = torch.cat([y, y.new_full((pad_rows - b,) + y.shape[1:],
                                             pad_label)])
            m = self.eval_step(state, x, y, n_valid=b)
            step = (m["loss_sum"], m["correct"], m["scored"])
            totals = step if totals is None else tuple(
                a + b for a, b in zip(totals, step))
        n = 0 if totals is None else int(totals[2])
        if n == 0:
            return {"loss": 0.0, "accuracy": 0.0, "count": 0}
        return {"loss": float(totals[0]) / n,
                "accuracy": int(totals[1]) / n, "count": n}
