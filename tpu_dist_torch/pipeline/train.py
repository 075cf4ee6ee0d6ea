"""PipelineTrainer — dp × pp training over stage roles, plus the
single-process serial oracle (counterpart of ``tpu_dist/pipeline/train.py``).

One :class:`PipelineTrainer` per rank.  The rank's role (``stage{i}``, from
:func:`~tpu_dist_torch.pipeline.schedule.build_pipeline_graph`) fixes its
layer span; its role rank is its **data lane**.  Per step:

1. the stage runtime (:class:`~tpu_dist_torch.pipeline.stage.PipelineStage`)
   executes the schedule's op sequence over the act/grad channels and
   returns the stage's accumulated, /M-normalized gradients;
2. the gradients are synchronized *within the stage* across data lanes with
   the existing machinery unchanged — the role's own sub-group
   (``ctx.group``) under the bucketed all-reduce, or a per-stage
   :class:`~tpu_dist_torch.parallel.ZeroOptimizer`;
3. the stage's optimizer slice steps.

:meth:`PipelineTrainer.step` returns a :class:`StepHandle`; ``wait()``
finishes the grad sync, applies the update and yields the step metrics
(loss on the last stage, stash watermarks everywhere).

Parameters are the JAX package's tree ``{module_path: {leaf: tensor}}`` (the
port's layouts; :func:`~tpu_dist_torch.pipeline.partition.param_tree`).
Every rank initializes the whole model from the seed and keeps its stage's
slice, so training starts as a single-process run does; ``init_params(
model)`` replaces the seeded weights (the tests load the JAX package's).

Checkpointing: every rank's :meth:`state_dict` (its param/optimizer slice)
is a per-rank shard for :class:`~tpu_dist_torch.resilience.TrainState`
(``sharded_keys=("params", "opt_state")``), giving a bit-for-bit resume
after a stage-death gang restart.

:class:`SerialPipelineRunner` is the matched-math oracle: the *same*
partition and the *same* stage functions run in one process, microbatches in
the same order with the same /M normalization — so the distributed host
pipeline (either schedule, dp=1) matches it bit for bit, and 1F1B matches
GPipe bit for bit (both backward microbatches in increasing order).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..collectives import _tree
from .partition import flat_params, param_tree, partition_model
from .schedule import act_channel, grad_channel, parse_stage_role
from .stage import (PipelineStage, StageFns, StageResult, _tree_add,
                    _tree_div)

__all__ = ["PipelineTrainer", "StepHandle", "SerialPipelineRunner",
           "build_stage_fns", "split_microbatches"]

GRAD_SYNC_MODES = ("none", "bucket", "zero")


def split_microbatches(arr, num_microbatches: int) -> List:
    """Split the leading (batch) axis into ``num_microbatches`` equal
    microbatches (the mesh twin's layout: contiguous slices in order)."""
    n = arr.shape[0]
    if n % num_microbatches:
        raise ValueError(f"batch {n} not divisible by "
                         f"{num_microbatches} microbatches")
    b = n // num_microbatches
    return [arr[k * b:(k + 1) * b] for k in range(num_microbatches)]


def _apply_loss(loss_fn, logits, y):
    # sequence models produce (B, T, V): flatten like the mesh pipeline
    if logits.dim() == 3:
        return loss_fn(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
    return loss_fn(logits, y)


def _leaves(params):
    """Fresh autograd leaves over ``params`` (detached, float leaves
    requiring grad)."""
    return _tree.tree_map(lambda t: t.detach().requires_grad_(
        t.is_floating_point()), params)


def _input(x):
    """The stashed input as an autograd leaf: detached, requiring grad when
    it is a float activation (token ids carry no gradient)."""
    x = x.detach()
    return x.requires_grad_(True) if x.is_floating_point() else x


def _grads(out, leaves, x, g):
    """``(d leaves, dx or None)`` of ``out`` (cotangent ``g``; None for a
    scalar loss); a leaf ``out`` does not reach gets zeros."""
    flat, treedef = _tree.flatten(leaves)
    wrt = [t for t in flat if t.requires_grad]
    with_x = x.requires_grad
    got = torch.autograd.grad(out, wrt + ([x] if with_x else []),
                              grad_outputs=g, allow_unused=True)
    it = iter(got[:len(wrt)])
    dp = [(next(it) if t.requires_grad else None) for t in flat]
    dp = [torch.zeros_like(t) if d is None else d for d, t in zip(dp, flat)]
    return _tree.unflatten(treedef, dp), (got[-1] if with_x else None)


def build_stage_fns(part, stage: int, loss_fn) -> StageFns:
    """The stage's compute: forward under ``no_grad``, and a
    recompute-based backward over the stashed *input* — the forward runs
    again under ``torch.enable_grad()`` and ``torch.autograd.grad`` gives
    the parameter gradients and ``dx`` (the mesh 1F1B's memory regime).
    Both the distributed trainer and the serial oracle build their
    functions here — matched math by construction."""
    fn = part.stage_fn(stage)
    first, last = part.is_first(stage), part.is_last(stage)
    fns = StageFns()
    if last:
        @torch.no_grad()
        def fwd_loss(p, x, y):
            return _apply_loss(loss_fn, fn(p, x), y)

        def bwd_loss(p, x, y):
            lp, xx = _leaves(p), _input(x)
            with torch.enable_grad():
                loss = _apply_loss(loss_fn, fn(lp, xx), y)
                return _grads(loss, lp, xx, None)

        fns.fwd_loss, fns.bwd_loss = fwd_loss, bwd_loss
    else:
        @torch.no_grad()
        def fwd(p, x):
            return fn(p, x)

        def bwd(p, x, g):
            lp = _leaves(p)
            xx = x.detach() if first else _input(x)
            with torch.enable_grad():
                dp, dx = _grads(fn(lp, xx), lp, xx, g)
            return dp, (None if first else dx)

        fns.fwd, fns.bwd = fwd, bwd
    return fns


def _seeded_tree(model, seed: int, init_params=None):
    """The model's whole parameter tree after re-initializing it from
    ``seed`` (and ``init_params(model)`` when given)."""
    from ..nn.module import reset_parameters
    dev = next(model.parameters()).device
    reset_parameters(model, torch.Generator(device=dev).manual_seed(
        int(seed)))
    if init_params is not None:
        init_params(model)
    return param_tree(model)


def _mean_loss(losses: Dict[int, Any]) -> Optional[float]:
    if not losses:
        return None
    return float(torch.stack([losses[k].float()
                              for k in sorted(losses)]).mean())


class StepHandle:
    """One in-flight optimizer step: ``wait()`` finishes the intra-stage
    grad sync, applies the update, and returns the metrics dict
    (``loss`` is None off the last stage)."""

    def __init__(self, trainer: "PipelineTrainer", result: StageResult,
                 work=None, zwork=None, grads=None):
        self._trainer = trainer
        self._result = result
        self._work = work
        self._zwork = zwork
        self._grads = grads
        self._metrics: Optional[Dict[str, Any]] = None

    def done(self) -> bool:
        return self._metrics is not None

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if self._metrics is not None:
            return self._metrics
        t = self._trainer
        if self._zwork is not None:
            t.params = self._zwork.wait(timeout)
        else:
            grads = self._grads
            if self._work is not None:
                grads = self._work.wait_all(timeout)
            if t.optimizer is not None:
                t.optimizer.update(flat_params(grads), t.opt_state,
                                   flat_params(t.params))
        t._step += 1
        res = self._result
        self._metrics = {"step": t._step, "loss": _mean_loss(res.losses),
                         "stash_peak_bytes": res.stash_peak_bytes,
                         "stash_peak_count": res.stash_peak_count}
        return self._metrics


class PipelineTrainer:
    """The per-rank dp × pp trainer — see the module docstring.

    Args:
        ctx: the rank's :class:`~tpu_dist_torch.roles.RoleContext`; its
            role must be ``stage{i}`` (use :func:`build_pipeline_graph`).
        model / optimizer / loss_fn: a port model (on its device), a port
            optimizer and a loss; every rank builds the whole model from
            ``seed`` and keeps only its stage's slice.
        num_microbatches: microbatches per step (batch must divide).
        schedule: ``"gpipe"`` or ``"1f1b"``.
        compress: opt-in ``"int8_blockN"`` activation wire compression
            (lossy).
        grad_sync: ``"bucket"`` (default when the stage spans >1 data
            lane), ``"zero"`` (per-stage ZeRO), or ``"none"``.
        init_params: ``init_params(model)`` after the seeded init.
    """

    def __init__(self, ctx, model, optimizer, loss_fn, *,
                 num_microbatches: int, schedule: str = "gpipe",
                 compress=None, grad_sync: Optional[str] = None,
                 seed: int = 0, timeout: float = 120.0, init_params=None):
        stage = parse_stage_role(ctx.role)
        if stage is None:
            raise ValueError(
                f"PipelineTrainer wants a stage{{i}} role, this rank is "
                f"{ctx.role!r} — build the graph with "
                f"build_pipeline_graph()")
        stages = sorted(s for s in
                        (parse_stage_role(r.name) for r in ctx.graph.roles)
                        if s is not None)
        if stages != list(range(len(stages))) or len(stages) < 2:
            raise ValueError(f"graph stage roles {stages} are not a "
                             f"contiguous 0..S-1 pipeline")
        self.ctx = ctx
        self.stage_index = stage
        self.num_stages = len(stages)
        self.lane = ctx.role_rank
        self.dp_world = ctx.role_world
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        self.part = partition_model(model, self.num_stages)
        self.params = self.part.stage_params(
            _seeded_tree(model, seed, init_params), stage)
        if grad_sync is None:
            grad_sync = "bucket" if self.dp_world > 1 else "none"
        if grad_sync not in GRAD_SYNC_MODES:
            raise ValueError(f"grad_sync must be one of "
                             f"{GRAD_SYNC_MODES}, got {grad_sync!r}")
        self.grad_sync = grad_sync
        self._bucketer = None
        self._zopt = None
        if grad_sync == "zero":
            from ..parallel.zero import ZeroOptimizer
            self._zopt = ZeroOptimizer(optimizer, group=ctx.group)
            self.opt_state = self._zopt.init(self.params)
        else:
            self.opt_state = (optimizer.init(flat_params(self.params))
                              if optimizer is not None else {})
            if grad_sync == "bucket":
                from ..collectives.bucketer import Bucketer
                self._bucketer = Bucketer()
        self._step = 0
        self._owned_channels: List = []
        in_act, out_act, in_grad, out_grad = self._open_channels()
        self.stage = PipelineStage(
            build_stage_fns(self.part, stage, loss_fn), stage,
            self.num_stages, num_microbatches, schedule=schedule,
            in_act=in_act, out_act=out_act, in_grad=in_grad,
            out_grad=out_grad, compress=compress, timeout=timeout,
            device=self.device)

    # -- wiring ---------------------------------------------------------------

    def _endpoint(self, name: str):
        """This lane's endpoint of channel ``name``.  dp=1 uses the
        role-graph channel as-is (ctx-cached); dp>1 opens the per-lane
        channel with single-rank spans so activations keep the p2p frame
        path (and so each lane claims only its own microbatches)."""
        ctx = self.ctx
        if self.dp_world == 1:
            return ctx.channel(name)
        from ..roles.channel import Channel
        spec = ctx.graph.channel_spec(name)
        src = list(ctx.graph.span(spec.src))[self.lane]
        dst = list(ctx.graph.span(spec.dst))[self.lane]
        ch = Channel(spec, ctx.store, ctx.rank, ctx.role,
                     src_span=[src], dst_span=[dst],
                     generation=ctx.generation,
                     graph_world=ctx.graph.world)
        self._owned_channels.append(ch)
        return ch

    def _open_channels(self):
        i = self.stage_index
        lane = None if self.dp_world == 1 else self.lane
        in_act = out_act = in_grad = out_grad = None
        if i > 0:
            in_act = self._endpoint(act_channel(i - 1, lane))
            out_grad = self._endpoint(grad_channel(i - 1, lane))
        if i < self.num_stages - 1:
            out_act = self._endpoint(act_channel(i, lane))
            in_grad = self._endpoint(grad_channel(i, lane))
        return in_act, out_act, in_grad, out_grad

    # -- stepping -------------------------------------------------------------

    @property
    def is_first(self) -> bool:
        return self.stage_index == 0

    @property
    def is_last(self) -> bool:
        return self.stage_index == self.num_stages - 1

    def _on_device(self, arr):
        if arr is None:
            return None
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
        return t.to(self.device)

    def step(self, x=None, y=None) -> StepHandle:
        """Run one pipeline step; ``x`` is required on stage 0, ``y`` on
        the last stage (this lane's batch shard; numpy or tensors).
        Returns the :class:`StepHandle` — ``wait()`` it."""
        m = self.num_microbatches
        x_mb = (split_microbatches(self._on_device(x), m)
                if self.is_first else None)
        y_mb = (split_microbatches(self._on_device(y), m)
                if self.is_last else None)
        res = self.stage.run_step(self.params, x_mb=x_mb, y_mb=y_mb)
        if self._zopt is not None:
            zwork, self.opt_state = self._zopt.update(
                res.grads, self.opt_state)
            return StepHandle(self, res, zwork=zwork)
        if self._bucketer is not None:
            work = self._bucketer.all_reduce(res.grads, op="avg",
                                             group=self.ctx.group)
            return StepHandle(self, res, work=work)
        return StepHandle(self, res, grads=res.grads)

    # -- checkpointing --------------------------------------------------------

    @property
    def step_count(self) -> int:
        return self._step

    def state_dict(self) -> Dict[str, Any]:
        """This rank's checkpoint shard: its param slice + optimizer
        slice (feed to TrainState with ``sharded_keys=("params",
        "opt_state")``)."""
        return {"params": self.params, "opt_state": self.opt_state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.params = _tree.tree_map(
            lambda t: torch.as_tensor(t).to(self.device), state["params"])
        opt = state["opt_state"]
        self.opt_state = _tree.tree_map(
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor)
            and t.dim() else t, opt)

    def close(self) -> None:
        """Stop the sender thread and close trainer-owned (per-lane)
        channels; ctx-cached channels are closed by the context."""
        self.stage.close()
        for ch in self._owned_channels:
            try:
                ch.close()
            except Exception:
                pass
        self._owned_channels = []


class SerialPipelineRunner:
    """The single-process matched-math oracle (module docstring): same
    partition, same stage functions, same microbatch order and
    normalization as the distributed host pipeline — bit for bit."""

    def __init__(self, model, optimizer, loss_fn, num_stages: int,
                 num_microbatches: int, seed: int = 0, init_params=None):
        self.part = partition_model(model, num_stages)
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        full = _seeded_tree(model, seed, init_params)
        self.params = [self.part.stage_params(full, i)
                       for i in range(num_stages)]
        self.fns = [build_stage_fns(self.part, i, loss_fn)
                    for i in range(num_stages)]
        self.opt_states = [optimizer.init(flat_params(p)) if optimizer
                           else {} for p in self.params]
        self._step = 0

    def merged_params(self) -> Dict[str, Any]:
        return self.part.merge_params(self.params)

    def step(self, x, y) -> float:
        m, s = self.num_microbatches, self.num_stages
        x_mb = split_microbatches(torch.as_tensor(x).to(self.device), m)
        y_mb = split_microbatches(torch.as_tensor(y).to(self.device), m)
        stash: List[Dict[int, Any]] = [dict() for _ in range(s)]
        losses = {}
        for k in range(m):
            h = x_mb[k]
            for i in range(s):
                stash[i][k] = h
                if i == s - 1:
                    losses[k] = self.fns[i].fwd_loss(self.params[i], h,
                                                     y_mb[k])
                else:
                    h = self.fns[i].fwd(self.params[i], h)
        accs: List[Any] = [None] * s
        for k in range(m):  # backward in mb order: both schedules' order
            g = None
            for i in reversed(range(s)):
                x_in = stash[i].pop(k)
                if i == s - 1:
                    dp, dx = self.fns[i].bwd_loss(self.params[i], x_in,
                                                  y_mb[k])
                else:
                    dp, dx = self.fns[i].bwd(self.params[i], x_in, g)
                accs[i] = dp if accs[i] is None else _tree_add(accs[i], dp)
                g = dx
        for i in range(s):
            grads = _tree_div(accs[i], float(m))
            if self.optimizer is not None:
                self.optimizer.update(flat_params(grads), self.opt_states[i],
                                      flat_params(self.params[i]))
        self._step += 1
        return _mean_loss(losses)

