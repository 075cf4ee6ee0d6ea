"""Pipeline parallelism on a mesh of ranks — counterpart of
``tpu_dist/parallel/pipeline.py`` (the ``pipe`` mesh axis, with an optional
``data`` axis).

The JAX package writes one SPMD program: the trunk's stages are stacked on
a stage axis sharded over ``pipe``, a ``lax.scan`` over ticks moves the
activations one hop a tick with ``ppermute``, and autodiff of the scan (or
a hand-scheduled 1F1B scan) gives the backward.  In the port a rank is one
stage of one data row and runs its stage as an ordinary PyTorch program:

- **What a rank holds.**  Stage ``i``'s rank holds its ``blocks_per_stage``
  blocks (the ``"stages"`` leaves, each ``(1, ...)``: the rank's row of the
  JAX package's stacked ``(S, ...)`` leaf) plus the replicated embedding
  and head (``"repl"``).  :meth:`PipelineParallel.pack_params` /
  :meth:`~PipelineParallel.unpack_params` map a whole model's tree to and
  from the JAX package's ``{"repl", "stages"}`` layout, key for key.
- **Hops.**  Activations go down the pipe line and their cotangents back up
  by point-to-point sends: NCCL ``send``/``recv`` a card a rank,
  ``batch_isend_irecv`` where a 1F1B step sends and receives at once (NCCL
  pairs a pair's P2P calls strictly in order: the batched pairs keep both
  sides' orders equal, Megatron's schedule), gloo on the CPU and for ranks
  that share a card — gloo's P2P takes CPU tensors only, so a CUDA
  activation is copied to the host before its send and back after its
  receive, explicitly.
- **GPipe.**  All forwards, then all backwards, each microbatch's graph
  held (``model.remat`` honoured through :func:`nn.checkpoint
  <tpu_dist_torch.nn.checkpoint>`).  The head and the loss run once over
  all ``M`` microbatches' trunk outputs on the last stage, as the JAX
  step's ``:339-355`` does: one K1f and one K1b launch a step and the same
  mean.
- **1F1B.**  Scheduled by hand: a warmup of ``min(S - i - 1, M)``
  forwards, then one forward one backward, then the drain (Megatron's
  order, the host pipeline's op lists).  A forward runs under
  ``no_grad`` and stashes its input (at most ``min(S - i, M)`` of them,
  inside the JAX ring's ``K = min(2S - 1, M)`` slots); a backward
  recomputes the stage's forward under autograd.  The last stage keeps
  its one microbatch's graph from forward to backward instead (its
  stash bound is 1), running the head and loss a microbatch.
- **Gradients.**  Accumulated in float32.  The replicated leaves each have
  one owner (the embedding on stage 0, the head on the last stage): their
  data-averaged gradient is broadcast from the owner over the pipe line,
  which is bit for bit the JAX package's ``psum`` of a gradient that is
  zero off its owner.  Every leaf is averaged over ``data``.  Then two
  optimizer updates, repl and stages, as in the JAX package; the repl
  copies stay equal bit for bit across a pipe line.
- **compute_dtype.**  The forward, backward and hops in that dtype (bf16),
  over float32 master parameters, gradients and optimizer state.

Attention keeps the port's dispatch: K2f/K2b on the card at 1024 positions
and more.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..collectives.work import wait_handle
from ..pipeline.partition import (_Embed, _Head, flat_params, param_tree,
                                  run_block)

__all__ = ["PipelineParallel", "PipeTrainState"]


class PipeTrainState(NamedTuple):
    """A rank's training state.  ``params`` / ``opt_state`` are two-key
    dicts: ``"repl"`` (embedding + head, replicated) and ``"stages"``
    (this rank's trunk blocks, each leaf ``(1, ...)``: its row of the
    stacked stage axis); ``step`` the update count."""
    params: Any
    opt_state: Any
    step: int


class _Stage(torch.nn.Module):
    """The canonical stage program: the model's first ``blocks_per_stage``
    blocks as children ``"0"``, ``"1"``, ...  Modules hold topology only,
    so one stage's module tree runs every stage — the tensors bound by
    ``functional_call`` decide which stage it is."""

    def __init__(self, blocks):
        super().__init__()
        for j, b in enumerate(blocks):
            self.add_module(str(j), b)


def _nested_flat(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a.b.leaf": tensor}`` of a nested dict (the optimizer's names)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_nested_flat(v, name))
        else:
            out[name] = v
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(v) for v in leaves])


class _Hops:
    """The pipe line's point-to-point sends of one rank: activations to the
    next stage, cotangents to the previous one.  Each call posts its sends
    and receives together (``batch_isend_irecv``) and waits them; on gloo a
    CUDA tensor is staged through the host explicitly."""

    def __init__(self, line, backend: Optional[str], device: torch.device):
        self.prev = line.ranks[line.index - 1] if line.index > 0 else None
        self.next = (line.ranks[line.index + 1]
                     if line.index < line.size - 1 else None)
        self.host = backend == "gloo" and device.type == "cuda"
        self.device = device
        self.bytes = 0

    def exchange(self, sends=(), recvs=(), shape=None, dtype=None):
        """Send each ``(tensor, peer)`` of ``sends`` and receive a
        ``shape``/``dtype`` tensor from each peer of ``recvs``; returns the
        received tensors on this rank's device."""
        dist = torch.distributed
        ops, bufs = [], []
        for t, peer in sends:
            t = t.detach().contiguous()
            if self.host:
                t = t.to("cpu")
            self.bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, peer))
        for peer in recvs:
            buf = torch.empty(shape, dtype=dtype, device="cpu" if self.host
                              else self.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                wait_handle(w)   # the default group's
        return [b.to(self.device) if self.host else b for b in bufs]


class PipelineParallel:
    """GPipe/1F1B pipeline-parallel training of a
    :class:`~tpu_dist_torch.models.TransformerLM`, one stage a rank.

    Usage::

        pg = dist.init_process_group(axis_names=("pipe",))   # or (data, pipe)
        pp = PipelineParallel(model, optimizer=optim.AdamW(3e-4),
                              loss_fn=nn.CrossEntropyLoss(), group=pg,
                              num_microbatches=8)
        state = pp.init(seed=0)
        state, metrics = pp.train_step(state, tokens, targets)

    ``tokens``/``targets`` are this rank's ``(B, T)`` rows (its ``data``
    shard; every rank of a pipe line passes the same rows); ``B`` must
    divide by ``num_microbatches``.  ``metrics``: ``loss`` (the global
    mean) and ``correct`` (the global count), device scalars on every rank.

    ``compute_dtype``: the forward, backward and hops in this dtype over
    float32 masters.  ``schedule``: ``"gpipe"`` or ``"1f1b"`` (module
    docstring); the port's optimizers update in place (the JAX step's
    ``donate``).  ``timing=True`` records, each step, the
    rank's busy time (its forwards and backwards), the repl reduction's and
    the hops' bytes in :attr:`stats`.
    """

    def __init__(self, model, optimizer=None, loss_fn=None, group=None,
                 num_microbatches: Optional[int] = None,
                 pipe_axis: str = "pipe", data_axis: Optional[str] = None,
                 compute_dtype=None, schedule: str = "gpipe",
                 timing: bool = False):
        if group is None:
            from .. import dist as _dist
            group = _dist.get_default_group()
        if pipe_axis not in group.axis_names:
            raise ValueError(f"mesh {group.axis_names} has no "
                             f"{pipe_axis!r} axis")
        if data_axis is None and len(group.axis_names) > 1:
            others = [a for a in group.axis_names if a != pipe_axis]
            if len(others) == 1:
                data_axis = others[0]
            else:
                raise ValueError("pass data_axis= explicitly on a >2-D mesh")
        if getattr(model, "sequence_axis", None) is not None:
            raise ValueError("pipeline parallelism microbatches over the "
                             "batch dim; build the model without "
                             "sequence_axis (pp x sp needs a 3-D mesh recipe)")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule must be 'gpipe' or '1f1b', "
                             f"got {schedule!r}")
        self.model = model
        self._model_device = next(model.parameters()).device
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.group = group
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis
        self.compute_dtype = compute_dtype
        self.schedule = schedule
        self.timing = timing
        self.num_stages = dict(zip(group.axis_names,
                                   group.mesh_shape))[pipe_axis]
        if model.depth % self.num_stages:
            raise ValueError(f"depth {model.depth} not divisible by "
                             f"{self.num_stages} pipeline stages")
        self.blocks_per_stage = model.depth // self.num_stages
        self.num_microbatches = num_microbatches or self.num_stages
        self._stage = _Stage([getattr(model, f"block{i}")
                              for i in range(self.blocks_per_stage)])
        self._embed = _Embed(model.tok, model.pos)
        self._head = _Head(model.ln_f, model.head)
        self._canon_paths = None
        self.pipe = group.axis_group(pipe_axis)
        self.data = (group.axis_group(data_axis)
                     if data_axis is not None else None)
        self.stage_index = self.pipe.index
        self.device = group.device
        self.stats: Dict[str, float] = {}
        self._hops = None
        self._busy: list = []    # (start, end) clocks of this step's work

    # -- parameter layout ------------------------------------------------------

    def _stage_paths(self):
        """Canonical stage-relative module paths ("0.ln1", "1.mlp.0", ...)
        and their block-index/suffix decomposition."""
        if self._canon_paths is None:
            paths = []
            for path, mod in self._stage.named_modules():
                if path and any(True for _ in mod.parameters(recurse=False)):
                    j, _, suffix = path.partition(".")
                    paths.append((path, int(j), suffix))
            self._canon_paths = paths
        return self._canon_paths

    def pack_params(self, model_params):
        """A whole model's tree ``{module_path: {leaf: array}}`` (tensors or
        numpy, :func:`~tpu_dist_torch.pipeline.partition.param_tree`) →
        the pipeline layout ``{"repl", "stages"}`` (stage leaves stacked on
        a leading S axis), the JAX package's keys."""
        s, k = self.num_stages, self.blocks_per_stage
        stages = {}
        for canon, j, suffix in self._stage_paths():
            def src(stage):
                base = f"block{stage * k + j}"
                return model_params[f"{base}.{suffix}" if suffix else base]
            names = src(0).keys()
            stages[canon] = {n: _stack([src(st)[n] for st in range(s)])
                             for n in names}
        embed = {"tok": model_params["tok"]}
        if "pos" in model_params:
            embed["pos"] = model_params["pos"]
        repl = {"embed": embed,
                "head": {"ln_f": model_params["ln_f"],
                         "head": model_params["head"]}}
        return {"repl": repl, "stages": stages}

    def unpack_params(self, pipe_params):
        """Inverse of :meth:`pack_params` — e.g. to checkpoint in the plain
        layout or hand weights to an unsharded model for decoding.  The
        stacked axis holds every stage (:meth:`gather_params` gives a
        rank's state so)."""
        k = self.blocks_per_stage
        out = {"tok": pipe_params["repl"]["embed"]["tok"],
               "ln_f": pipe_params["repl"]["head"]["ln_f"],
               "head": pipe_params["repl"]["head"]["head"]}
        if "pos" in pipe_params["repl"]["embed"]:
            out["pos"] = pipe_params["repl"]["embed"]["pos"]
        for canon, j, suffix in self._stage_paths():
            stacked = pipe_params["stages"][canon]
            n = next(iter(stacked.values())).shape[0]
            if n != self.num_stages:
                raise ValueError(f"stages.{canon}: a stacked stage axis of "
                                 f"{n}, not the {self.num_stages} stages")
            for st in range(n):
                base = f"block{st * k + j}"
                path = f"{base}.{suffix}" if suffix else base
                out[path] = {nm: v[st] for nm, v in stacked.items()}
        return out

    # -- state -----------------------------------------------------------------

    def init(self, seed: int = 0, init_params=None) -> PipeTrainState:
        """Deterministic state: the whole model initialized from ``seed``
        (``init_params(model)`` after it, when given: the tests load the
        JAX package's weights), packed, and this rank's stage row kept —
        so pipeline training starts from a single-device run's weights.
        Then the module gives up its tensors (to the meta device): the
        rank holds only its state's stage row and repl leaves."""
        from ..nn.module import reset_parameters
        if next(self.model.parameters()).is_meta:
            self.model.to_empty(device=self._model_device)
        reset_parameters(self.model, torch.Generator(
            device=self._model_device).manual_seed(int(seed)))
        if init_params is not None:
            init_params(self.model)
        state = self.state_from(self.pack_params(param_tree(self.model)))
        # the state holds this rank's copy of what it trains and every
        # forward binds those tensors through functional_call: the module
        # keeps its topology only, so no rank holds the whole model
        self.model.to("meta")
        return state

    def state_from(self, packed, step: int = 0) -> PipeTrainState:
        """A rank's state from a whole packed tree (stacked ``(S, ...)``
        stage leaves, tensors or numpy): its stage row and the repl leaves
        on its device, float32, and a fresh optimizer state."""
        i = self.stage_index

        def put(v):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, dtype=np.float32))
            return t.detach().to(self.device, torch.float32).clone()

        params = {"repl": _map(put, packed["repl"]),
                  "stages": _map(lambda v: put(v[i:i + 1]),
                                 packed["stages"])}
        if self.optimizer is None:
            opt_state = {"repl": {}, "stages": {}}
        else:
            opt_state = {
                "repl": self.optimizer.init(_nested_flat(params["repl"])),
                "stages": self.optimizer.init(
                    _nested_flat(params["stages"]))}
        return PipeTrainState(params, opt_state, int(step))

    def gather_params(self, state: PipeTrainState):
        """The whole packed tree (stage leaves ``(S, ...)``, numpy float32)
        from every rank's row: all-gathered over the pipe line (every rank
        of the line calls it)."""
        line = self.pipe
        # gloo gathers host tensors; NCCL the card's
        host = self.group.backend != "nccl"

        def gather(v):
            v = v.detach().float()
            if host:
                v = v.cpu()
            if line.size == 1:
                return v.cpu().numpy().copy()
            rows = [torch.empty_like(v) for _ in range(line.size)]
            torch.distributed.all_gather(rows, v.contiguous(),
                                         group=line.group)
            return torch.cat(rows).cpu().numpy()

        return {"repl": _map(lambda v: v.detach().float().cpu().numpy()
                             .copy(), state.params["repl"]),
                "stages": _map(gather, state.params["stages"])}

    # -- the step ----------------------------------------------------------------

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh autograd leaf over ``t`` in the compute dtype."""
        if self.compute_dtype is not None and t.is_floating_point():
            t = t.to(self.compute_dtype)
        return t.detach().requires_grad_(True)

    def _clock(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        if isinstance(a, float):
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def train_step(self, state: PipeTrainState, x, y):
        """One pipeline step (this rank's stage over all M microbatches,
        the gradient sync, the updates) → ``(new_state, {"loss",
        "correct"})``."""
        if self.optimizer is None or self.loss_fn is None:
            raise ValueError("train_step requires optimizer= and loss_fn=")
        dist = torch.distributed
        x = torch.as_tensor(x).to(self.device).long()
        y = torch.as_tensor(y).to(self.device).long()
        m, s, i = self.num_microbatches, self.num_stages, self.stage_index
        first, last = i == 0, i == s - 1
        b_loc, t_len = x.shape
        if b_loc % m:
            raise ValueError(f"batch {b_loc} not divisible by {m} "
                             f"microbatches")
        if self._hops is None:
            self._hops = _Hops(self.pipe, self.group.backend, self.device)
        hops = self._hops
        hops.bytes = 0
        self._busy = []
        params = state.params
        stage_leaves = _map(lambda v: self._cast(v[0]), params["stages"])
        embed_leaves = (_map(self._cast, params["repl"]["embed"])
                        if first else None)
        head_leaves = (_map(self._cast, params["repl"]["head"])
                       if last else None)
        sflat = flat_params(stage_leaves)
        x_mb = x.reshape(m, b_loc // m, t_len)
        y_mb = y.reshape(m, b_loc // m, t_len)
        adtype = self.compute_dtype or torch.float32
        shape = (b_loc // m, t_len, self.model.tok.embedding_dim)
        ctx = dict(stage=sflat, embed=embed_leaves, head=head_leaves,
                   x_mb=x_mb, y_mb=y_mb, shape=shape, adtype=adtype,
                   first=first, last=last, hops=hops)
        t0 = self._clock()
        if self.schedule == "1f1b":
            g_stage, g_embed, g_head, loss, correct = self._one_f_one_b(ctx)
        else:
            g_stage, g_embed, g_head, loss, correct = self._gpipe(ctx)
        t1 = self._clock()
        grads = self._sync(params, g_stage, g_embed, g_head)
        t2 = self._clock()
        with torch.no_grad():
            self.optimizer.update(_nested_flat(grads["repl"]),
                                  state.opt_state["repl"],
                                  _nested_flat(params["repl"]))
            self.optimizer.update(_nested_flat(grads["stages"]),
                                  state.opt_state["stages"],
                                  _nested_flat(params["stages"]))
            metrics = torch.stack([loss.detach().float().reshape(()),
                                   correct.detach().float().reshape(())]) \
                if last else torch.zeros(2, device=self.device)
            if self.pipe.size > 1:
                dist.broadcast(metrics, src=self.pipe.ranks[-1],
                               group=self.pipe.group)
            if self.data is not None and self.data.size > 1:
                dist.all_reduce(metrics, group=self.data.group)
                metrics[0] /= metrics.new_tensor(float(self.data.size))
        if self.timing:
            t3 = self._clock()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats = {
                "schedule_ms": self._ms(t0, t1),
                "sync_ms": self._ms(t1, t2),
                "step_ms": self._ms(t0, t3),
                "busy_ms": sum(self._ms(a, b) for a, b in self._busy),
                "hop_bytes": hops.bytes}
        new_state = PipeTrainState(params, state.opt_state, state.step + 1)
        return new_state, {"loss": metrics[0],
                           "correct": metrics[1].round().long()}

    def _span(self, fn, *a):
        """``fn(*a)``, its device time kept for :attr:`stats` (busy)."""
        if not self.timing:
            return fn(*a)
        t0 = self._clock()
        out = fn(*a)
        self._busy.append((t0, self._clock()))
        return out

    def _forward(self, ctx, k, h, grad: bool, remat: bool):
        """The stage's forward of microbatch ``k`` from input ``h`` (the
        token ids on stage 0): its trunk output, or on the last stage
        ``(logits, trunk output)`` when ``grad`` (the head inline)."""
        with torch.set_grad_enabled(grad):
            if ctx["first"]:
                h = torch.func.functional_call(
                    self._embed, flat_params(ctx["embed"]), (ctx["x_mb"][k],),
                    strict=False)
            h = h.to(ctx["adtype"])
            for j in range(self.blocks_per_stage):
                h = run_block(self._stage.get_submodule(str(j)),
                              _sub(ctx["stage"], str(j)), h, remat)
            return h

    def _head_loss(self, ctx, out, y):
        logits = torch.func.functional_call(
            self._head, flat_params(ctx["head"]), (out,), strict=False)
        vocab = self.model.vocab_size
        loss = self.loss_fn(logits.reshape(-1, vocab), y.reshape(-1))
        correct = (logits.argmax(-1) == y).sum()
        return loss, correct

    def _gpipe(self, ctx):
        """All forwards (graphs held), the head and loss once over the M
        trunk outputs, all backwards in microbatch order."""
        m, hops = self.num_microbatches, ctx["hops"]
        first, last = ctx["first"], ctx["last"]
        remat = bool(getattr(self.model, "remat", False))
        ins, outs = [], []
        for k in range(m):
            h = None
            if not first:
                (h,) = hops.exchange(recvs=[hops.prev], shape=ctx["shape"],
                                     dtype=ctx["adtype"])
                h = h.requires_grad_(True)
            ins.append(h)
            out = self._span(self._forward, ctx, k, h, True, remat)
            outs.append(out)
            if not last:
                hops.exchange(sends=[(out, hops.next)])
        loss = correct = g_head = None
        if last:
            def head_pass():
                cat = [o.detach().requires_grad_(True) for o in outs]
                y = ctx["y_mb"].reshape(-1, ctx["y_mb"].shape[-1])
                with torch.enable_grad():
                    lo, co = self._head_loss(ctx, torch.cat(cat), y)
                    hl = list(_flat_tensors(ctx["head"]))
                    got = torch.autograd.grad(lo, hl + cat)
                return lo, co, got[:len(hl)], got[len(hl):]
            loss, correct, dh, couts = self._span(head_pass)
            g_head = _unflat_like(ctx["head"], [d.float() for d in dh])
        acc = None
        for k in range(m):
            if last:
                g = couts[k]
            else:
                (g,) = hops.exchange(recvs=[hops.next], shape=ctx["shape"],
                                     dtype=ctx["adtype"])
            dp, dx = self._span(self._backward, ctx, outs[k], ins[k], g)
            acc = _accumulate(acc, dp)
            outs[k] = ins[k] = None
            if not first:
                hops.exchange(sends=[(dx, hops.prev)])
        return self._split_grads(ctx, acc, 1.0) + (g_head, loss, correct)

    def _backward(self, ctx, out, h_in, g):
        """``(float32 parameter gradients, dx)`` of ``out`` for cotangent
        ``g`` — over the stage's (and stage 0's embedding) leaves."""
        leaves = list(ctx["stage"].values())
        if ctx["first"]:
            leaves += list(_flat_tensors(ctx["embed"]))
        wrt = leaves + ([h_in] if h_in is not None else [])
        got = torch.autograd.grad(out, wrt, grad_outputs=g.to(out.dtype))
        return ([d.float() for d in got[:len(leaves)]],
                got[len(leaves)] if h_in is not None else None)

    def _split_grads(self, ctx, acc, scale: float):
        """``(stage grads (1, ...) tree, embed grads tree or None)`` from the
        accumulated flat list, times ``scale``."""
        names = list(ctx["stage"])
        if scale != 1.0:
            acc = [a * a.new_tensor(scale) for a in acc]
        g_stage = {}
        for n, a in zip(names, acc[:len(names)]):
            path, _, leaf = n.rpartition(".")
            g_stage.setdefault(path, {})[leaf] = a.unsqueeze(0)
        g_embed = (_unflat_like(ctx["embed"], acc[len(names):])
                   if ctx["first"] else None)
        return g_stage, g_embed

    def _one_f_one_b(self, ctx):
        """The 1F1B schedule (module docstring), Megatron's send/receive
        pairing: the forward sends with the next backward's receive, the
        backward with the next forward's."""
        m, s, i = self.num_microbatches, self.num_stages, self.stage_index
        hops, first, last = ctx["hops"], ctx["first"], ctx["last"]
        shape, adtype = ctx["shape"], ctx["adtype"]
        warm = min(s - i - 1, m)
        remaining = m - warm
        stash: Dict[int, Any] = {}
        graphs: Dict[int, Any] = {}
        self.stash_peak = 0
        acc = None
        g_head = None
        loss_sum = correct_sum = None
        nxt = {"f": 0, "b": 0}

        def recv_prev():
            return None if first else hops.exchange(
                recvs=[hops.prev], shape=shape, dtype=adtype)[0]

        def forward(h):
            k = nxt["f"]
            nxt["f"] += 1
            stash[k] = h
            self.stash_peak = max(self.stash_peak, len(stash))
            if last:
                hin = h.requires_grad_(True) if h is not None else None
                graphs[k] = (hin, self._span(self._forward, ctx, k, hin,
                                             True, False))
                return None
            return self._span(self._forward, ctx, k, h, False, False)

        def backward(g):
            nonlocal acc, g_head, loss_sum, correct_sum
            k = nxt["b"]
            nxt["b"] += 1
            h = stash.pop(k)
            if last:
                hin, out = graphs.pop(k)

                def run():
                    y = ctx["y_mb"][k]
                    with torch.enable_grad():
                        lo, co = self._head_loss(ctx, out, y)
                        hl = list(_flat_tensors(ctx["head"]))
                        got = torch.autograd.grad(lo, hl + [out])
                    return lo, co, got[:len(hl)], got[len(hl)]
                lo, co, dh, dout = self._span(run)
                loss_sum = lo.detach().float() if loss_sum is None \
                    else loss_sum + lo.detach().float()
                correct_sum = co if correct_sum is None else correct_sum + co
                dh = [d.float() for d in dh]
                g_head = dh if g_head is None else [
                    a + b for a, b in zip(g_head, dh)]
                dp, dx = self._span(self._backward, ctx, out, hin, dout)
            else:
                hin = None if first else h.detach().requires_grad_(True)

                def recompute():
                    out = self._forward(ctx, k, hin, True, False)
                    return self._backward(ctx, out, hin, g)
                dp, dx = self._span(recompute)
            acc = _accumulate(acc, dp)
            return dx

        for _ in range(warm):
            h = forward(recv_prev())
            hops.exchange(sends=[(h, hops.next)])
        h_in = recv_prev() if remaining > 0 else None
        for r in range(remaining):
            out = forward(h_in)
            if last:
                g = None
            else:
                (g,) = hops.exchange(sends=[(out, hops.next)],
                                     recvs=[hops.next], shape=shape,
                                     dtype=adtype)
            dx = backward(g)
            if r == remaining - 1:
                if not first:
                    hops.exchange(sends=[(dx, hops.prev)])
            elif first:
                h_in = None
            else:
                (h_in,) = hops.exchange(sends=[(dx, hops.prev)],
                                        recvs=[hops.prev], shape=shape,
                                        dtype=adtype)
        for _ in range(warm):
            (g,) = hops.exchange(recvs=[hops.next], shape=shape,
                                 dtype=adtype)
            dx = backward(g)
            if not first:
                hops.exchange(sends=[(dx, hops.prev)])
        scale = 1.0 / m
        g_stage, g_embed = self._split_grads(ctx, acc, scale)
        loss = correct = None
        if last:
            g_head = _unflat_like(ctx["head"], [
                a * a.new_tensor(scale) for a in g_head])
            loss = loss_sum / loss_sum.new_tensor(float(m))
            correct = correct_sum
        return g_stage, g_embed, g_head, loss, correct

    @torch.no_grad()
    def _sync(self, params, g_stage, g_embed, g_head):
        """Every leaf averaged over ``data``; the embedding's gradient
        broadcast from stage 0 and the head's from the last stage over the
        pipe line."""
        dist = torch.distributed
        first = self.stage_index == 0
        last = self.stage_index == self.num_stages - 1
        mine = [g_stage] + ([g_embed] if first else []) + \
            ([g_head] if last else [])
        if self.data is not None and self.data.size > 1:
            flat = [v for tree in mine for v in _flat_tensors(tree)]
            buf = torch.cat([v.reshape(-1) for v in flat])
            dist.all_reduce(buf, group=self.data.group)
            buf /= buf.new_tensor(float(self.data.size))
            out = iter(buf.split([v.numel() for v in flat]))
            mine = [_unflat_like(tree, [next(out).view_as(v) for v in
                                        _flat_tensors(tree)])
                    for tree in mine]
            g_stage = mine[0]
            g_embed = mine[1] if first else None
            g_head = mine[-1] if last else None
        repl = params["repl"]
        if self.pipe.size > 1:
            g_embed = self._broadcast(repl["embed"], g_embed,
                                      self.pipe.ranks[0])
            g_head = self._broadcast(repl["head"], g_head,
                                     self.pipe.ranks[-1])
        return {"repl": {"embed": g_embed, "head": g_head},
                "stages": g_stage}

    def _broadcast(self, like, grads, src: int):
        """``grads`` (a tree like ``like``) from global rank ``src`` to the
        pipe line, as one flat float32 buffer."""
        flat = list(_flat_tensors(like))
        n = sum(v.numel() for v in flat)
        if grads is not None:
            buf = torch.cat([v.reshape(-1).float()
                             for v in _flat_tensors(grads)])
        else:
            buf = torch.empty(n, dtype=torch.float32, device=self.device)
        torch.distributed.broadcast(buf, src=src, group=self.pipe.group)
        out = iter(buf.split([v.numel() for v in flat]))
        return _unflat_like(like, [next(out).view_as(v) for v in flat])


def _sub(flat: Dict[str, torch.Tensor], prefix: str):
    """The entries of ``flat`` under ``prefix.``, re-rooted."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def _flat_tensors(tree):
    """The tensors of a nested dict in a fixed (insertion) order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_tensors(v)
        else:
            yield v


def _unflat_like(like, values):
    it = iter(values)
    return _map(lambda _: next(it), like)


def _accumulate(acc, dp):
    if acc is None:
        return list(dp)
    return [a + d for a, d in zip(acc, dp)]
