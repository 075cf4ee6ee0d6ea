"""TransformerLM training on a learnable synthetic task — the port's twin of
``examples/train_lm.py`` in its ``--parallel dp``, ``sp`` and ``ep`` modes.

``dp``: DistributedDataParallel over the ranks of the default group (one
card each; ``--device cpu`` for the CPU), the global batch split over them;
attention takes the flash kernel on the card at 1024 positions and more.

``sp``: a 2-D (data × seq) mesh of the ranks, ``data`` 2 wide when the world
is even and above 1: each rank takes its (data, seq) block of the batch, the
sequence split over ``seq``, and every attention layer runs ring attention
(``--sp-mode ulysses``: the all-to-all head redistribution) over the
``seq`` ranks.  The step is the DDP's over the whole world (local mean loss,
backward, gradients all-reduced and averaged over every rank), which is the
JAX step's gradient of its twice-``pmean``'d loss; sequence and batch are
rounded as the JAX example rounds them.

``ep``: expert parallelism on a (data × expert) mesh of the ranks, ``data``
2 wide when the world is even and above 1 and ``expert`` the rest: every
block's MLP is a top-2 ``MoELayer`` (``--experts``, rounded up to a multiple
of the expert axis) holding its rank's experts, the batch split over
``data``, and the GSPMD step's counterpart (``parallel.
make_gspmd_train_step``, Switch aux loss at 0.01 in the objective) — the
JAX example's mode, with routing and capacity over the global batch.

``tp``: tensor parallelism on a (data × model) mesh of the ranks, ``data``
2 wide when the world is even and above 1 and ``model`` the rest: the
model is split by the JAX package's ``TRANSFORMER_TP_RULES``
(``TransformerLM(model_axis="model")``: each rank holds its heads, MLP
columns and vocab rows; the heads rounded to a multiple of the model axis,
as in the JAX example), the batch split over ``data``, SGD, and the GSPMD
step's counterpart (``parallel.make_gspmd_train_step``): the JAX example's
mode, its loss taken on logits split on the vocab.

``--compute-dtype bfloat16`` (the port's one option beyond the JAX
example's; default float32, the example's) runs the forward and backward in
bf16 over float32 masters, in every mode.  On the card float32 attention
takes the flash kernel's CUDA-core design; the long-context step the sp
mode exists for runs its tensor-core (wgmma) kernels only in bf16, and
``benchmarks/sp_lm.py`` drives this trainer on every rank with it rather
than a second trainer.
``--lr-schedule warmup_cosine`` evaluates a warmup + cosine decay schedule
(peak ``--lr``, 10% warmup) of the update count on the host each step
(``tpu_dist_torch.optim.lr_scheduler``).

Synthetic task: next token = a fixed random permutation of the current
token — exactly learnable, so a falling loss (printed rank-0 style, the
reference's logging discipline) is the correctness oracle.  ``--generate
N`` then samples N tokens with the KV cache and counts how many
transitions follow the learned permutation.  The data stream, the
permutation and the prompt are the JAX example's
(``np.random.default_rng(0)``).

``pp``: pipeline parallelism on a (data × pipe) mesh of the ranks, ``data``
2 wide when the world is even and above 1 and ``pipe`` the rest
(``parallel.PipelineParallel``, GPipe, one stage a rank): the depth rounded
to a multiple of the pipe axis and the batch to data × ``--microbatches``
(default: the pipe axis), SGD and the unfused cross-entropy — the JAX
example's mode.

::

    python -m tpu_dist_torch.examples.train_lm --generate 32
    python -m tpu_dist_torch.examples.train_lm --device cpu --steps 20
    python -m tpu_dist_torch.examples.train_lm --parallel sp --seq-len 8192
    python -m tpu_dist_torch.examples.train_lm --parallel ep --device cpu
    python -m tpu_dist_torch.examples.train_lm --parallel tp --device cpu
    python -m tpu_dist_torch.examples.train_lm --parallel pp --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np

__all__ = ["make_batches", "sp_mesh", "ep_trainer", "tp_trainer",
           "pp_trainer", "parse_args", "train", "main"]

_AXIS = {"sp": "seq", "ep": "expert", "tp": "model", "pp": "pipe"}


def make_batches(rng, perm, vocab, batch, seq_len, steps):
    """Synthetic permutation-LM stream: y[t] = perm[x[t]]."""
    for _ in range(steps):
        x = rng.integers(0, vocab, (batch, seq_len))
        yield x, perm[x]


def sp_mesh(world: int):
    """The ``(data, seq)`` mesh shape of ``--parallel sp`` (and ``(data,
    expert)`` of ``ep``): data 2 wide when the world is even and above 1,
    as in the JAX example."""
    dp = 2 if world % 2 == 0 and world > 1 else 1
    return dp, world // dp


def train(args, init_params=None) -> dict:
    """Train (and with ``--generate`` sample) as the script does; returns
    ``{"state", "ddp", "losses", "generated", "consistent", "transitions",
    "seq_len", "batch", "first_step_seconds", "loop_seconds"}``
    (``losses``: every step's global loss; ``generated``, ``consistent`` and
    ``transitions`` are ``None`` without ``--generate`` and on ranks other
    than 0; ``seq_len`` and ``batch`` the global shape a step trains on;
    ``first_step_seconds`` the first step's wall time, its one-time set-up
    included, and ``loop_seconds`` the other steps', the card synchronized
    at each end; both None without steps).  ``init_params(model)``, if
    given, replaces the seeded initialization (the tests load the JAX
    example's).  Under ``ep``, ``state`` is ``{"params", "opt_state",
    "mstate"}`` and ``ddp`` the step function; under ``tp`` ``{"params",
    "opt_state"}`` and the step function; under ``pp`` the rank's
    ``PipeTrainState`` and the ``PipelineParallel``."""
    if args.parallel in _AXIS and args.generate > 0:
        raise ValueError(f"--generate samples after dp training, not "
                         f"after --parallel {args.parallel}")
    import torch

    from .. import dist, nn, optim, random
    from ..models import TransformerLM
    from ..parallel import DistributedDataParallel

    rng = np.random.default_rng(0)
    perm = rng.permutation(args.vocab)
    start = datetime.now()

    def make_lr():
        if args.lr_schedule == "warmup_cosine":
            return optim.warmup_cosine(peak_lr=args.lr,
                                       warmup_steps=max(args.steps // 10, 1),
                                       total_steps=args.steps)
        return args.lr

    init_method = "env://" if "MASTER_ADDR" in os.environ else None
    world = int(os.environ.get("WORLD_SIZE", 1)) if init_method else 1
    # the mesh: (data, seq) for dp and sp, (data, expert) for ep, (data,
    # model) for tp
    dp, other = sp_mesh(world) if args.parallel != "dp" else (world, 1)
    axis = _AXIS.get(args.parallel, "seq")
    pg = dist.init_process_group(
        init_method=init_method,
        device="cpu" if args.device == "cpu" else None,
        axis_names=("data", axis), mesh_shape=(dp, other))
    try:
        rank = dist.get_rank()
        if args.parallel == "sp":
            seq_len = max(args.seq_len // other, 16) * other  # divisible
        else:
            seq_len = args.seq_len
        batch = max(args.batch_size // dp, 1) * dp
        compute_dtype = (getattr(torch, args.compute_dtype)
                         if args.compute_dtype != "float32" else None)
        # round the experts UP to a multiple of the expert axis: the banks'
        # leading dim must split evenly over it
        experts = (-(-max(args.experts, 2) // other) * other
                   if args.parallel == "ep" else 0)
        # divisible heads under tp, as the JAX example rounds them
        heads = (max(args.heads // other, 1) * other
                 if args.parallel == "tp" else args.heads)
        # divisible stages under pp
        depth = (max(args.depth // other, 1) * other
                 if args.parallel == "pp" else args.depth)
        model = TransformerLM(
            args.vocab, dim=args.dim, depth=depth, num_heads=heads,
            max_seq_len=seq_len, device=pg.device, num_experts=experts,
            sequence_axis="seq" if args.parallel == "sp" else None,
            mode=args.sp_mode,
            expert_axis="expert" if args.parallel == "ep" else None,
            model_axis="model" if args.parallel == "tp" else None)
        if args.parallel == "ep":
            ddp, state, advance = ep_trainer(model, args.vocab, make_lr(),
                                             compute_dtype,
                                             init_params=init_params)
        elif args.parallel == "tp":
            ddp, state, advance = tp_trainer(model, args.vocab, make_lr(),
                                             compute_dtype,
                                             init_params=init_params)
        elif args.parallel == "pp":
            ddp, state, advance = pp_trainer(
                model, make_lr(), args.microbatches, compute_dtype,
                init_params=init_params)
            # divisible microbatches on every data row
            mb = ddp.num_microbatches
            batch = max(args.batch_size // (dp * mb), 1) * dp * mb
        else:
            ddp = DistributedDataParallel(
                model, optimizer=optim.SGD(lr=make_lr()),
                loss_fn=nn.CrossEntropyLoss(), group=pg,
                compute_dtype=compute_dtype)
            state = ddp.init(seed=0)
            if init_params is not None:
                init_params(model)  # the state's tensors are the module's
            advance = ddp.train_step
        # this rank's block of each global batch: its rows on the data axis,
        # its columns on the seq axis
        di = pg.axis_group("data").index
        si = pg.axis_group("seq").index if args.parallel == "sp" else 0
        sp = other if args.parallel == "sp" else 1
        rows = slice(di * (batch // dp), (di + 1) * (batch // dp))
        cols = slice(si * (seq_len // sp), (si + 1) * (seq_len // sp))
        losses, marks = [], []

        def mark():  # the wall clock with the card caught up
            if pg.device.type == "cuda":
                torch.cuda.synchronize(pg.device)
            marks.append(time.perf_counter())

        mark()
        for i, (x, y) in enumerate(make_batches(rng, perm, args.vocab,
                                                batch, seq_len, args.steps)):
            state, metrics = advance(
                state, torch.from_numpy(x[rows, cols]).to(pg.device),
                torch.from_numpy(y[rows, cols]).to(pg.device))
            losses.append(metrics["loss"])
            if i == 0:
                mark()
            if rank == 0 and (i + 1) % args.log_every == 0:
                where = ""
                if args.parallel == "sp":
                    where = (f"  (seq {seq_len} over {sp} ranks, "
                             f"{args.sp_mode})")
                elif args.parallel == "ep":
                    aux = sum(float(v["aux_loss"])
                              for v in state["mstate"].values())
                    where = (f"  (E={experts} over {other} ranks, aux "
                             f"{aux:.3f})")
                elif args.parallel == "tp":
                    where = f"  (tp={other})"
                elif args.parallel == "pp":
                    where = (f"  ({other} stages x {ddp.num_microbatches} "
                             f"microbatches)")
                print(f"Step [{i + 1}/{args.steps}] "
                      f"loss: {float(metrics['loss']):.4f}{where}",
                      flush=True)
        mark()
        losses = [float(v) for v in losses]

        seq, ok, total = None, None, None
        if args.generate > 0 and rank == 0:
            # the trained map is y[t] = perm[x[t]], so greedy decoding
            # iterates the permutation: each new token should be
            # perm[previous] — a self-checking generation demo
            if args.gen_int8:
                nn.quantize_linear_weights(model, attention=True)
                print("generating with int8 matmul weights", flush=True)
            prompt = torch.from_numpy(rng.integers(0, args.vocab, (1, 4)))
            out = model.generate(
                prompt, args.generate, temperature=args.gen_temperature,
                rng=(random.key(1) if args.gen_temperature > 0 else None),
                top_k=args.gen_top_k, top_p=args.gen_top_p)
            seq = out[0].cpu().tolist()
            gen = seq[prompt.shape[1] - 1:]
            ok = sum(int(gen[i + 1]) == int(perm[gen[i]])
                     for i in range(len(gen) - 1))
            total = len(gen) - 1
            print(f"generate: {seq}", flush=True)
            print(f"permutation-consistent transitions: {ok}/{total}",
                  flush=True)
        if rank == 0:
            print(f"Training complete in: {datetime.now() - start}",
                  flush=True)
        return {"state": state, "ddp": ddp, "losses": losses,
                "generated": seq, "consistent": ok, "transitions": total,
                "seq_len": seq_len, "batch": batch,
                "first_step_seconds": marks[1] - marks[0]
                if len(marks) == 3 else None,
                "loop_seconds": marks[2] - marks[1]
                if len(marks) == 3 else None}
    finally:
        dist.destroy_process_group()


def ep_trainer(model, vocab: int, lr, compute_dtype=None,
               fused: bool = False, init_params=None):
    """``(step, state, advance)`` of ``--parallel ep``: the GSPMD step's
    counterpart over ``model`` seeded with 0 (the JAX example's
    ``shard_pytree(..., MOE_EP_RULES)`` placement is the layers' own: each
    draws its whole banks and keeps its slice; ``init_params(model)``
    replaces the weights), SGD at ``lr``, the Switch aux loss at 0.01,
    ``CrossEntropyLoss(fused=fused)`` over ``vocab``, and
    ``advance(state, x, y) -> (state, metrics)`` over ``state = {"params",
    "opt_state", "mstate"}``.  ``benchmarks/moe_lm.ep_steps`` runs the
    same step at the benchmark's configuration."""
    import torch

    from .. import nn, optim
    from ..nn.module import reset_parameters
    from ..parallel import make_gspmd_train_step

    reset_parameters(model, torch.Generator(
        device=model.device).manual_seed(0))
    if init_params is not None:
        init_params(model)
    ce = nn.CrossEntropyLoss(fused=fused)
    opt = optim.SGD(lr=lr)
    step = make_gspmd_train_step(
        model, lambda lg, y: ce(lg.reshape(-1, vocab), y.reshape(-1)),
        opt, aux_loss_coeff=0.01, compute_dtype=compute_dtype)
    params = dict(model.named_parameters())
    state = {"params": params, "opt_state": opt.init(params),
             "mstate": {p: {"aux_loss": torch.zeros((), device=model.device)}
                        for p, m in model.named_modules()
                        if isinstance(m, nn.MoELayer)}}

    def advance(state, x, y):
        params, opt_state, mstate, metrics = step(
            state["params"], state["opt_state"], state["mstate"], x, y)
        return {"params": params, "opt_state": opt_state,
                "mstate": mstate}, metrics

    return step, state, advance


def tp_trainer(model, vocab: int, lr, compute_dtype=None,
               fused: bool = False, init_params=None):
    """``(step, state, advance)`` of ``--parallel tp``: the GSPMD step's
    counterpart over ``model`` (built with ``model_axis``) seeded with 0
    (each split layer draws its whole parameters and keeps its slice, the
    JAX example's ``shard_pytree(..., TRANSFORMER_TP_RULES)`` placement;
    ``init_params(model)`` replaces the weights), SGD at ``lr``,
    ``CrossEntropyLoss(fused=fused)`` over ``vocab`` (taken on the logits
    split on the vocab), and ``advance(state, x, y) -> (state, metrics)``
    over ``state = {"params", "opt_state"}``."""
    import torch

    from .. import nn, optim
    from ..nn.module import reset_parameters
    from ..parallel import make_gspmd_train_step

    reset_parameters(model, torch.Generator(
        device=model.device).manual_seed(0))
    if init_params is not None:
        init_params(model)
    ce = nn.CrossEntropyLoss(fused=fused)
    opt = optim.SGD(lr=lr)
    step = make_gspmd_train_step(
        model, lambda lg, y: ce(lg.reshape(-1, vocab), y.reshape(-1)),
        opt, compute_dtype=compute_dtype)
    params = dict(model.named_parameters())
    state = {"params": params, "opt_state": opt.init(params)}

    def advance(state, x, y):
        params, opt_state, metrics = step(state["params"],
                                          state["opt_state"], x, y)
        return {"params": params, "opt_state": opt_state}, metrics

    return step, state, advance


def pp_trainer(model, lr, microbatches: int = 0, compute_dtype=None,
               fused: bool = False, schedule: str = "gpipe",
               init_params=None):
    """``(pp, state, advance)`` of ``--parallel pp``: ``PipelineParallel``
    over ``model`` on the default group's ``("data", "pipe")`` mesh,
    seeded with 0 (``init_params(model)`` replaces the weights), SGD at
    ``lr``, ``CrossEntropyLoss(fused=fused)``, ``microbatches`` a step
    (0: the pipe axis's size, the JAX example's default) and
    ``advance(state, x, y) -> (state, metrics)``."""
    from .. import nn, optim
    from ..parallel import PipelineParallel

    pp = PipelineParallel(model, optimizer=optim.SGD(lr=lr),
                          loss_fn=nn.CrossEntropyLoss(fused=fused),
                          num_microbatches=microbatches or None,
                          compute_dtype=compute_dtype, schedule=schedule)
    state = pp.init(seed=0, init_params=init_params)
    return pp, state, pp.train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parallel", default="dp",
                   choices=["dp", "sp", "tp", "pp", "ep"],
                   help="dp, sp, tp, pp or ep")
    p.add_argument("--sp-mode", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the forward's and backward's dtype over float32 "
                        "master parameters")
    p.add_argument("--steps", default=200, type=int)
    p.add_argument("--batch-size", default=8, type=int,
                   help="global batch (split over the ranks; over 'data' "
                        "under sp, ep and tp)")
    p.add_argument("--seq-len", default=512, type=int,
                   help="global sequence length (split over 'seq' under sp)")
    p.add_argument("--dim", default=256, type=int)
    p.add_argument("--depth", default=4, type=int)
    p.add_argument("--heads", default=8, type=int)
    p.add_argument("--vocab", default=256, type=int)
    p.add_argument("--lr", default=0.5, type=float)
    p.add_argument("--lr-schedule", default="none",
                   choices=["none", "warmup_cosine"],
                   help="schedule of the update count (peak = --lr, 10%% "
                        "warmup)")
    p.add_argument("--microbatches", default=0, type=int,
                   help="pp: microbatches a step (0: the pipe axis's size)")
    p.add_argument("--experts", default=4, type=int,
                   help="ep: experts a block (rounded up to a multiple of "
                        "the expert axis)")
    p.add_argument("--log-every", default=20, type=int)
    p.add_argument("--generate", default=0, type=int,
                   help="after training: sample N tokens with the KV cache "
                        "and report how many transitions follow the "
                        "learned permutation (greedy at the default "
                        "--gen-temperature 0; --gen-top-k/--gen-top-p "
                        "apply only when --gen-temperature > 0)")
    p.add_argument("--gen-temperature", default=0.0, type=float)
    p.add_argument("--gen-top-k", default=0, type=int)
    p.add_argument("--gen-top-p", default=1.0, type=float)
    p.add_argument("--gen-int8", action="store_true",
                   help="quantize matmul weights to int8 before generating "
                        "(attention included); the permutation check still "
                        "has to pass on the quantized model")
    return p.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
