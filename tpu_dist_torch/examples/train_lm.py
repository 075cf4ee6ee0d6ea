"""TransformerLM training on a learnable synthetic task — the port's twin of
``examples/train_lm.py`` in its ``--parallel dp`` and ``sp`` modes.

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

``--compute-dtype bfloat16`` (the port's one option beyond the JAX
example's; default float32, the example's) runs the forward and backward in
bf16 over float32 masters, in either mode.  On the card float32 attention
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

The other modes of the JAX example raise: ``tp`` and ``pp`` (tensor and
pipeline parallelism: ROADMAP A9.6), ``ep`` (expert parallelism: A9.5)::

    python -m tpu_dist_torch.examples.train_lm --generate 32
    python -m tpu_dist_torch.examples.train_lm --device cpu --steps 20
    python -m tpu_dist_torch.examples.train_lm --parallel sp --seq-len 8192
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np

__all__ = ["make_batches", "sp_mesh", "parse_args", "train", "main"]

_LATER = {"tp": "tensor parallelism (ROADMAP A9.6)",
          "pp": "pipeline parallelism (ROADMAP A9.6)",
          "ep": "expert parallelism (ROADMAP A9.5)"}


def make_batches(rng, perm, vocab, batch, seq_len, steps):
    """Synthetic permutation-LM stream: y[t] = perm[x[t]]."""
    for _ in range(steps):
        x = rng.integers(0, vocab, (batch, seq_len))
        yield x, perm[x]


def sp_mesh(world: int):
    """The ``(data, seq)`` mesh shape of ``--parallel sp``: data 2 wide when
    the world is even and above 1, as in the JAX example."""
    dp = 2 if world % 2 == 0 and world > 1 else 1
    return dp, world // dp


def train(args) -> dict:
    """Train (and with ``--generate`` sample) as the script does; returns
    ``{"state", "ddp", "losses", "generated", "consistent", "transitions",
    "seq_len", "batch", "first_step_seconds", "loop_seconds"}``
    (``losses``: every step's global loss; ``generated``, ``consistent`` and
    ``transitions`` are ``None`` without ``--generate`` and on ranks other
    than 0; ``seq_len`` and ``batch`` the global shape a step trains on;
    ``first_step_seconds`` the first step's wall time, its one-time set-up
    included, and ``loop_seconds`` the other steps', the card synchronized
    at each end; both None without steps)."""
    if args.parallel not in ("dp", "sp"):
        raise NotImplementedError(
            f"--parallel {args.parallel}: {_LATER[args.parallel]} is not in "
            f"the port yet; use --parallel dp or sp")
    if args.parallel == "sp" and args.generate > 0:
        raise ValueError("--generate samples after dp training; the "
                         "sequence-parallel model has no KV cache")
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
    dp, sp = sp_mesh(world) if args.parallel == "sp" else (world, 1)
    pg = dist.init_process_group(
        init_method=init_method,
        device="cpu" if args.device == "cpu" else None,
        axis_names=("data", "seq"), mesh_shape=(dp, sp))
    try:
        rank = dist.get_rank()
        if args.parallel == "sp":
            seq_len = max(args.seq_len // sp, 16) * sp  # divisible shards
            batch = max(args.batch_size // dp, 1) * dp
        else:
            seq_len, batch = args.seq_len, max(args.batch_size // dp, 1) * dp
        model = TransformerLM(
            args.vocab, dim=args.dim, depth=args.depth, num_heads=args.heads,
            max_seq_len=seq_len, device=pg.device,
            sequence_axis="seq" if args.parallel == "sp" else None,
            mode=args.sp_mode)
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=make_lr()),
            loss_fn=nn.CrossEntropyLoss(), group=pg,
            compute_dtype=getattr(torch, args.compute_dtype)
            if args.compute_dtype != "float32" else None)
        state = ddp.init(seed=0)
        # this rank's block of each global batch: its rows on the data axis,
        # its columns on the seq axis
        di = pg.axis_group("data").index
        si = pg.axis_group("seq").index
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
            state, metrics = ddp.train_step(
                state, torch.from_numpy(x[rows, cols]).to(pg.device),
                torch.from_numpy(y[rows, cols]).to(pg.device))
            losses.append(metrics["loss"])
            if i == 0:
                mark()
            if rank == 0 and (i + 1) % args.log_every == 0:
                where = (f"  (seq {seq_len} over {sp} ranks, {args.sp_mode})"
                         if args.parallel == "sp" else "")
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parallel", default="dp",
                   choices=["dp", "sp", "tp", "pp", "ep"],
                   help="dp or sp; tp, pp and ep raise (ROADMAP A9.5, A9.6)")
    p.add_argument("--sp-mode", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the forward's and backward's dtype over float32 "
                        "master parameters")
    p.add_argument("--steps", default=200, type=int)
    p.add_argument("--batch-size", default=8, type=int,
                   help="global batch (split over the ranks; over 'data' "
                        "under sp)")
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
