"""TransformerLM training on a learnable synthetic task — the port's twin of
``examples/train_lm.py`` in its ``--parallel dp`` mode.

DistributedDataParallel over the ranks of the default group (one card each;
``--device cpu`` for the CPU), the global batch split over them; attention
takes the flash kernel on the card at 1024 positions and more.
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

The other modes of the JAX example raise: ``sp`` (sequence parallelism,
ring attention: ROADMAP A8), ``tp`` and ``pp`` (tensor and pipeline
parallelism: A9.6), ``ep`` (expert parallelism: A9.5)::

    python -m tpu_dist_torch.examples.train_lm --generate 32
    python -m tpu_dist_torch.examples.train_lm --device cpu --steps 20
"""

from __future__ import annotations

import argparse
from datetime import datetime

import numpy as np

__all__ = ["make_batches", "parse_args", "train", "main"]

_LATER = {"sp": "sequence parallelism (ring attention, ROADMAP A8)",
          "tp": "tensor parallelism (ROADMAP A9.6)",
          "pp": "pipeline parallelism (ROADMAP A9.6)",
          "ep": "expert parallelism (ROADMAP A9.5)"}


def make_batches(rng, perm, vocab, batch, seq_len, steps):
    """Synthetic permutation-LM stream: y[t] = perm[x[t]]."""
    for _ in range(steps):
        x = rng.integers(0, vocab, (batch, seq_len))
        yield x, perm[x]


def train(args) -> dict:
    """Train (and with ``--generate`` sample) as the script does; returns
    ``{"state", "ddp", "losses", "generated", "consistent", "transitions"}``
    (``losses``: every step's global loss; the last three are ``None``
    without ``--generate`` and on ranks other than 0)."""
    if args.parallel != "dp":
        raise NotImplementedError(
            f"--parallel {args.parallel}: {_LATER[args.parallel]} is not in "
            f"the port yet; use --parallel dp")
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

    import os
    init_method = "env://" if "MASTER_ADDR" in os.environ else None
    pg = dist.init_process_group(
        init_method=init_method,
        device="cpu" if args.device == "cpu" else None)
    try:
        rank, n = dist.get_rank(), dist.get_world_size()
        model = TransformerLM(args.vocab, dim=args.dim, depth=args.depth,
                              num_heads=args.heads, max_seq_len=args.seq_len,
                              device=pg.device)
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=make_lr()),
            loss_fn=nn.CrossEntropyLoss(), group=pg)
        state = ddp.init(seed=0)
        per_rank = max(args.batch_size // n, 1)
        rows = slice(rank * per_rank, (rank + 1) * per_rank)
        losses = []
        for i, (x, y) in enumerate(make_batches(rng, perm, args.vocab,
                                                per_rank * n, args.seq_len,
                                                args.steps)):
            state, metrics = ddp.train_step(
                state, torch.from_numpy(x[rows]).to(pg.device),
                torch.from_numpy(y[rows]).to(pg.device))
            losses.append(metrics["loss"])
            if rank == 0 and (i + 1) % args.log_every == 0:
                print(f"Step [{i + 1}/{args.steps}] "
                      f"loss: {float(metrics['loss']):.4f}", flush=True)
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
                "generated": seq, "consistent": ok, "transitions": total}
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parallel", default="dp",
                   choices=["dp", "sp", "tp", "pp", "ep"],
                   help="dp only; the others raise (ROADMAP A8, A9.5, A9.6)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", default=200, type=int)
    p.add_argument("--batch-size", default=8, type=int,
                   help="global batch (split over the ranks)")
    p.add_argument("--seq-len", default=512, type=int)
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
