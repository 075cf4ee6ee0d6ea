"""Host-path pipeline training over stage roles — the port's twin of
``examples/pipeline_train.py``.

A small causal TransformerLM is split into ``--stages`` contiguous layer
spans; each span is a role (``stage0..stage{S-1}``) and microbatch
activations/gradients flow through the bounded typed channels
:func:`tpu_dist_torch.pipeline.build_pipeline_graph` wires up (act-edge
depth = the schedule's warmup credits — the flow control IS the channel
depth).  Run it under the role-graph launcher::

    python -m tpu_dist_torch.launch --roles stage0:1,stage1:1:gang \\
        -m tpu_dist_torch.examples.pipeline_train --out ./pipe_out

Pipeline launches get the ``--verify_graph`` pre-flight automatically:
launched by path, the launcher model-checks :func:`build_graph`'s graph
(which reads the same ``PIPELINE_*`` env knobs as the JAX example's) and
refuses an under-depth act/grad ring before anything is spawned; launched
with ``-m``, it checks the ``--roles`` spec.

Data parallelism composes per stage (``--dp N`` plus a matching ``--roles
stage0:N,...`` spec): each stage's lanes run the existing bucketed/ZeRO
grad sync over the role sub-group, unchanged.

Every rank checkpoints its own param/optimizer **slice** through
:class:`~tpu_dist_torch.resilience.TrainState` (``sharded_keys``), so a
stage-death gang restart (``TPU_DIST_CHAOS="kill:rank=1,step=4"``) resumes
the trajectory bit for bit: channels re-form under the new generation,
every rank restores its exact shard, and the per-step losses match an
uninterrupted run float for float.

Every rank builds its stage on ``cuda:0`` unless given ``--device cpu`` (the
graph's ranks share the node's first card; activations cross the channels
through the host).  The batches and the model's sizes are the JAX
example's; the weights are the port's seeded initialization.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["build_graph", "batch_for_step", "main"]

VOCAB, DIM, DEPTH, HEADS, SEQ = 31, 16, 4, 2, 12


def _env_int(name, default):
    return int(os.environ.get(name, default) or default)


def build_graph(num_stages=None, dp=None, num_microbatches=None,
                schedule=None):
    """The example's role graph.  A no-argument call reads the PIPELINE_*
    env knobs (``PIPELINE_STAGES``, ``PIPELINE_DP``,
    ``PIPELINE_MICROBATCHES``, ``PIPELINE_SCHEDULE``,
    ``PIPELINE_ACT_DEPTH``), as the JAX example's does.  The launcher's
    pre-flight loads this file by path, hence the absolute import."""
    from tpu_dist_torch.pipeline import build_pipeline_graph

    env = os.environ
    act_depth = (int(env["PIPELINE_ACT_DEPTH"])
                 if env.get("PIPELINE_ACT_DEPTH") else None)
    return build_pipeline_graph(
        num_stages if num_stages is not None
        else _env_int("PIPELINE_STAGES", 2),
        dp=dp if dp is not None else _env_int("PIPELINE_DP", 1),
        num_microbatches=num_microbatches if num_microbatches is not None
        else _env_int("PIPELINE_MICROBATCHES", 4),
        schedule=schedule or env.get("PIPELINE_SCHEDULE", "gpipe"),
        act_depth=act_depth)


def batch_for_step(step: int, lane: int, batch_size: int):
    """Deterministic per-(step, lane) batch (the JAX example's): stage 0 and
    the last stage derive x and y from the same seed, so they agree without
    a channel; reruns and post-restart resumes replay the same values."""
    import numpy as np

    rng = np.random.default_rng(1_000_003 * step + 7 * lane + 1)
    x = rng.integers(0, VOCAB, size=(batch_size, SEQ), dtype=np.int32)
    y = rng.integers(0, VOCAB, size=(batch_size, SEQ), dtype=np.int32)
    return x, y


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int,
                    default=_env_int("PIPELINE_STAGES", 2),
                    help="pipeline depth — must match the --roles spec")
    ap.add_argument("--dp", type=int, default=_env_int("PIPELINE_DP", 1),
                    help="data lanes per stage — must match the spec")
    ap.add_argument("--microbatches", type=int,
                    default=_env_int("PIPELINE_MICROBATCHES", 4))
    ap.add_argument("--schedule",
                    default=os.environ.get("PIPELINE_SCHEDULE", "gpipe"),
                    choices=("gpipe", "1f1b"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per-lane batch (must divide by --microbatches)")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--grad-sync", default=None,
                    choices=(None, "none", "bucket", "zero"),
                    help="intra-stage dp grad sync (default: bucket when "
                         "dp > 1)")
    ap.add_argument("--compress", default=None,
                    help="activation wire compression, e.g. int8_block64 "
                         "(lossy — parity gates run without it)")
    ap.add_argument("--out", type=str, default="./pipeline_out")
    ap.add_argument("--state-root", type=str, default=None,
                    help="TrainState checkpoint root (enables resume)")
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    restart_count = _env_int("TPU_DIST_RESTART_COUNT", 0)
    if restart_count > 0:
        # the injected fault simulated the FIRST incarnation's death; the
        # respawned gang must not replay it (TrainState installs chaos
        # from env, so drop it before the trainer comes up)
        os.environ.pop("TPU_DIST_CHAOS", None)

    from .. import nn, optim, resilience
    from ..models import TransformerLM
    from ..ops._build import resolve_device
    from ..pipeline import PipelineTrainer
    from ..roles import init_role_graph

    device = resolve_device("cpu" if args.device == "cpu" else None)
    graph = build_graph(args.stages, args.dp, args.microbatches,
                        args.schedule)
    with init_role_graph(graph) as ctx:
        print(f"[pipeline_train] rank {ctx.rank} = {ctx.role}"
              f"[{ctx.role_rank}] (generation {ctx.generation})",
              flush=True)
        model = TransformerLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH,
                              num_heads=HEADS, max_seq_len=SEQ,
                              device=device)
        trainer = PipelineTrainer(
            ctx, model, optim.SGD(lr=args.lr), nn.CrossEntropyLoss(),
            num_microbatches=args.microbatches, schedule=args.schedule,
            compress=args.compress, grad_sync=args.grad_sync)
        losses, stash_bytes, stash_count = {}, 0, 0
        start = 0
        ts = None
        if args.state_root:
            ts = resilience.TrainState(
                args.state_root, save_every=args.save_every, keep=None,
                shard=(ctx.rank, ctx.graph.world),
                sharded_keys=("params", "opt_state"))
            state, start = ts.resume(trainer.state_dict())
            trainer.load_state_dict(state)
            if start:
                print(f"[pipeline_train] resumed at step {start}",
                      flush=True)
        try:
            for step in range(start, args.steps):
                x, y = batch_for_step(step, ctx.role_rank, args.batch_size)
                m = trainer.step(x if trainer.is_first else None,
                                 y if trainer.is_last else None).wait(300)
                if m["loss"] is not None:
                    losses[str(step)] = m["loss"]
                stash_bytes = max(stash_bytes, m["stash_peak_bytes"])
                stash_count = max(stash_count, m["stash_peak_count"])
                if ts is not None:
                    ts.end_step(trainer.state_dict(), step)
        finally:
            if ts is not None:
                ts.close()
            trainer.close()
        out = {"role": ctx.role, "lane": ctx.role_rank, "rank": ctx.rank,
               "generation": ctx.generation,
               "restart_count": restart_count,
               "schedule": args.schedule, "start": start,
               "losses": losses, "stash_peak_bytes": stash_bytes,
               "stash_peak_count": stash_count}
        path = os.path.join(
            args.out, f"{ctx.role}_l{ctx.role_rank}_g{ctx.generation}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        if trainer.is_last and losses:
            ks = sorted(losses, key=int)
            print(f"[pipeline_train] {args.schedule} done: "
                  f"loss {losses[ks[0]]:.4f} -> {losses[ks[-1]]:.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
