"""Elastic MNIST training — the port's twin of ``examples/elastic_train.py``:
survives preemption, crashes and hung ranks.

The restartable ``launch_dist`` loop: :class:`tpu_dist_torch.resilience.
TrainState` checkpoints every ``--save-every`` steps, and after a
supervised restart every rank resumes from the newest checkpoint with the
loss trajectory of an uninterrupted run (batches are keyed on ``(rank,
step)`` with numpy, as in the JAX example).  The JAX example's flags and
hyperparameters (batch 100 per rank, SGD lr 0.01 momentum 0.9, keep 3),
plus ``--device cuda|cpu`` (default ``cuda``; ``--backend cpu``, the JAX
example's spelling, also takes the CPU) and ``--record PATH`` (each step's
loss and wall time, and the final parameters' sha256, as JSON lines, to
compare runs)::

    TPU_DIST_CHAOS="kill:rank=0,step=20" python -m tpu_dist_torch.launch \\
        --standalone --nproc_per_node=1 --max_restarts=1 \\
        -m tpu_dist_torch.examples.elastic_train --synthetic --max-steps 40 \\
        --save-every 10

(a fault runs after its step's save, so the restarted generation resumes at
step 21 and does not meet the fault again; a kill at a step past the newest
save would fire again in every generation).

With ``--elastic_world=MIN:MAX`` the world size itself is elastic (a rank
exiting ``PREEMPTED_EXIT_CODE`` re-forms the gang at the survivors, a
``GROW_EXIT_CODE`` at MAX), and ``--zero`` keeps each rank's optimizer shard
in a checkpoint of its own, resharded to the new world on resume::

    TPU_DIST_CHAOS="shrink:rank=1,step=20;grow:rank=0,step=35,world=2" \\
        python -m tpu_dist_torch.launch --standalone --nproc_per_node=2 \\
        --elastic_world=1:2 -m tpu_dist_torch.examples.elastic_train \\
        --device cpu --synthetic --zero --max-steps 50 --exit-on-preempt

The gradients are averaged by the :class:`~tpu_dist_torch.collectives.
Bucketer` (asynchronous bucketed all-reduce, the loss read back under it);
``--zero`` takes :class:`~tpu_dist_torch.parallel.ZeroOptimizer` instead
(reduce-scatter, the update on this rank's shard, the parameter all-gather
waited after the next batch is staged).  ``--exit-on-preempt``: on SIGTERM,
save at the next step boundary and exit ``PREEMPTED_EXIT_CODE`` (117).  On
the card cuDNN runs its deterministic algorithms, so a resumed run repeats
the uninterrupted one bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

__all__ = ["parse_args", "train", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", default=100, type=int)
    parser.add_argument("--backend", default=None, choices=["tpu", "cpu"],
                        help="the JAX example's flag: cpu takes the CPU")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--max-steps", default=100, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--ckpt-root", default="./ckpt_elastic")
    parser.add_argument("--save-every", default=25, type=int)
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1/2: reduce-scatter grads, shard the "
                             "optimizer state/update, overlap the param "
                             "all-gather")
    parser.add_argument("--exit-on-preempt", action="store_true",
                        help="on SIGTERM (cloud preemption notice): save "
                             "at the next step boundary and exit "
                             "PREEMPTED_EXIT_CODE (117) so a supervisor "
                             "running --elastic_world re-forms the gang "
                             "at the surviving rank count")
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="append each step's loss and wall time, and at "
                             "the end the parameters' sha256, as JSON lines")
    return parser.parse_args(argv)


def params_sha256(params) -> str:
    """sha256 over every parameter's name and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train(args, init_params=None) -> dict:
    """The example's loop in the launcher's world (or this process alone);
    ``init_params(model)`` replaces the seeded initialization (the tests
    load the JAX example's).  Returns ``{"losses": {step: loss},
    "params": {name: tensor}, "start": first step run}``."""
    import numpy as np
    import torch

    from .. import checkpoint, dist, optim, resilience
    from .. import collectives as C
    from ..data import synthetic_mnist_arrays
    from ..models import ConvNet
    from ..nn import functional as F
    from ..nn.module import reset_parameters
    from ..parallel import ZeroOptimizer
    from ..utils import MetricLogger, rank_zero_print

    cpu = args.device == "cpu" or args.backend == "cpu"
    pg = dist.init_process_group(
        init_method="env://" if "MASTER_ADDR" in os.environ else None,
        device="cpu" if cpu else None)
    dev = pg.device
    if dev.type == "cuda":
        # a resumed run must repeat the uninterrupted one bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    rank, nproc = dist.get_rank(), dist.get_num_processes()
    rank_zero_print(f"[elastic] generation {dist.generation()}, "
                    f"{nproc} processes")
    record = open(args.record, "a") if args.record else None

    def note(**fields):
        if record is not None:
            record.write(json.dumps(dict(gen=dist.generation(), rank=rank,
                                         t=time.time(), **fields)) + "\n")
            record.flush()

    try:
        model = ConvNet(device=dev)
        if init_params is None:
            reset_parameters(model, torch.Generator(device=dev).manual_seed(0))
        else:
            init_params(model)
        params0 = {k: p.detach().clone().requires_grad_(True)
                   for k, p in model.named_parameters()}
        opt = optim.SGD(lr=args.lr, momentum=0.9)
        if args.synthetic:
            images, labels = synthetic_mnist_arrays(train=True)
        else:
            from ..data import MNIST
            ds = MNIST(root="./data", train=True)
            images = np.stack([np.asarray(x) for x, _ in ds])
            labels = np.array([y for _, y in ds])
        # NCHW float32 in [0, 1], as the JAX example's NHWC / 255
        images = (images.reshape(-1, 28, 28, 1).astype(np.float32) / 255.0
                  ).transpose(0, 3, 1, 2)
        labels = labels.astype(np.int64)

        def batch(step):
            # keyed on (rank, step) ONLY: a resumed run replays the shard
            g = np.random.default_rng(10_000 * (rank + 1) + step)
            idx = g.integers(0, len(images), size=args.batch_size)
            return (torch.from_numpy(np.ascontiguousarray(images[idx])).to(
                dev), torch.from_numpy(labels[idx]).to(dev))

        def fwd_bwd(params, x, y):
            ps = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
            loss = F.cross_entropy(torch.func.functional_call(model, ps,
                                                              (x,)), y)
            grads = torch.autograd.grad(loss, list(ps.values()))
            return loss.detach(), dict(zip(ps, grads))

        log = MetricLogger(every=25,
                           fmt="[elastic] step {step} loss {loss:.4f}")
        stop = (checkpoint.GracefulShutdown().__enter__()
                if args.exit_on_preempt else None)

        def preempted(ts, state, step):
            """SIGTERM arrived: save now and exit the shrink protocol's
            code (``os._exit``: the checkpoint is fsync'd, and a teardown
            would wait on peers that are still running)."""
            if stop is None or not stop.requested:
                return
            ts.save(state, step)
            print(f"[elastic] rank preempted at step {step}; exiting "
                  f"{resilience.PREEMPTED_EXIT_CODE} for an elastic "
                  f"shrink", flush=True)
            os._exit(resilience.PREEMPTED_EXIT_CODE)

        losses = {}
        if args.zero:
            zopt = ZeroOptimizer(opt, group=pg)
            with resilience.TrainState(args.ckpt_root,
                                       save_every=args.save_every, keep=3,
                                       shard=(rank, nproc),
                                       sharded_keys=("zero",)) as ts:
                state, start = ts.resume({"params": params0,
                                          "zero": zopt.init(params0)})
                params, zstate = state["params"], state["zero"]
                if start:
                    rank_zero_print(f"[elastic] resumed at step {start} "
                                    f"(ZeRO)")
                handle = None
                for step in range(start, args.max_steps):
                    x, y = batch(step)      # staged under the in-flight …
                    if handle is not None:
                        params = handle.wait(timeout=300)  # … gather
                    loss, g = fwd_bwd(params, x, y)
                    rs = zopt.reduce_scatter(g, group=pg)
                    loss_now = float(loss)  # overlaps the reduce-scatter
                    handle, zstate = zopt.update(rs, zstate, group=pg)
                    losses[step] = loss_now
                    note(step=step, loss=loss_now)
                    log.push(step=step, loss=loss_now)
                    if args.save_every and step % args.save_every == 0:
                        params = handle.wait(timeout=300)  # the save's
                    ts.end_step({"params": params, "zero": zstate}, step)
                    if stop is not None and stop.requested:
                        params = handle.wait(timeout=300)
                        preempted(ts, {"params": params, "zero": zstate},
                                  step)
                if handle is not None:
                    params = handle.wait(timeout=300)
        else:
            bucketer = C.Bucketer()  # bucketed async grad sync (25 MiB)
            with resilience.TrainState(args.ckpt_root,
                                       save_every=args.save_every,
                                       keep=3) as ts:
                state, start = ts.resume({"params": params0,
                                          "opt": opt.init(params0)})
                params, opt_state = state["params"], state["opt"]
                if start:
                    rank_zero_print(f"[elastic] resumed at step {start}")
                for step in range(start, args.max_steps):
                    x, y = batch(step)
                    loss, g = fwd_bwd(params, x, y)
                    if nproc > 1:
                        # the loss read-back (a device sync) overlaps the
                        # bucketed all-reduce
                        work = bucketer.all_reduce(g, op="avg", group=pg)
                        loss_now = float(loss)
                        g = work.wait_all(timeout=300)
                    else:
                        loss_now = float(loss)
                    params, opt_state = opt.update(g, opt_state, params)
                    losses[step] = loss_now
                    note(step=step, loss=loss_now)
                    log.push(step=step, loss=loss_now)
                    ts.end_step({"params": params, "opt": opt_state}, step)
                    preempted(ts, {"params": params, "opt": opt_state},
                              step)
        note(final=params_sha256(params), start=start)
        rank_zero_print(f"[elastic] done at step {args.max_steps}")
        return {"losses": losses, "params": params, "start": start}
    finally:
        if record is not None:
            record.close()
        dist.destroy_process_group()


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
