"""MNIST ConvNet data-parallel training — the port's twin of
``examples/mpspawn_dist.py`` (the reference tutorial's ``mp.spawn`` script).

The same flags, hyperparameters (batch 100 per rank, SGD lr 1e-4, seed 0)
and rank-0 log lines, except that ``--device cuda|cpu`` (default ``cuda``)
takes the place of ``--backend tpu|cpu``.  One process drives one card:
``--spawn`` starts ``-g`` processes, and process ``i`` takes
``cuda:LOCAL_RANK`` (NCCL between cards, gloo on the CPU)::

    python -m tpu_dist_torch.examples.mpspawn_dist --synthetic --epochs 1
    python -m tpu_dist_torch.examples.mpspawn_dist --device cpu --spawn \\
        -g 2 --synthetic --max-steps 3 --evaluate

Without ``--spawn`` it runs this process alone, or joins the world that
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` describe.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

__all__ = ["parse_args", "train", "main"]


def train(args) -> dict:
    """Train (and with ``--evaluate`` evaluate) as the script does; returns
    ``{"state", "ddp", "losses", "eval"}`` (every step's loss as a device
    scalar, the evaluation's result or None)."""
    from .. import dist, nn, optim
    from ..data import (MNIST, DataLoader, DeviceLoader, DistributedSampler,
                        transforms)
    from ..models import ConvNet
    from ..parallel import DistributedDataParallel

    init_method = "env://" if "MASTER_ADDR" in os.environ else None
    device = "cpu" if args.device == "cpu" else None
    pg = dist.init_process_group(init_method=init_method, device=device)
    try:
        rank = dist.get_rank()
        world = dist.get_world_size()
        if rank == 0:
            print(f"My rank is {rank} of {world} processes; {world} device "
                  f"replicas", flush=True)

        model = ConvNet(device=pg.device)
        ddp = DistributedDataParallel(
            model, optimizer=optim.SGD(lr=args.lr),
            loss_fn=nn.CrossEntropyLoss(), group=pg)
        state = ddp.init(seed=0)  # == torch.manual_seed(0) on every rank
        if rank == 0:
            print("load model sucessfully!" if args.ref_logs
                  else "model ready (replicated on every rank)", flush=True)

        normalize = transforms.Normalize(transforms.MNIST_MEAN,
                                         transforms.MNIST_STD)
        ds = MNIST(root=args.data_root, train=True, transform=normalize,
                   synthetic_fallback=args.synthetic or None)
        sampler = DistributedSampler(ds, num_replicas=world, rank=rank,
                                     shuffle=False)
        loader = DeviceLoader(
            DataLoader(ds, batch_size=args.batch_size, sampler=sampler,
                       drop_last=True, num_workers=2),
            group=pg, prefetch=2)
        if rank == 0:
            print("Load data....done!", flush=True)

        total_step = len(loader)
        start = datetime.now()
        steps = 0
        losses = []
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            for i, (images, labels) in enumerate(loader):
                state, metrics = ddp.train_step(state, images, labels)
                losses.append(metrics["loss"])
                steps += 1
                if (i + 1) % 100 == 0 and rank == 0:
                    print("Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}".format(
                        epoch + 1, args.epochs, i + 1, total_step,
                        float(metrics["loss"])), flush=True)
                if args.max_steps and steps >= args.max_steps:
                    break
            if args.max_steps and steps >= args.max_steps:
                break
        if rank == 0:
            print("Training complete in: " + str(datetime.now() - start),
                  flush=True)

        res = None
        if args.evaluate:
            test_ds = MNIST(root=args.data_root, train=False,
                            transform=normalize,
                            synthetic_fallback=args.synthetic or None)
            # every rank reads the same sequential global batches and keeps
            # its slice: the test set is covered once, the count is exact
            test_loader = DeviceLoader(
                DataLoader(test_ds, batch_size=args.batch_size * world,
                           drop_last=False, num_workers=2),
                group=pg, local_shards=False)
            res = ddp.evaluate(state, test_loader)
            if rank == 0:
                print("Test: loss {:.3f}, acc {:.3f} ({} samples)".format(
                    res["loss"], res["accuracy"], res["count"]), flush=True)
        return {"state": state, "ddp": ddp, "losses": losses, "eval": res}
    finally:
        dist.destroy_process_group()


def _spawn_worker(local_rank, args):
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ.setdefault("MASTER_PORT", "29501")
    os.environ["RANK"] = str(args.nr * args.gpus + local_rank)
    os.environ["WORLD_SIZE"] = str(args.gpus * args.nodes)
    os.environ["LOCAL_RANK"] = str(local_rank)
    train(args)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-n", "--nodes", default=1, type=int, metavar="N")
    parser.add_argument("-g", "--gpus", default=0, type=int,
                        help="processes (one card each) per node; 0 = one "
                             "per local card (one on the CPU)")
    parser.add_argument("-nr", "--nr", default=0, type=int,
                        help="ranking within the nodes")
    parser.add_argument("--epochs", default=2, type=int, metavar="N")
    parser.add_argument("--batch-size", default=100, type=int,
                        help="per-rank batch (ref: 100)")
    parser.add_argument("--lr", default=1e-4, type=float,
                        help="SGD learning rate (ref: 1e-4)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--spawn", action="store_true",
                        help="start -g processes, one card each")
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the deterministic synthetic MNIST")
    parser.add_argument("--max-steps", default=0, type=int)
    parser.add_argument("--evaluate", action="store_true",
                        help="run test-set evaluation after training")
    parser.add_argument("--ref-logs", action="store_true",
                        help="emit the reference's exact breadcrumb strings")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.spawn:
        import torch

        from ..launch import spawn
        args.gpus = args.gpus or (torch.cuda.device_count()
                                  if args.device == "cuda" else 1)
        spawn(_spawn_worker, args=(args,), nprocs=args.gpus)
    else:
        train(args)


if __name__ == "__main__":
    main()
