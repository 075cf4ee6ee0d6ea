"""CIFAR-10 ResNet-18 data-parallel training — the port's twin of
``examples/example_mp.py`` (the reference tutorial's CIFAR script).

The same recipe: batch 256 per rank, resnet18(num_classes=10) with
torchvision's ImageNet stem, RandomCrop(32, 4) + HorizontalFlip with the
reference's normalization, ``DistributedSampler(shuffle=True)`` with
``set_epoch``, SGD lr 0.02, momentum 0.9, weight decay 1e-4, nesterov;
rank 0 logs every 25 steps.  ``--bf16`` computes in bfloat16 over float32
masters, ``--sync-bn`` makes BatchNorm cross-replica, ``--evaluate`` runs
the test set.  ``--checkpoint-dir`` saves the TrainState every
``--checkpoint-every`` steps and at the end (keeping the newest 3), and
``--resume`` continues from the newest checkpoint there: rank 0 decides
whether to restore or start fresh, and above one process broadcasts the
decision.  ``--device cuda|cpu`` (default ``cuda``) takes the place of
``--backend``; ``--spawn`` starts ``-g`` processes, one card each, that meet
at ``--dist-url tcp://host:port`` (else at ``MASTER_ADDR``/``MASTER_PORT``)::

    python -m tpu_dist_torch.examples.example_mp --synthetic --epochs 1
    python -m tpu_dist_torch.examples.example_mp --device cpu --spawn -g 2 \\
        --synthetic --max-steps 3 --evaluate
    python -m tpu_dist_torch.examples.example_mp --synthetic \\
        --checkpoint-dir ckpt --resume
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

__all__ = ["parse_args", "train", "main"]

BATCH_SIZE = 256
EPOCHS = 5


def train(args, rank=None, world_size=None) -> dict:
    """Train (and with ``--evaluate`` evaluate) as the script does; returns
    ``{"state", "ddp", "losses", "eval"}``.  ``rank``/``world_size`` set
    this process's place in a ``--dist-url`` world (``--node_rank`` and
    ``--nodes`` by default)."""
    import torch

    from .. import checkpoint, collectives, dist, nn, optim
    from ..data import (CIFAR10, DataLoader, DeviceLoader, DistributedSampler,
                        transforms)
    from ..models import resnet18
    from ..parallel import DistributedDataParallel

    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    init_method = args.dist_url
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    kw = {}
    if init_method and init_method.startswith("tcp://"):
        kw = dict(world_size=args.nodes if world_size is None else world_size,
                  rank=args.node_rank if rank is None else rank)
    device = "cpu" if args.device == "cpu" else None
    pg = dist.init_process_group(init_method=init_method, device=device, **kw)
    try:
        rank = dist.get_rank()
        world = dist.get_world_size()
        print(f"[init] == process rank {rank}, {world} device replicas ==",
              flush=True)

        model = resnet18(num_classes=10, device=pg.device)
        ddp = DistributedDataParallel(
            model,
            optimizer=optim.SGD(lr=0.01 * 2, momentum=0.9,
                                weight_decay=1e-4, nesterov=True),
            loss_fn=nn.CrossEntropyLoss(), group=pg,
            sync_batchnorm=args.sync_bn,
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        state = ddp.init(seed=0)
        if args.resume:
            # every rank takes the same restore-or-fresh branch: rank 0
            # decides and the decision is broadcast, so a directory that
            # is not shared fails loudly on the other ranks instead of
            # letting them diverge
            last = None
            if rank == 0:
                last = checkpoint.latest_step(args.checkpoint_dir)
            if world > 1:
                (last,) = collectives.broadcast_object_list([last], src=0,
                                                            group=pg)
            if last is None:
                if rank == 0:
                    print(f"no checkpoint under {args.checkpoint_dir}; "
                          f"starting fresh", flush=True)
            else:
                state = checkpoint.restore(
                    args.checkpoint_dir, state, step=last,
                    device=checkpoint.devices(state))
                if rank == 0:
                    print(f"resumed from step {last}", flush=True)

        aug = transforms.Compose([
            transforms.RandomCrop(32, padding=4),
            transforms.RandomHorizontalFlip(),
            transforms.Normalize(transforms.CIFAR10_MEAN,
                                 transforms.CIFAR10_STD),
        ])
        ds = CIFAR10(root=args.data_root, train=True, transform=aug,
                     synthetic_fallback=args.synthetic or None)
        world_batch = args.batch_size * world
        sampler = DistributedSampler(ds, num_replicas=world, rank=rank,
                                     shuffle=True)
        loader = DeviceLoader(
            DataLoader(ds, batch_size=args.batch_size, sampler=sampler,
                       drop_last=True, num_workers=4, pin_memory=True),
            group=pg)

        total_step = len(loader)
        start = datetime.now()
        steps = 0
        last_saved = -1
        losses = []
        for ep in range(args.epochs):
            sampler.set_epoch(ep)  # epoch-seeded reshuffle
            running_loss, running_correct, seen = 0.0, 0, 0
            for i, (images, labels) in enumerate(loader):
                state, metrics = ddp.train_step(state, images, labels)
                losses.append(metrics["loss"])
                # sums stay on the card; the host reads them every 25 steps
                running_loss = running_loss + metrics["loss"]
                running_correct = running_correct + metrics["correct"]
                seen += world_batch
                steps += 1
                if (i + 1) % 25 == 0 and rank == 0:
                    print("[{}] Epoch [{}/{}], Step [{}/{}], "
                          "loss: {:.3f}, acc: {:.3f}".format(
                              datetime.now().strftime("%H:%M:%S"),
                              ep + 1, args.epochs, i + 1, total_step,
                              float(running_loss) / 25,
                              int(running_correct) / max(seen, 1)),
                          flush=True)
                if (i + 1) % 25 == 0:
                    running_loss, running_correct, seen = 0.0, 0, 0
                if args.checkpoint_dir and steps % args.checkpoint_every == 0:
                    last_saved = state.step
                    checkpoint.save(args.checkpoint_dir, state,
                                    step=last_saved, keep=3)
                if args.max_steps and steps >= args.max_steps:
                    break
            if args.max_steps and steps >= args.max_steps:
                break
        if args.checkpoint_dir and state.step != last_saved:
            checkpoint.save(args.checkpoint_dir, state, step=state.step,
                            keep=3)
        if rank == 0:
            print("Training complete in: " + str(datetime.now() - start),
                  flush=True)

        res = None
        if args.evaluate:
            test_ds = CIFAR10(
                root=args.data_root, train=False,
                transform=transforms.Normalize(transforms.CIFAR10_MEAN,
                                               transforms.CIFAR10_STD),
                synthetic_fallback=args.synthetic or None)
            # every rank reads the same sequential global batches and keeps
            # its slice: the test set is covered once, the count is exact
            test_loader = DeviceLoader(
                DataLoader(test_ds, batch_size=world_batch, drop_last=False,
                           num_workers=4, pin_memory=True),
                group=pg, local_shards=False)
            res = ddp.evaluate(state, test_loader)
            if rank == 0:
                print("Test: loss {:.3f}, acc {:.3f} ({} samples)".format(
                    res["loss"], res["accuracy"], res["count"]), flush=True)
        return {"state": state, "ddp": ddp, "losses": losses, "eval": res}
    finally:
        dist.destroy_process_group()


def _spawn_worker(local_rank, args):
    os.environ["LOCAL_RANK"] = str(local_rank)
    world = args.nodes * args.ngpus_per_node
    rank = args.node_rank * args.ngpus_per_node + local_rank
    if args.dist_url is None:
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", "29502")
        os.environ["RANK"] = str(rank)
        os.environ["WORLD_SIZE"] = str(world)
    train(args, rank=rank, world_size=world)


def _positive(v):
    v = int(v)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", default=1, type=int)
    parser.add_argument("-g", "--ngpus_per_node", default=0, type=int,
                        help="processes (one card each) per node with "
                             "--spawn; 0 = one per local card (one on the "
                             "CPU)")
    parser.add_argument("--dist-url", default=None, type=str,
                        help="tcp://host:port rendezvous")
    parser.add_argument("--node_rank", default=0, type=int)
    parser.add_argument("--epochs", default=EPOCHS, type=int)
    parser.add_argument("--batch-size", default=BATCH_SIZE, type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--spawn", action="store_true",
                        help="start -g processes, one card each")
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--sync-bn", action="store_true")
    parser.add_argument("--max-steps", default=0, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute over float32 masters")
    parser.add_argument("--evaluate", action="store_true",
                        help="run test-set evaluation after training")
    parser.add_argument("--checkpoint-dir", default=None, type=str,
                        help="save TrainState checkpoints here")
    parser.add_argument("--checkpoint-every", default=100, type=_positive,
                        help="steps between checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "--checkpoint-dir")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.spawn:
        import torch

        from ..launch import spawn
        args.ngpus_per_node = args.ngpus_per_node or (
            torch.cuda.device_count() if args.device == "cuda" else 1)
        spawn(_spawn_worker, args=(args,), nprocs=args.ngpus_per_node)
    else:
        train(args)


if __name__ == "__main__":
    main()
