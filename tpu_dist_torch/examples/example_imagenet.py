"""ImageNet-class data-parallel training — the port's twin of
``examples/example_imagenet.py`` (ResNet-50 or ViT-B/16 at 224×224, 1000
classes, the scaled-up form of the reference tutorial's CIFAR script).

The same options and defaults, except that ``--device cuda|cpu`` (default
``cuda``) takes the place of ``--backend tpu|cpu``: per-replica batch 128,
ResNet-50 with SGD lr 0.1, momentum 0.9, weight decay 1e-4, or ``--model
vit_b_16`` with AdamW lr 3e-4, weight decay 0.05; bfloat16 compute over
float32 masters unless ``--no-bf16``.  The host gathers raw uint8 images
(``DataLoader(to_float=False)``) and ``DeviceLoader(prefetch=3)`` stages
them on the card, where ``DeviceAugment.imagenet`` does RandomResizedCrop,
flip and Normalize; ``--host-augment`` does those on the host instead.
``--evaluate`` scores a held-out split through ``Resize`` +
``CenterCrop`` (``DeviceAugment.imagenet_eval`` on the card, or the host
transforms under ``--host-augment``).  Data: ``--imagefolder PATH`` reads a
``root/<class>/<image>`` tree (``.npy`` images where PIL is missing),
otherwise the deterministic ``SyntheticImageNet`` of ``--synthetic-size``
images.  One process drives one card; it runs alone or joins the world
that ``--dist-url tcp://host:port`` with ``--nodes``/``--node_rank``, or
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, describe::

    python -m tpu_dist_torch.examples.example_imagenet --max-steps 30
    python -m tpu_dist_torch.examples.example_imagenet --model vit_b_16 \\
        --batch-size 64 --max-steps 20
    python -m tpu_dist_torch.examples.example_imagenet --device cpu \\
        --image-size 32 --synthetic-size 64 --max-steps 2 --evaluate
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
    import torch

    from .. import dist, nn, optim
    from ..data import (DataLoader, DeviceAugment, DeviceLoader,
                        DistributedSampler, ImageFolder, SyntheticImageNet,
                        transforms)
    from ..models import resnet50, vit_b_16
    from ..parallel import DistributedDataParallel

    if args.model == "vit_b_16" and args.image_size % 16:
        raise SystemExit("--model vit_b_16 needs --image-size divisible by "
                         "16")
    init_method = args.dist_url
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    kw = {}
    if init_method and init_method.startswith("tcp://"):
        kw = dict(world_size=args.nodes, rank=args.node_rank)
    device = "cpu" if args.device == "cpu" else None
    pg = dist.init_process_group(init_method=init_method, device=device, **kw)
    try:
        rank = dist.get_rank()
        world = dist.get_world_size()
        print(f"[init] == process rank {rank}, {world} device replicas ==",
              flush=True)
        compute_dtype = None if args.no_bf16 else torch.bfloat16
        out_dtype = torch.float32 if args.no_bf16 else torch.bfloat16
        resized = (args.image_size + 32, args.image_size + 32)

        host_aug = None
        if args.host_augment:
            host_aug = transforms.Compose([
                transforms.RandomResizedCrop(args.image_size),
                transforms.RandomHorizontalFlip(),
                transforms.Normalize(transforms.IMAGENET_MEAN,
                                     transforms.IMAGENET_STD)])
        if args.imagefolder:
            ds = ImageFolder(args.imagefolder, transform=host_aug,
                             sample_size=resized)
            num_classes = len(ds.classes)
        else:
            ds = SyntheticImageNet(train=True, n=args.synthetic_size,
                                   image_size=args.image_size,
                                   num_classes=args.num_classes,
                                   transform=host_aug)
            num_classes = args.num_classes

        if args.model == "vit_b_16":
            model = vit_b_16(num_classes=num_classes,
                             image_size=args.image_size, device=pg.device)
            optimizer = optim.AdamW(lr=3e-4, weight_decay=0.05)
        else:
            model = resnet50(num_classes=num_classes, device=pg.device)
            optimizer = optim.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
        ddp = DistributedDataParallel(
            model, optimizer=optimizer, loss_fn=nn.CrossEntropyLoss(),
            group=pg, sync_batchnorm=args.sync_bn,
            compute_dtype=compute_dtype)
        state = ddp.init(seed=0)

        world_batch = args.batch_size * world
        sampler = DistributedSampler(ds, num_replicas=world, rank=rank,
                                     shuffle=True)
        dev_aug = None if args.host_augment else DeviceAugment.imagenet(
            args.image_size, dtype=out_dtype)
        loader = DeviceLoader(
            DataLoader(ds, batch_size=args.batch_size, sampler=sampler,
                       drop_last=True, num_workers=args.num_workers,
                       to_float=args.host_augment),
            group=pg, augment=dev_aug, prefetch=3)

        total_step = len(loader)
        start = datetime.now()
        steps = 0
        losses = []
        for ep in range(args.epochs):
            loader.set_epoch(ep)  # the sampler's shuffle and the augment keys
            running_loss, running_correct, seen = 0.0, 0, 0
            for i, (images, labels) in enumerate(loader):
                state, metrics = ddp.train_step(state, images, labels)
                losses.append(metrics["loss"])
                # sums stay on the card; the host reads them every 10 steps
                running_loss = running_loss + metrics["loss"]
                running_correct = running_correct + metrics["correct"]
                seen += world_batch
                steps += 1
                if (i + 1) % 10 == 0 and rank == 0:
                    print("[{}] Epoch [{}/{}], Step [{}/{}], "
                          "loss: {:.3f}, acc: {:.3f}".format(
                              datetime.now().strftime("%H:%M:%S"), ep + 1,
                              args.epochs, i + 1, total_step,
                              float(running_loss) / (i + 1),
                              int(running_correct) / seen), flush=True)
                if args.max_steps and steps >= args.max_steps:
                    break
            if args.max_steps and steps >= args.max_steps:
                break
        if rank == 0:
            print("Training complete in: " + str(datetime.now() - start),
                  flush=True)

        res = None
        if args.evaluate:
            if args.imagefolder:
                ev_ds = ImageFolder(args.imagefolder, sample_size=resized)
            else:
                ev_ds = SyntheticImageNet(
                    train=False, n=max(args.synthetic_size // 4, 64),
                    image_size=args.image_size,
                    num_classes=args.num_classes)
            ev_aug = None
            if args.host_augment:
                ev_ds.transform = transforms.Compose([
                    transforms.Resize(args.image_size + 32),
                    transforms.CenterCrop(args.image_size),
                    transforms.Normalize(transforms.IMAGENET_MEAN,
                                         transforms.IMAGENET_STD)])
            else:
                # float32: evaluate runs the float32 masters
                ev_aug = DeviceAugment.imagenet_eval(
                    args.image_size, resize=args.image_size + 32)
            # every rank reads the same sequential global batches and keeps
            # its slice: the set is covered once, the count is exact
            ev_loader = DeviceLoader(
                DataLoader(ev_ds, batch_size=world_batch, drop_last=False,
                           num_workers=args.num_workers,
                           to_float=args.host_augment),
                group=pg, local_shards=False, augment=ev_aug)
            res = ddp.evaluate(state, ev_loader)
            if rank == 0:
                print("Eval: loss {:.3f}, acc {:.3f} ({} samples)".format(
                    res["loss"], res["accuracy"], res["count"]), flush=True)
        return {"state": state, "ddp": ddp, "losses": losses, "eval": res}
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dist-url", default=None, type=str,
                        help="tcp://host:port rendezvous")
    parser.add_argument("--nodes", default=1, type=int)
    parser.add_argument("--node_rank", default=0, type=int)
    parser.add_argument("--epochs", default=1, type=int)
    parser.add_argument("--batch-size", default=128, type=int,
                        help="per-replica batch")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--imagefolder", default=None, type=str,
                        help="ImageFolder root (default: SyntheticImageNet)")
    parser.add_argument("--model", default="resnet50",
                        choices=["resnet50", "vit_b_16"],
                        help="resnet50 (SGD .1/.9/1e-4) or vit_b_16 (AdamW "
                             "3e-4, weight decay .05)")
    parser.add_argument("--image-size", default=224, type=int)
    parser.add_argument("--num-classes", default=1000, type=int)
    parser.add_argument("--synthetic-size", default=2048, type=int)
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--host-augment", action="store_true",
                        help="crop, flip and normalize on the host (numpy "
                             "draws, the torch resample) instead of on the "
                             "card")
    parser.add_argument("--no-bf16", action="store_true",
                        help="float32 compute (default: bf16 over float32 "
                             "masters)")
    parser.add_argument("--sync-bn", action="store_true")
    parser.add_argument("--max-steps", default=0, type=int)
    parser.add_argument("--evaluate", action="store_true",
                        help="held-out evaluation after training (Resize + "
                             "CenterCrop)")
    parser.add_argument("--local_rank", default=None, type=int,
                        help="accepted for the classic launcher argv form")
    return parser.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
