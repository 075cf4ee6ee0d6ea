"""Can the loader feed the card?  The port's twin of the JAX package's
``benchmarks/input_pipeline.py`` (ROADMAP S9).

Two pipelines against the ResNet-50 bf16 step's rate:

(a) **host augment**, the reference's: RandomResizedCrop + flip +
    normalize in numpy on the host (``DataLoader`` threads), in images/s at
    each ``num_workers``;
(b) **device augment**: the host only gathers raw uint8 rows from an
    in-RAM array (the decoded-cache case; decoding is out of scope for
    both) and the card crops, flips and normalizes
    (:class:`~tpu_dist_torch.data.DeviceAugment`).  The card then spends
    ``1/aug + 1/step`` seconds an image, and the verdict
    ``loader_keeps_chip_fed`` is ``raw_host_rate >= 1 / (1/aug_rate +
    1/step_rate)``, the JAX rule.

Card times are CUDA events, medians (no differencing); host rates are the
best of ``repeats`` epochs on the host clock.  The ResNet-50 step is the
``imagenet_e2e`` twin's (batch 128, 224², bf16 compute over float32
masters, SGD with momentum).

    python -m tpu_dist_torch.benchmarks.input_pipeline
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..ops._build import resolve_device
from ._card import device_stamp, median_seconds

__all__ = ["host_augment_images_per_sec", "raw_host_images_per_sec",
           "device_augment_images_per_sec", "device_step_images_per_sec",
           "run"]


def _best_rate(loader, repeats: int) -> float:
    """Images/s of the fastest of ``repeats`` epochs of ``loader``, after
    one batch to warm it."""
    for _ in loader:
        break
    best = float("inf")
    for ep in range(repeats):
        loader.set_epoch(ep)
        t0 = time.perf_counter()
        seen = 0
        for x, _ in loader:
            seen += len(x)
        best = min(best, (time.perf_counter() - t0) / seen)
    return 1.0 / best


def host_augment_images_per_sec(num_workers: int, batch: int = 128,
                                n_images: int = 1024, image_size: int = 224,
                                repeats: int = 3) -> float:
    """The reference's pipeline: the whole augmentation on host threads."""
    from ..data import DataLoader, SyntheticImageNet, transforms

    aug = transforms.Compose([
        transforms.RandomResizedCrop(image_size),
        transforms.RandomHorizontalFlip(),
        transforms.Normalize(transforms.IMAGENET_MEAN,
                             transforms.IMAGENET_STD),
    ])
    ds = SyntheticImageNet(train=True, n=n_images, image_size=image_size,
                           num_classes=1000, transform=aug)
    return _best_rate(DataLoader(ds, batch_size=batch, shuffle=True,
                                 drop_last=True, num_workers=num_workers),
                      repeats)


def _raw_dataset(n_images: int, image_size: int):
    """The synthetic set gathered once into an in-RAM uint8 array: the raw
    path's host work a batch is then an index and a copy."""
    from ..data import ArrayImageDataset, SyntheticImageNet

    src = SyntheticImageNet(train=True, n=n_images, image_size=image_size,
                            num_classes=1000, transform=None)
    x, y = src.gather(np.arange(n_images))
    return ArrayImageDataset(x, y)


def raw_host_images_per_sec(batch: int = 128, n_images: int = 1024,
                            image_size: int = 224, repeats: int = 3) -> float:
    """The device-augment pipeline's host half: raw uint8 batches."""
    from ..data import DataLoader

    return _best_rate(DataLoader(_raw_dataset(n_images, image_size),
                                 batch_size=batch, shuffle=True,
                                 drop_last=True, to_float=False), repeats)


def device_augment_images_per_sec(batch: int = 128, image_size: int = 224,
                                  raw_size: int = 256, reps: int = 10,
                                  device=None) -> float:
    """The device-augment pipeline's card half: ``DeviceAugment.imagenet``
    (bf16 output) on a staged raw uint8 batch, a fresh key a call."""
    from .. import random
    from ..data import DeviceAugment

    device = resolve_device(device)
    aug = DeviceAugment.imagenet(image_size, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(
        0, 256, (batch, raw_size, raw_size, 3), np.uint8)).to(device)
    base = random.key(0)
    calls = iter(range(1 << 30))
    sec = median_seconds(lambda: aug(x8, random.fold_in(base, next(calls))),
                         device, reps, warm=2)
    return batch / sec


def device_step_images_per_sec(batch: int = 128, image_size: int = 224,
                               reps: int = 10, device=None) -> float:
    """Images/s of the ResNet-50 bf16 DDP step alone on one random batch."""
    from .imagenet_e2e import build

    device = resolve_device(device)
    ddp, x, y = build(batch=batch, image_size=image_size, device=device)
    state = ddp.init(seed=0)

    def step():
        nonlocal state
        state, _ = ddp.train_step(state, x, y)

    return batch / median_seconds(step, device, reps, warm=3)


def run(batch: int = 128, image_size: int = 224, raw_size: int = 256,
        n_images: int = 1024, workers=(0, 4), step_batch: int = None,
        repeats: int = 3, reps: int = 10, device=None) -> dict:
    """The row: host augmentation at each of ``workers``, the raw host
    gather (the best of ``repeats`` epochs each), the card's augmentation
    and the ResNet-50 step (at ``step_batch``, default ``batch``; medians
    of ``reps`` calls), and the verdict.  ``raw_size``: the edge of the
    cached raw images (the short-side-256 decode cache)."""
    device = resolve_device(device)
    host_aug = {w: host_augment_images_per_sec(
        w, batch=batch, n_images=n_images, image_size=image_size,
        repeats=repeats) for w in workers}
    raw_host = raw_host_images_per_sec(batch=batch, n_images=n_images,
                                       image_size=raw_size, repeats=repeats)
    dev_aug = device_augment_images_per_sec(batch=batch,
                                            image_size=image_size,
                                            raw_size=raw_size, reps=reps,
                                            device=device)
    step = device_step_images_per_sec(batch=step_batch or batch,
                                      image_size=image_size, reps=reps,
                                      device=device)
    consume = 1.0 / (1.0 / dev_aug + 1.0 / step)
    per_core = max(host_aug[workers[0]], 1e-9)
    return {
        "metric": "imagenet_input_pipeline_vs_resnet50_step",
        "host_augment_images_per_sec": host_aug,
        "raw_host_images_per_sec": raw_host,
        "device_augment_images_per_sec": dev_aug,
        "resnet50_bf16_step_images_per_sec": step,
        "chip_consume_images_per_sec": consume,
        "loader_over_step": raw_host / consume,
        "loader_keeps_chip_fed": raw_host >= consume,
        "host_cores": os.cpu_count() or 1,
        "host_augment_cores_to_feed_estimate": int(-(-step // per_core)),
        "batch": batch,
        "image_size": image_size,
        "raw_size": raw_size,
        "note": "raw path = in-RAM uint8 gather (decoded-cache case); "
                "augmentation on the card (data/device_augment.py)",
        **device_stamp(device),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
