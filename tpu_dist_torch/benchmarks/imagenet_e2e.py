"""ResNet-50 ImageNet-shape training with the input pipeline in the loop —
sustained images/s on the card.

The port's twin of the JAX package's ``benchmarks/imagenet_e2e.py``: the
host fancy-indexes raw uint8 256×256 images out of an in-RAM array
(``DataLoader(to_float=False)``), ``DeviceLoader(prefetch=3)`` pins and
copies them to the card and runs ``DeviceAugment.imagenet(224, bf16)``
there, and the DDP step (ResNet-50, 1000 classes, SGD 0.1/0.9/1e-4, bf16
over float32 masters) consumes them: the components and defaults of the
``example_imagenet`` twin.  One warm epoch, then ``epochs`` epochs timed by
the host clock, synchronized at both ends (the loss is read once, at the
end).  The step alone is then timed with CUDA events on one augmented
batch, so the two rates say what the feed costs, beside the least time an
H100 could take for the step (``step_bound``).  Data from
``np.random.default_rng(0)``.

    python -m tpu_dist_torch.benchmarks.imagenet_e2e
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import dist, nn, optim
from ..data import (ArrayImageDataset, DataLoader, DeviceAugment,
                    DeviceLoader, DistributedSampler)
from ..models import resnet50
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel

__all__ = ["build", "run", "forward_flops", "step_bound"]

# H100 SXM data-sheet peaks (dense bf16 tensor rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def forward_flops(model, image_size: int, device) -> int:
    """Multiply-adds × 2 of one image's forward through ``model``'s
    ``Conv2d`` and ``Linear`` layers, counted from their output shapes."""
    from ..nn import Conv2d, Linear
    total = [0]

    def conv(m, _, out):
        kh, kw = m.kernel_size
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    def linear(m, _, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2d)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2d, Linear))]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, image_size, image_size, device=device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]


def step_bound(step_flops: float, state, x, y) -> dict:
    """The least time of a training step on an H100: the larger of its
    operations over the bf16 tensor peak and the bytes it must move (the
    batch and labels read; every float32 parameter and optimizer buffer
    read and written once) over the memory rate."""
    def tensors(tree):
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from tensors(v)

    kept = {"params": state.params, "opt": state.opt_state}
    moved = (x.numel() * x.element_size() + y.numel() * y.element_size()
             + 2 * sum(t.numel() * t.element_size() for t in tensors(kept)))
    t_ops = step_flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = moved / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "step_flops": step_flops, "step_bytes": moved}


def build(batch: int = 128, image_size: int = 224, group=None, device=None):
    """The benchmark's DDP wrapper and one random batch for the step alone:
    ``(ddp, x, y)``, ``x`` (batch, 3, image_size, image_size) bf16, as the
    device augmentation delivers it."""
    device = resolve_device(device)
    ddp = DistributedDataParallel(
        resnet50(num_classes=1000, device=device),
        optimizer=optim.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 3, image_size, image_size)).astype(np.float32)
    y = rng.integers(0, 1000, batch)
    return (ddp, torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(y).to(device))


def run(batch: int = 128, image_size: int = 224, raw_size: int = 256,
        n_images: int = 2048, epochs: int = 3, prefetch: int = 3,
        step_reps: int = 10, num_workers: int = 4, device=None) -> dict:
    """Sustained images/s/GPU over ``epochs`` epochs of ``n_images`` after a
    warm one, and images/s/GPU of the step alone."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card; on the CPU drive the "
                           "example_imagenet twin instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        world = pg.size()
        rng = np.random.default_rng(0)
        x = rng.integers(0, 256, (n_images, raw_size, raw_size, 3), np.uint8)
        y = rng.integers(0, 1000, n_images).astype(np.int64)
        ds = ArrayImageDataset(x, y)
        host = DataLoader(ds, batch_size=batch, drop_last=True,
                          sampler=DistributedSampler(ds, world, pg.rank),
                          num_workers=num_workers, to_float=False)
        loader = DeviceLoader(host, group=pg, prefetch=prefetch,
                              augment=DeviceAugment.imagenet(
                                  image_size, dtype=torch.bfloat16))
        ddp, xs, ys = build(batch, image_size, group=pg, device=pg.device)
        torch.cuda.reset_peak_memory_stats(pg.device)
        state = ddp.init(seed=0)
        m = None
        for images, labels in loader:  # warm epoch
            state, m = ddp.train_step(state, images, labels)
        float(m["loss"])
        t0 = time.perf_counter()
        steps = 0
        for ep in range(1, epochs + 1):
            loader.set_epoch(ep)
            for images, labels in loader:
                state, m = ddp.train_step(state, images, labels)
                steps += 1
        last_loss = float(m["loss"])  # one read: the queue drains here
        wall = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(step_reps):
            state, m = ddp.train_step(state, xs, ys)
        end.record()
        torch.cuda.synchronize(pg.device)
        step_ms = start.elapsed_time(end) / step_reps
        peak = torch.cuda.max_memory_allocated(pg.device)
        # forward and backward: 3x the forward's products
        bound = step_bound(3 * batch * forward_flops(
            ddp.module, image_size, pg.device), state, xs, ys)
    finally:
        if own_group:
            dist.destroy_process_group()
    return {
        "metric": "resnet50_imagenet_e2e_sustained_images_per_sec_per_gpu",
        "value": steps * batch / wall,
        "unit": "images/sec/gpu (host loader and device augmentation in "
                "the loop)",
        "steps": steps, "wall_s": wall, "last_loss": last_loss,
        "step_only_ms": step_ms,
        "step_only_images_per_sec": batch / (step_ms / 1e3),
        **bound, "peak_mem_bytes": peak, "per_gpu_batch": batch,
        "image_size": image_size, "raw_size": raw_size,
        "h2d_bytes_per_batch": batch * raw_size * raw_size * 3,
        "pipeline": f"raw uint8 gather -> DeviceLoader(prefetch={prefetch}, "
                    f"pinned copy) -> DeviceAugment.imagenet (bf16) -> DDP "
                    f"bf16 step",
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "device": torch.cuda.get_device_name(pg.device), "world_size": world,
    }


if __name__ == "__main__":
    print(json.dumps(run()))
