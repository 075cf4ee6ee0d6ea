"""ResNet-18 CIFAR-10 DDP training throughput — images/s/GPU on the card.

The port's twin of the JAX package's ``benchmarks/resnet_cifar.py``: the
reference workload (resnet18(num_classes=10) on 32x32 with the ImageNet
stem; SGD lr 0.02, momentum 0.9, weight decay 1e-4, nesterov) through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with bfloat16
compute over float32 masters and the BatchNorm state threaded through the
step; one random batch from ``np.random.default_rng(0)`` repeated, as in the
JAX benchmark, timed with CUDA events after warm-up.  Headline batch 1024
per GPU; the reference recipe's 256 is the second row.  The result says
whether cuDNN may use TF32 (torch's default: yes).

    python -m tpu_dist_torch.benchmarks.resnet_cifar
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import resnet18
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel
from .convnet import DTYPES
from .transformer_lm import time_steps

__all__ = ["build", "run", "gspmd_steps"]


def build(batch: int = 1024, dtype: str = "bfloat16", group=None,
          device=None):
    """The benchmark's DDP wrapper and this rank's batch: ``(ddp, x, y)``
    with ``x`` (batch, 3, 32, 32) float32 and ``y`` (batch,) int64."""
    device = resolve_device(device)
    ddp = DistributedDataParallel(
        resnet18(num_classes=10, device=device),
        optimizer=optim.SGD(lr=0.02, momentum=0.9, weight_decay=1e-4,
                            nesterov=True),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=DTYPES[dtype])
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch * world, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, batch * world)
    rows = slice(rank * batch, (rank + 1) * batch)
    return (ddp, torch.from_numpy(x[rows]).to(device),
            torch.from_numpy(y[rows]).to(device))


def run(batch: int = 1024, steps: int = 30, warmup: int = 3,
        dtype: str = "bfloat16", device=None) -> dict:
    """Images/s/GPU of ``steps`` ResNet-18 DDP steps at ``batch`` per GPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(batch, dtype, group=pg, device=pg.device)
        res = time_steps(ddp, x, y, steps, warmup)
        n_params = sum(p.numel() for p in res["state"].params.values())
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    return {
        "metric": f"resnet18_cifar10_{dtype}_train_images_per_sec_per_gpu",
        "value": batch / (res["step_ms"] / 1e3),
        "unit": "images/sec/gpu",
        "step_ms": res["step_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "per_gpu_batch": batch,
        "dtype": dtype,
        "n_params": n_params,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "steps_run": warmup + steps,
        "losses": res["losses"],
    }


def gspmd_steps(batch: int = 256, steps: int = 2, lr: float = 0.1,
                device=None, dtype=torch.float32) -> dict:
    """``steps`` SGD steps of resnet18(num_classes=10), seed 0, in
    ``dtype`` (float64 shows how far float32's rounding moves a result),
    under the GSPMD step (``parallel.make_gspmd_train_step``: BatchNorm
    statistics over the global batch) on the default group's ``data``
    axis (world 1 without a group), on one global batch of ``batch``
    32x32 images from ``np.random.default_rng(0)`` (this rank takes its
    rows).  Returns each step's loss and wall ms (the card synchronized at
    both ends), the updates by name (after − before) and the running
    statistics ``{path: {"mean", "var"}}``."""
    import time

    from ..nn.module import reset_parameters
    from ..parallel import make_gspmd_train_step

    group = dist.get_default_group() if dist.is_initialized() else None
    device = group.device if group is not None else resolve_device(device)
    data = dist.axis_group("data")
    net = resnet18(num_classes=10, device=device)
    reset_parameters(net, torch.Generator(device=device).manual_seed(0))
    net.to(dtype)
    opt = optim.SGD(lr=lr)
    step = make_gspmd_train_step(net, nn.CrossEntropyLoss(), opt)
    params = dict(net.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt_state, mstate = opt.init(params), {}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, batch)
    rows = slice(data.index * (batch // data.size),
                 (data.index + 1) * (batch // data.size))
    x = torch.from_numpy(x[rows]).to(device, dtype)
    y = torch.from_numpy(y[rows]).to(device)
    cuda = device.type == "cuda"
    losses, step_ms = [], []
    for _ in range(steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, mstate, m = step(params, opt_state, mstate, x, y)
        if cuda:
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return {"losses": losses, "step_ms": step_ms,
            "updates": {k: params[k].detach() - p0[k] for k in p0},
            "stats": mstate}


if __name__ == "__main__":
    for b in (1024, 256):
        print(json.dumps(run(batch=b)))
