"""ViT-B/16 ImageNet-shape training throughput — images/s/GPU on the card.

The port's twin of the JAX package's ``benchmarks/vit_train.py``:
``vit_b_16`` (86,567,656 parameters, 1000 classes) at 224×224 through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with bf16 compute
over float32 masters and AdamW lr 3e-4, weight decay 0.05; one random batch
of 64 a GPU from ``np.random.default_rng(0)``, repeated, timed with CUDA
events after warm-up.  At 197 tokens attention takes the dense composition
(below ``_FLASH_MIN_SEQ``).  Model FLOP/s by the JAX file's count (also
the operations of ``step_bound``): 2 × the
parameters a token forward, 197 tokens an image, forward and backward 3×
the forward (attention's own ≈ 2% left out).

    python -m tpu_dist_torch.benchmarks.vit_train
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import vit_b_16
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel
from .imagenet_e2e import step_bound
from .transformer_lm import time_steps

__all__ = ["build", "run", "FLOPS_PER_IMAGE"]

N_TOKENS = (224 // 16) ** 2 + 1
FLOPS_PER_IMAGE = 3 * 2 * 86_567_656 * N_TOKENS


def build(batch: int = 64, group=None, device=None):
    """The benchmark's DDP wrapper and this rank's batch: ``(ddp, x, y)``
    with ``x`` (batch, 3, 224, 224) float32."""
    device = resolve_device(device)
    ddp = DistributedDataParallel(
        vit_b_16(num_classes=1000, device=device),
        optimizer=optim.AdamW(lr=3e-4, weight_decay=0.05),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=torch.bfloat16)
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch * world, 3, 224, 224)).astype(np.float32)
    y = rng.integers(0, 1000, batch * world)
    rows = slice(rank * batch, (rank + 1) * batch)
    return (ddp, torch.from_numpy(x[rows]).to(device),
            torch.from_numpy(y[rows]).to(device))


def run(per_gpu_batch: int = 64, steps: int = 20, warmup: int = 3,
        device=None) -> dict:
    """Images/s/GPU and model TFLOP/s of ``steps`` ViT-B/16 DDP steps."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(per_gpu_batch, group=pg, device=pg.device)
        res = time_steps(ddp, x, y, steps, warmup)
        n_params = sum(p.numel() for p in res["state"].params.values())
        bound = step_bound(per_gpu_batch * FLOPS_PER_IMAGE, res["state"],
                           x, y)
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    images_s = per_gpu_batch / (res["step_ms"] / 1e3)
    return {
        "metric": "vit_b16_imagenet_bf16_train_images_per_sec_per_gpu",
        "value": images_s,
        "unit": "images/sec/gpu",
        "step_ms": res["step_ms"],
        "achieved_model_tflops": images_s * FLOPS_PER_IMAGE / 1e12,
        **bound, "peak_mem_bytes": res["peak_mem_bytes"],
        "per_gpu_batch": per_gpu_batch, "n_params": n_params,
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world, "steps_run": warmup + steps,
        "losses": res["losses"],
    }


if __name__ == "__main__":
    print(json.dumps(run()))
