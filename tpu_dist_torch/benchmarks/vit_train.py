"""ViT ImageNet-shape training throughput — images/s/GPU on the card.

The port's twin of the JAX package's ``benchmarks/vit_train.py``:
``--model`` (``vit_b_16`` by default, 86,567,656 parameters; ``vit_b_32``,
``vit_l_16``, ``vit_l_32``), 1000 classes, at 224×224 through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with bf16 compute
over float32 masters and AdamW lr 3e-4, weight decay 0.05; one random batch
of 64 a GPU from ``np.random.default_rng(0)``, repeated, timed with CUDA
events after warm-up.  At 197 tokens (/16) or 50 (/32) attention takes the
dense composition (below ``_FLASH_MIN_SEQ``).  Model FLOP/s by the JAX
file's count (also the operations of ``step_bound``): 2 × the parameters a
token forward, (224 / patch)² + 1 tokens an image, forward and backward 3×
the forward (attention's own left out).

    python -m tpu_dist_torch.benchmarks.vit_train [--model vit_l_16]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import dist, nn, optim
from .. import models
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel
from .imagenet_e2e import step_bound
from .transformer_lm import time_steps

__all__ = ["build", "run", "flops_per_image", "MODELS", "PATCH"]

MODELS = ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32")
PATCH = {name: int(name[-2:]) for name in MODELS}


def flops_per_image(n_params: int, patch: int) -> int:
    """Forward and backward model FLOPs of an image: 3 × 2 × the
    parameters × the tokens."""
    return 3 * 2 * n_params * ((224 // patch) ** 2 + 1)



def build(batch: int = 64, group=None, device=None, model: str = "vit_b_16"):
    """The benchmark's DDP wrapper and this rank's batch: ``(ddp, x, y)``
    with ``x`` (batch, 3, 224, 224) float32."""
    device = resolve_device(device)
    ddp = DistributedDataParallel(
        getattr(models, model)(num_classes=1000, device=device),
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
        device=None, model: str = "vit_b_16") -> dict:
    """Images/s/GPU and model TFLOP/s of ``steps`` DDP steps of
    ``model``."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(per_gpu_batch, group=pg, device=pg.device,
                          model=model)
        res = time_steps(ddp, x, y, steps, warmup)
        n_params = sum(p.numel() for p in res["state"].params.values())
        flops = flops_per_image(n_params, PATCH[model])
        bound = step_bound(per_gpu_batch * flops, res["state"], x, y)
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    images_s = per_gpu_batch / (res["step_ms"] / 1e3)
    return {
        "metric": (f"{model[:-3]}{model[-2:]}"   # vit_b16, as the JAX row
                   "_imagenet_bf16_train_images_per_sec_per_gpu"),
        "value": images_s,
        "unit": "images/sec/gpu",
        "model": model,
        "step_ms": res["step_ms"],
        "achieved_model_tflops": images_s * flops / 1e12,
        **bound, "peak_mem_bytes": res["peak_mem_bytes"],
        "per_gpu_batch": per_gpu_batch, "n_params": n_params,
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world, "steps_run": warmup + steps,
        "losses": res["losses"],
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_b_16", choices=MODELS)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    print(json.dumps(run(per_gpu_batch=args.batch, model=args.model)))
