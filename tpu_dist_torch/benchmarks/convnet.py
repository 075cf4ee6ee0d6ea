"""MNIST ConvNet DDP training throughput — images/s/GPU on the card.

The port's twin of the JAX package's ``bench.py``: the reference tutorial's
ConvNet trained through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with SGD lr 1e-4
and the plain cross-entropy, ``BENCH_STEPS`` steps (default 50) in one
``train_chunk`` over distinct batches generated on the card (a seeded CUDA
generator: nothing crosses the host link), timed with CUDA events after a
warm-up chunk.  Headline: batch 8192 per GPU with bfloat16 compute over
float32 masters; ``BENCH_DTYPE=float32 BENCH_BATCH=2048`` is the float32
row.  The result says whether cuDNN may use TF32 (torch's default: yes), as
it stood when the run began.

    python -m tpu_dist_torch.benchmarks.convnet
"""

from __future__ import annotations

import json
import os

import torch

from .. import dist, nn, optim
from ..models import ConvNet
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel

__all__ = ["build", "run", "time_chunk", "TRAIN_FLOPS_PER_IMAGE"]

# fwd + bwd = 3 x the forward's 15,020,288 multiply-adds x 2, the JAX
# benchmark's accounting (bench.py), kept so the two read alike
TRAIN_FLOPS_PER_IMAGE = 3 * 15_020_288

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def build(batch: int = 8192, dtype: str = "bfloat16", steps: int = 1,
          group=None, device=None):
    """The benchmark's DDP wrapper and ``steps`` random batches of this
    rank: ``(ddp, xs, ys)`` with ``xs`` (steps, batch, 1, 28, 28) float32
    and ``ys`` (steps, batch) int64 on the device."""
    device = resolve_device(device)
    ddp = DistributedDataParallel(
        ConvNet(device=device), optimizer=optim.SGD(lr=1e-4),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=DTYPES[dtype])
    rank = group.rank if group is not None else 0
    g = torch.Generator(device=device).manual_seed(rank)
    xs = torch.randn((steps, batch, 1, 28, 28), generator=g, device=device)
    ys = torch.randint(0, 10, (steps, batch), generator=g, device=device)
    return ddp, xs, ys


def time_chunk(ddp, xs, ys, warmup: int = 3) -> dict:
    """``train_chunk`` over ``xs``/``ys`` after a warm-up chunk of
    ``warmup`` steps, from ``ddp.init(seed=0)``, timed with CUDA events:
    step ms, peak device memory and the chunk's losses."""
    device = ddp.device
    state = ddp.init(seed=0)
    state, _ = ddp.train_chunk(state, xs[:warmup], ys[:warmup])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, m = ddp.train_chunk(state, xs, ys)
    end.record()
    torch.cuda.synchronize(device)
    return {"step_ms": start.elapsed_time(end) / xs.shape[0],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "state": state, "losses": m["loss"].float().tolist()}


def run(batch: int = 8192, steps: int = 50, dtype: str = "bfloat16",
        device=None) -> dict:
    """Images/s/GPU of ``steps`` ConvNet DDP steps at ``batch`` per GPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_chunk() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, xs, ys = build(batch, dtype, steps, group=pg, device=pg.device)
        res = time_chunk(ddp, xs, ys)
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    ips = batch / (res["step_ms"] / 1e3)
    return {
        "metric": f"mnist_convnet_{dtype}_train_images_per_sec_per_gpu",
        "value": ips,
        "unit": "images/sec/gpu",
        "step_ms": res["step_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "achieved_model_tflops": ips * TRAIN_FLOPS_PER_IMAGE / 1e12,
        "per_gpu_batch": batch,
        "dtype": dtype,
        "steps": steps,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "losses": res["losses"],
    }


if __name__ == "__main__":
    print(json.dumps(run(batch=int(os.environ.get("BENCH_BATCH", 8192)),
                         steps=max(2, int(os.environ.get("BENCH_STEPS", 50))),
                         dtype=os.environ.get("BENCH_DTYPE", "bfloat16"))))
