"""TransformerLM training throughput — tokens/s/GPU on the card.

Counterpart of ``benchmarks/transformer_lm.py`` and ``benchmarks/timing.py``
of the JAX package.  A GPT-2-small-shaped model (vocab 32768, dim 768, 12
layers, 12 heads, T = 2048 causal, per-GPU batch 8) trains through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with
``compute_dtype=bfloat16`` (float32 masters), ``SGD(lr=0.01)`` and
``CrossEntropyLoss(fused=True)``; at T = 2048 attention dispatches to the
flash kernel.  Batches are random tokens from ``np.random.default_rng(0)``,
as in the JAX benchmark.  Steps are timed with CUDA events after warm-up.

    python -m tpu_dist_torch.benchmarks.transformer_lm
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import TransformerLM
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel

__all__ = ["build", "run", "time_steps"]


def build(batch: int = 8, seq_len: int = 2048, dim: int = 768,
          depth: int = 12, heads: int = 12, vocab: int = 32768,
          fused: bool = True, group=None, device=None,
          sequence_axis=None, mode: str = "ring"):
    """The benchmark's model, DDP wrapper and batch: returns ``(ddp, x, y)``
    with ``x``/``y`` this rank's (batch, seq_len) slice of the global
    random-token batch.  ``sequence_axis``/``mode``: the sequence-parallel
    model (``TransformerLM(sequence_axis=, mode=)``; at world 1 its
    attention is one ring block, or Ulysses' identity all-to-all)."""
    device = resolve_device(device)
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    model = TransformerLM(vocab_size=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_seq_len=seq_len, device=device,
                          sequence_axis=sequence_axis, mode=mode)
    ddp = DistributedDataParallel(
        model, optimizer=optim.SGD(lr=0.01),
        loss_fn=nn.CrossEntropyLoss(fused=fused), group=group,
        compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.integers(0, vocab, (batch * world, seq_len))
    y = rng.integers(0, vocab, (batch * world, seq_len))
    rows = slice(rank * batch, (rank + 1) * batch)
    return (ddp, torch.from_numpy(x[rows]).to(device),
            torch.from_numpy(y[rows]).to(device))


def time_steps(ddp, x, y, steps: int, warmup: int) -> dict:
    """Train ``warmup + steps`` steps from ``ddp.init(seed=0)`` and time the
    last ``steps`` with CUDA events: step ms, peak device memory, the final
    state and every step's loss (read after the timed window)."""
    device = ddp.device
    torch.cuda.reset_peak_memory_stats(device)
    state = ddp.init(seed=0)
    losses = []
    for _ in range(warmup):
        state, m = ddp.train_step(state, x, y)
        losses.append(m["loss"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, m = ddp.train_step(state, x, y)
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize(device)
    return {"step_ms": start.elapsed_time(end) / steps,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "state": state, "losses": [float(v) for v in losses]}


def run(batch: int = 8, seq_len: int = 2048, dim: int = 768,
        depth: int = 12, heads: int = 12, vocab: int = 32768,
        steps: int = 20, warmup: int = 3, device=None) -> dict:
    """Train ``warmup + steps`` steps and time the last ``steps`` with CUDA
    events.  Returns tokens/s/GPU, step ms, peak device memory, the
    parameter count and every step's loss."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(batch, seq_len, dim, depth, heads, vocab,
                          group=pg, device=pg.device)
        res = time_steps(ddp, x, y, steps, warmup)
        n_params = sum(p.numel() for p in res["state"].params.values())
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    tok_s = batch * seq_len / (res["step_ms"] / 1e3)
    # fwd+bwd ~= 3x fwd; fwd ~= 2*N matmul FLOPs/token + attention — the
    # JAX benchmark's accounting, kept so the two read alike
    flops_per_token = 3 * (2 * n_params + 4 * depth * seq_len * dim)
    return {
        "metric": "transformer_lm_bf16_train_tokens_per_sec_per_gpu",
        "value": tok_s,
        "unit": "tokens/sec/gpu",
        "step_ms": res["step_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "n_params": n_params,
        "achieved_model_tflops": tok_s * flops_per_token / 1e12,
        "model": {"depth": depth, "dim": dim, "heads": heads,
                  "seq_len": seq_len, "per_gpu_batch": batch,
                  "vocab": vocab},
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "steps_run": warmup + steps,
        "losses": res["losses"],
    }


if __name__ == "__main__":
    print(json.dumps(run()))
