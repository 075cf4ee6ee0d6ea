"""MoE TransformerLM training throughput — tokens/s/GPU on the card.

Counterpart of ``benchmarks/moe_lm.py`` of the JAX package, with
``dispatch="dropless"`` — the only dispatch that runs the grouped-matmul
kernels (K3 ``gmm``, K4 ``tgmm``).  The GPT-2-small trunk of
:mod:`~tpu_dist_torch.benchmarks.transformer_lm` (vocab 32768, dim 768, 12
layers, 12 heads, T = 2048 causal, per-GPU batch 8) with every block's MLP a
top-2-of-8 :class:`~tpu_dist_torch.nn.MoELayer` (hidden 3072), trained
through :class:`~tpu_dist_torch.parallel.DistributedDataParallel` with
``compute_dtype=bfloat16`` over float32 masters, ``SGD(lr=0.01)`` and
``CrossEntropyLoss(fused=True)``.  Random tokens from
``np.random.default_rng(0)``, as in the JAX benchmark; steps timed with CUDA
events after warm-up.

    python3 -m tpu_dist_torch.benchmarks.moe_lm
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import TransformerLM
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel
from .transformer_lm import time_steps

__all__ = ["build", "run", "active_params"]


def build(batch: int = 8, seq_len: int = 2048, dim: int = 768,
          depth: int = 12, heads: int = 12, vocab: int = 32768,
          experts: int = 8, top_k: int = 2, fused: bool = True, group=None,
          device=None):
    """The benchmark's model, DDP wrapper and batch: returns ``(ddp, x, y)``
    with ``x``/``y`` this rank's (batch, seq_len) slice of the global
    random-token batch."""
    device = resolve_device(device)
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    model = TransformerLM(vocab_size=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_seq_len=seq_len,
                          num_experts=experts, moe_top_k=top_k,
                          moe_dispatch="dropless", device=device)
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


def active_params(n_params: int, dim: int, depth: int, experts: int,
                  top_k: int = 2) -> int:
    """Parameters a token runs through: the JAX benchmark's accounting
    (``benchmarks/moe_lm.py:69-71``) — all parameters less the expert
    weights of the ``experts - top_k`` experts a token skips in each block
    (biases and router counted as active)."""
    expert_weights = 2 * dim * 4 * dim              # w1 + w2 of one expert
    return n_params - depth * (experts - top_k) * expert_weights


def run(batch: int = 8, seq_len: int = 2048, dim: int = 768,
        depth: int = 12, heads: int = 12, vocab: int = 32768,
        experts: int = 8, top_k: int = 2, steps: int = 20, warmup: int = 3,
        device=None) -> dict:
    """Train ``warmup + steps`` steps and time the last ``steps`` with CUDA
    events.  Returns tokens/s/GPU, step ms, peak device memory, total and
    active parameter counts, active-parameter model TFLOP/s, each step's
    loss and aux losses, and the last step's tokens per expert."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(batch, seq_len, dim, depth, heads, vocab, experts,
                          top_k, group=pg, device=pg.device)
        res = time_steps(ddp, x, y, steps, warmup)
        state = res["state"]
        n_params = sum(p.numel() for p in state.params.values())
        aux = {path: float(v["aux_loss"])
               for path, v in state.model_state.items()}
        counts = [ddp.module.get_submodule(path).routing["counts"].tolist()
                  for path in state.model_state]
        world = pg.size()
    finally:
        if own_group:
            dist.destroy_process_group()
    n_active = active_params(n_params, dim, depth, experts, top_k)
    tok_s = batch * seq_len / (res["step_ms"] / 1e3)
    flops_per_token = 3 * (2 * n_active + 4 * depth * seq_len * dim)
    return {
        "metric": "transformer_moe_lm_bf16_train_tokens_per_sec_per_gpu",
        "value": tok_s,
        "unit": "tokens/sec/gpu",
        "step_ms": res["step_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "n_params": n_params,
        "n_active_params": n_active,
        "achieved_model_tflops_active": tok_s * flops_per_token / 1e12,
        "model": {"depth": depth, "dim": dim, "heads": heads,
                  "seq_len": seq_len, "per_gpu_batch": batch,
                  "vocab": vocab, "experts": experts, "top_k": top_k,
                  "hidden": 4 * dim, "dispatch": "dropless"},
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "steps_run": warmup + steps,
        "losses": res["losses"],
        "aux_losses_last_step": aux,
        "tokens_per_expert_last_step": counts,
    }


if __name__ == "__main__":
    print(json.dumps(run()))
