"""MoE TransformerLM training throughput — tokens/s/GPU on the card.

Counterpart of ``benchmarks/moe_lm.py`` of the JAX package.  The GPT-2-small
trunk of :mod:`~tpu_dist_torch.benchmarks.transformer_lm` (vocab 32768, dim
768, 12 layers, 12 heads, T = 2048 causal, per-GPU batch 8) with every
block's MLP a top-2-of-8 :class:`~tpu_dist_torch.nn.MoELayer` (hidden 3072,
capacity factor 1.25), trained through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with
``compute_dtype=bfloat16`` over float32 masters, ``SGD(lr=0.01)`` and
``CrossEntropyLoss(fused=True)``.  ``dispatch`` defaults to ``"gather"``, as
in the JAX benchmark; ``"einsum"`` builds the dense ``(N, E, C)`` tensors,
and ``"dropless"`` is the only dispatch that runs the grouped-matmul kernels
(K3 ``gmm``, K4 ``tgmm``).  Random tokens from ``np.random.default_rng(0)``,
as in the JAX benchmark; steps timed with CUDA events after warm-up.

:func:`ep_steps` runs the same configuration under expert parallelism: the
GSPMD step's counterpart (``examples/train_lm.ep_trainer``: SGD, Switch aux
loss at 0.01) on the default group's ``(data, expert)`` mesh, each rank
holding its share of the experts (``chip_smoke.py``'s ``ep_train`` holds it
against world 1: at data 1 × expert 2 on one card, and with
``--ep-world 4`` at data 2 × expert 2 on four).

    python3 -m tpu_dist_torch.benchmarks.moe_lm [--dispatch D]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import TransformerLM
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel
from .transformer_lm import time_steps

__all__ = ["build", "run", "active_params", "ep_steps"]


def build(batch: int = 8, seq_len: int = 2048, dim: int = 768,
          depth: int = 12, heads: int = 12, vocab: int = 32768,
          experts: int = 8, top_k: int = 2, fused: bool = True, group=None,
          device=None, dispatch: str = "gather"):
    """The benchmark's model, DDP wrapper and batch: returns ``(ddp, x, y)``
    with ``x``/``y`` this rank's (batch, seq_len) slice of the global
    random-token batch."""
    device = resolve_device(device)
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    model = TransformerLM(vocab_size=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_seq_len=seq_len,
                          num_experts=experts, moe_top_k=top_k,
                          moe_dispatch=dispatch, device=device)
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
        device=None, dispatch: str = "gather") -> dict:
    """Train ``warmup + steps`` steps and time the last ``steps`` with CUDA
    events.  Returns tokens/s/GPU, step ms, peak device memory, total and
    active parameter counts, active-parameter model TFLOP/s, each step's
    loss and aux losses, and the last step's choices per expert (and, for
    a capacity dispatch, the choices past the capacity in each layer)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(batch, seq_len, dim, depth, heads, vocab, experts,
                          top_k, group=pg, device=pg.device,
                          dispatch=dispatch)
        res = time_steps(ddp, x, y, steps, warmup)
        state = res["state"]
        n_params = sum(p.numel() for p in state.params.values())
        aux = {path: float(v["aux_loss"])
               for path, v in state.model_state.items()}
        routing = [ddp.module.get_submodule(path).routing
                   for path in state.model_state]
        counts = [r["counts"].tolist() for r in routing]
        dropped = ([int(r["dropped"]) for r in routing]
                   if dispatch != "dropless" else None)
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
                  "hidden": 4 * dim, "dispatch": dispatch},
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "steps_run": warmup + steps,
        "losses": res["losses"],
        "aux_losses_last_step": aux,
        "tokens_per_expert_last_step": counts,
        "dropped_choices_last_step": dropped,
    }


def ep_steps(steps: int = 3, batch: int = 8, seq_len: int = 2048,
             dim: int = 768, depth: int = 12, heads: int = 12,
             vocab: int = 32768, experts: int = 8, top_k: int = 2,
             dispatch: str = "gather", device=None,
             compute_dtype=torch.bfloat16) -> dict:
    """``steps`` expert-parallel steps of the benchmark's configuration on
    the default group's ``(data, expert)`` mesh (world 1, the unsplit
    layers, without a group): ``train_lm.ep_trainer`` with seed 0,
    ``lr=0.01``, ``compute_dtype`` over float32 masters and the fused
    loss, on global batches of ``batch`` rows from
    ``np.random.default_rng(0)`` (this rank takes its data shard's).
    Returns each step's float32 loss and wall ms (the card synchronized at
    both ends), step 1's dropped choices per layer (global) and expert
    choices of this shard's tokens per layer (``gate_idx``, uint8 on the
    host), the bytes of the expert banks held here, peak device memory,
    the model, ``advance`` and its ``state``, and the parameter updates
    (after − before, on the card)."""
    import time

    from ..examples.train_lm import ep_trainer

    group = dist.get_default_group() if dist.is_initialized() else None
    device = group.device if group is not None else resolve_device(device)
    data = dist.axis_group("data")
    model = TransformerLM(
        vocab_size=vocab, dim=dim, depth=depth, num_heads=heads,
        max_seq_len=seq_len, num_experts=experts, moe_top_k=top_k,
        moe_dispatch=dispatch, device=device,
        expert_axis="expert" if group is not None
        and "expert" in group.axis_names else None)
    _, state, advance = ep_trainer(model, vocab, 0.01, compute_dtype,
                                   fused=True)
    moes = [m for m in model.modules() if isinstance(m, nn.MoELayer)]
    p0 = {k: v.detach().clone() for k, v in state["params"].items()}
    rng = np.random.default_rng(0)
    rows = slice(data.index * (batch // data.size),
                 (data.index + 1) * (batch // data.size))
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, dropped, choices = [], [], None, None
    for i in range(steps):
        x = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        y = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        x, y = x.to(device), y.to(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = advance(state, x, y)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i == 0:
            dropped = [int(layer.routing["dropped"]) for layer in moes]
            choices = [layer.routing["gate_idx"].to(torch.uint8).cpu()
                       for layer in moes]
    return {"losses": losses, "step_ms": step_ms,
            "dropped_step1": dropped, "gate_idx_step1": choices,
            "expert_bytes": sum(getattr(layer, n).numel() * 4
                                for layer in moes
                                for n in ("w1", "b1", "w2", "b2")),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "aux_losses": {p: float(v["aux_loss"])
                           for p, v in state["mstate"].items()},
            "model": model, "advance": advance, "state": state,
            "updates": {k: state["params"][k].detach() - p0[k]
                        for k in p0}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dispatch", default="gather",
                    choices=("gather", "einsum", "dropless"))
    print(json.dumps(run(dispatch=ap.parse_args().dispatch)))
