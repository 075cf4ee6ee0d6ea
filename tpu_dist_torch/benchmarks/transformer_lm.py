"""TransformerLM training throughput — tokens/s/GPU on the card.

Counterpart of ``benchmarks/transformer_lm.py`` and ``benchmarks/timing.py``
of the JAX package.  A GPT-2-small-shaped model (vocab 32768, dim 768, 12
layers, 12 heads, T = 2048 causal, per-GPU batch 8) trains through
:class:`~tpu_dist_torch.parallel.DistributedDataParallel` with
``compute_dtype=bfloat16`` (float32 masters), ``SGD(lr=0.01)`` and
``CrossEntropyLoss(fused=True)``; at T = 2048 attention dispatches to the
flash kernel.  Batches are random tokens from ``np.random.default_rng(0)``,
as in the JAX benchmark.  Steps are timed with CUDA events after warm-up.
``run(remat=, norm=, rope=)`` takes the model options; :func:`run_long` is
the 8k-context row (T = 8192, batch 1, no remat) and :func:`run_32k` the
32k one (T = 32768, batch 1, every block under remat), as in the JAX
benchmark.

    python -m tpu_dist_torch.benchmarks.transformer_lm [--row long|32k]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from .. import dist, nn, optim
from ..models import TransformerLM
from ..ops._build import resolve_device
from ..parallel import DistributedDataParallel

__all__ = ["build", "run", "run_long", "run_32k", "time_steps", "tp_steps",
           "pp_steps"]


def build(batch: int = 8, seq_len: int = 2048, dim: int = 768,
          depth: int = 12, heads: int = 12, vocab: int = 32768,
          fused: bool = True, group=None, device=None,
          sequence_axis=None, mode: str = "ring", remat: bool = False,
          norm: str = "layernorm", rope: bool = False, optimizer=None,
          **ddp_kw):
    """The benchmark's model, DDP wrapper and batch: returns ``(ddp, x, y)``
    with ``x``/``y`` this rank's (batch, seq_len) slice of the global
    random-token batch.  ``sequence_axis``/``mode``: the sequence-parallel
    model (``TransformerLM(sequence_axis=, mode=)``; at world 1 its
    attention is one ring block, or Ulysses' identity all-to-all).
    ``remat``, ``norm``, ``rope``: the model's options (``norm="rmsnorm",
    rope=True`` is the LLaMA-family recipe).  ``optimizer`` (default
    ``SGD(lr=0.01)``) and ``ddp_kw`` (``shard_optimizer=``,
    ``comm_dtype=``) go to the DDP."""
    device = resolve_device(device)
    world = group.size() if group is not None else 1
    rank = group.rank if group is not None else 0
    model = TransformerLM(vocab_size=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_seq_len=seq_len, device=device,
                          sequence_axis=sequence_axis, mode=mode,
                          remat=remat, norm=norm, rope=rope)
    ddp = DistributedDataParallel(
        model, optimizer=optimizer or optim.SGD(lr=0.01),
        loss_fn=nn.CrossEntropyLoss(fused=fused), group=group,
        compute_dtype=torch.bfloat16, **ddp_kw)
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
        steps: int = 20, warmup: int = 3, device=None, remat: bool = False,
        norm: str = "layernorm", rope: bool = False,
        metric: str = "transformer_lm_bf16_train_tokens_per_sec_per_gpu",
        then=None) -> dict:
    """Train ``warmup + steps`` steps and time the last ``steps`` with CUDA
    events.  Returns tokens/s/GPU, step ms, peak device memory, the
    parameter count and every step's loss.  ``then(ddp, state, x, y)``, if
    given, runs after the timed steps and before the process group goes
    (an untimed extra step on the trained model); its result is returned
    under ``"then"``."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("run() times the card with CUDA events; on the "
                           "CPU drive build() and train_step() instead")
    own_group = not dist.is_initialized()
    pg = (dist.init_process_group(device=device) if own_group
          else dist.get_default_group())
    try:
        ddp, x, y = build(batch, seq_len, dim, depth, heads, vocab,
                          group=pg, device=pg.device, remat=remat, norm=norm,
                          rope=rope)
        res = time_steps(ddp, x, y, steps, warmup)
        n_params = sum(p.numel() for p in res["state"].params.values())
        world = pg.size()
        after = then(ddp, res.pop("state"), x, y) if then else None
    finally:
        if own_group:
            dist.destroy_process_group()
    tok_s = batch * seq_len / (res["step_ms"] / 1e3)
    # fwd+bwd ~= 3x fwd; fwd ~= 2*N matmul FLOPs/token + attention — the
    # JAX benchmark's accounting, kept so the two read alike
    flops_per_token = 3 * (2 * n_params + 4 * depth * seq_len * dim)
    return {
        "metric": metric,
        "value": tok_s,
        "unit": "tokens/sec/gpu",
        "step_ms": res["step_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "n_params": n_params,
        "achieved_model_tflops": tok_s * flops_per_token / 1e12,
        "model": {"depth": depth, "dim": dim, "heads": heads,
                  "seq_len": seq_len, "per_gpu_batch": batch,
                  "vocab": vocab, "remat": remat, "norm": norm,
                  "rope": rope},
        "device": torch.cuda.get_device_name(pg.device),
        "world_size": world,
        "steps_run": warmup + steps,
        "losses": res["losses"],
        **({"then": after} if then else {}),
    }


def run_long(seq_len: int = 8192, batch: int = 1, **kw) -> dict:
    """The long-context row: the same trunk at T = 8192, batch 1, without
    remat (flash attention keeps the activations O(T))."""
    return run(batch=batch, seq_len=seq_len, remat=False,
               metric="transformer_lm_long_context_8k_bf16_tokens_per_sec_"
                      "per_gpu", **kw)


def run_32k(seq_len: int = 32768, batch: int = 1, **kw) -> dict:
    """The 32k-context row: T = 32768, batch 1, every block under remat
    (activations recomputed in backward); ``max_seq_len`` is the training
    length, so the position table stays small."""
    return run(batch=batch, seq_len=seq_len, remat=True,
               metric="transformer_lm_long_context_32k_bf16_tokens_per_sec_"
                      "per_gpu", **kw)


def tp_steps(steps: int = 3, batch: int = 8, seq_len: int = 2048,
             dim: int = 768, depth: int = 12, heads: int = 12,
             vocab: int = 32768, device=None, compute_dtype=torch.bfloat16,
             fsdp_min_size: int = 2 ** 12, prompts=(),
             max_new_tokens: int = 0, around_steps=None) -> dict:
    """``steps`` steps of the benchmark's configuration under the GSPMD
    step on the default group's mesh (world 1, the unsplit model, without
    a group): a ``model`` axis splits the model (``TransformerLM(
    model_axis="model")``), and an ``fsdp`` axis, or ``data`` on a mesh of
    that axis alone above one rank, takes FSDP shards of every leaf of at
    least ``fsdp_min_size`` elements (``parallel.fsdp_shard``; the module's
    own parameters are then freed).  ``train_lm.tp_trainer`` with seed 0,
    ``lr=0.01``, ``compute_dtype`` over float32 masters and the fused loss,
    on global batches of ``batch`` rows from ``np.random.default_rng(0)``
    (this rank takes its data shard's).  Before the steps, greedy
    ``generate`` of each of ``prompts`` (int arrays) from the seeded
    weights in float32.  ``around_steps``: a context manager the steps run
    in (a counter of their collectives).  Returns each step's float32 loss
    and wall ms (the
    card synchronized at both ends), the generated tokens, the elements of
    each leaf held here against the unsplit model's, the parameter updates
    (after − before, this rank's slices) and peak device memory (None on
    the CPU, where the steps are timed without synchronizing)."""
    from ..examples.train_lm import tp_trainer
    from ..parallel import fsdp_shard

    group = dist.get_default_group() if dist.is_initialized() else None
    axes = group.axis_names if group is not None else ()
    device = group.device if group is not None else resolve_device(device)
    data = dist.axis_group("data")
    model = TransformerLM(
        vocab_size=vocab, dim=dim, depth=depth, num_heads=heads,
        max_seq_len=seq_len, device=device,
        model_axis="model" if "model" in axes else None)
    full = {k: p.numel() for k, p in model.named_parameters()}
    for path, mod in model.named_modules():
        for leaf in getattr(getattr(mod, "tp", None), "leaves", ()):
            key = f"{path}.{leaf}" if path else leaf
            full[key] = int(np.prod(mod.tp.full[leaf]))
    _, state, advance = tp_trainer(model, vocab, 0.01, compute_dtype,
                                   fused=True)
    generated = []
    for prompt in prompts:
        out = model.generate(torch.as_tensor(prompt, device=device)[None],
                             max_new_tokens)
        generated.append(out[0, len(prompt):].tolist())
    fsdp_axis = ("fsdp" if "fsdp" in axes else "data"
                 if axes == ("data",) and group.size() > 1 else None)
    if fsdp_axis is not None:
        state["params"] = fsdp_shard(state["params"], group, fsdp_axis,
                                     fsdp_min_size)
        model.to("meta")
    p0 = {k: v.detach().clone() for k, v in state["params"].items()}
    held = {k: v.numel() for k, v in state["params"].items()}
    rng = np.random.default_rng(0)
    rows = slice(data.index * (batch // data.size),
                 (data.index + 1) * (batch // data.size))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    with around_steps or contextlib.nullcontext():
        state = _run_steps(steps, advance, state, rng, vocab, batch,
                           seq_len, rows, device, cuda, losses, step_ms)
    return {"losses": losses, "step_ms": step_ms, "generated": generated,
            "held_elements": held, "full_elements": full,
            "opt_state_elements": sum(
                v.numel() for t in state["opt_state"].values()
                if isinstance(t, dict) for v in t.values()),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None,
            "model": model, "advance": advance, "state": state,
            "updates": {k: state["params"][k].detach() - p0[k]
                        for k in p0}}


def pp_steps(steps: int = 3, batch: int = 8, seq_len: int = 2048,
             dim: int = 768, depth: int = 12, heads: int = 12,
             vocab: int = 32768, compute_dtype=torch.bfloat16,
             schedule: str = "gpipe", microbatches: int = 4, prompts=(),
             max_new_tokens: int = 0, before_steps=None) -> dict:
    """``steps`` steps of the benchmark's configuration under
    ``parallel.PipelineParallel`` on the default group's ``("data",
    "pipe")`` mesh (``train_lm.pp_trainer``: seed 0, ``lr=0.01``,
    ``compute_dtype`` over float32 masters, the fused loss, ``schedule``,
    ``microbatches`` a step), on :func:`tp_steps`' batches (this rank takes
    its data shard's rows).  Before the steps, with ``prompts``, the seeded
    state is gathered over the pipe line, unpacked into a whole model, and
    each prompt decoded greedily from it in float32 (on data rank 0 of the
    pipe line's first rank, by a whole model built for that and freed).
    The updates' base is the seeded weights, kept on the host by
    ``init``'s ``init_params`` hook.
    Returns each step's loss, wall ms and ``PipelineParallel.stats``, the
    generated tokens, the elements held here (the stage's blocks and the
    repl leaves) against the whole model's, the device bytes the rank
    holds once its state is built (``held_bytes``) against the state's own
    (``state_bytes``), the whole model's updates by parameter name (after
    − before, gathered on every rank, on the host) and peak device memory
    (``held_bytes`` and it None on the CPU, where the steps are timed
    without synchronizing).  ``before_steps()``
    runs just before the first step (a launch counter's reset)."""
    import time

    from ..examples.train_lm import pp_trainer

    group = dist.get_default_group()
    device = group.device
    data = dist.axis_group("data")
    cuda = device.type == "cuda"
    config = dict(vocab_size=vocab, dim=dim, depth=depth, num_heads=heads,
                  max_seq_len=seq_len)
    base = torch.cuda.memory_allocated(device) if cuda else None
    model = TransformerLM(**config, device=device)
    full = sum(p.numel() for p in model.parameters())
    p0 = {}

    def keep(seeded):
        """The seeded weights on the host, before the module gives its
        tensors up: the updates' base."""
        p0.update({k: v.detach().cpu() for k, v in seeded.named_parameters()})

    pp, state, advance = pp_trainer(model, 0.01, microbatches,
                                    compute_dtype, fused=True,
                                    schedule=schedule, init_params=keep)
    pp.timing = True
    # what the rank holds on the card once the state is built: its state
    # alone (the module gave its tensors up), against the state's bytes
    held_bytes = (torch.cuda.memory_allocated(device) - base if cuda
                  else None)
    state_bytes = sum(t.numel() * t.element_size()
                      for part in (state.params, state.opt_state)
                      for t in _leaves(part) if isinstance(t, torch.Tensor))

    def whole(st):
        """The whole model's parameters by name (float32, on the host)."""
        tree = pp.unpack_params(pp.gather_params(st))
        return {f"{p}.{k}": torch.as_tensor(v)
                for p, lv in tree.items() for k, v in lv.items()}

    generated = []
    if prompts:
        unpacked = whole(state)    # every rank of the pipe line gathers
    if prompts and pp.stage_index == 0 and data.index == 0:
        # a whole model for the check alone, freed before the steps
        gen = TransformerLM(**config, device=device)
        with torch.no_grad():
            for k, v in unpacked.items():
                gen.get_parameter(k).copy_(v)
        for prompt in prompts:
            out = gen.generate(torch.as_tensor(prompt, device=device)[None],
                               max_new_tokens)
            generated.append(out[0, len(prompt):].tolist())
        del gen, out
    if prompts:
        del unpacked
        if cuda:
            torch.cuda.empty_cache()
    held = sum(t.numel() for tree in state.params.values()
               for lv in tree.values() for t in _leaves(lv))
    rng = np.random.default_rng(0)
    rows = slice(data.index * (batch // data.size),
                 (data.index + 1) * (batch // data.size))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, stats = [], [], []
    if before_steps is not None:
        before_steps()
    for _ in range(steps):
        x = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        y = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        x, y = x.to(device), y.to(device)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = advance(state, x, y)
        if cuda:
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        stats.append(dict(pp.stats))
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    p1 = whole(state)
    return {"losses": losses, "step_ms": step_ms, "stats": stats,
            "generated": generated, "held_elements": held,
            "full_elements": full, "held_bytes": held_bytes,
            "state_bytes": state_bytes, "peak_mem_bytes": peak,
            "stage_index": pp.stage_index, "pp": pp, "state": state,
            "updates": {k: p1[k] - p0[k] for k in p0},
            "repl_digest": _digest(state.params["repl"])}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _digest(tree) -> str:
    """sha256 of a tree's tensors' bytes, in sorted key order."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            h.update(_digest(v).encode())
        else:
            h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _run_steps(steps, advance, state, rng, vocab, batch, seq_len, rows,
               device, cuda, losses, step_ms):
    """:func:`tp_steps`' loop: each step's loss and wall ms appended;
    returns the last state."""
    import time

    for _ in range(steps):
        x = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        y = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len))[rows])
        x, y = x.to(device), y.to(device)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = advance(state, x, y)
        if cuda:
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return state


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", choices=("dense", "long", "32k"),
                    default="dense")
    args = ap.parse_args()
    print(json.dumps({"dense": run, "long": run_long,
                      "32k": run_32k}[args.row]()))
