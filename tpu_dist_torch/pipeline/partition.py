"""Layer-span partitioning of model parameter trees for the host pipeline —
counterpart of ``tpu_dist/pipeline/partition.py``.

Splits a model into ``num_stages`` contiguous layer spans and gives, per
stage, (a) the subset of the model's parameter tree the stage owns — the
JAX package's tree ``{module_path: {leaf: tensor}}`` with its keys
(``block0.mlp.0``, ...) and the port's layouts, so the stages' subsets
merge back into the single-process tree exactly — and (b) a function
``fn(stage_params, x) -> h`` over exactly those layers, which runs the
model's own modules through ``torch.func.functional_call`` (the math of the
full forward, and of the mesh pipeline in ``parallel/pipeline.py``, which
puts the same block spans on a stage axis).

Supported models:

- :class:`~tpu_dist_torch.models.TransformerLM` — stage 0 owns the
  embeddings (``tok`` / ``pos``) and the first block span, the last stage
  the final span and ``ln_f`` / ``head``.  Spans are contiguous and
  balanced; when ``depth % num_stages == 0`` they are
  ``PipelineParallel``'s ``blocks_per_stage`` layout.  ``model.remat``
  runs each block under :func:`nn.checkpoint
  <tpu_dist_torch.nn.checkpoint>` when gradients are on, as the model does.
- :class:`~tpu_dist_torch.models.ConvNet` — four sequential units
  (conv+pool ×3, flatten+fc), partitionable into up to four stages.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["ModelPartition", "TransformerPartition", "ConvNetPartition",
           "partition_model", "PipelinePartitionError", "param_tree",
           "flat_params"]


class PipelinePartitionError(ValueError):
    """Unsupported model / stage count for layer-span partitioning."""


def param_tree(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's parameters as the JAX package's tree ``{module_path:
    {leaf: tensor}}`` (detached copies, the port's layouts)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in model.named_parameters():
        path, _, leaf = name.rpartition(".")
        out.setdefault(path, {})[leaf] = p.detach().clone()
    return out


def flat_params(tree: Dict[str, Dict[str, torch.Tensor]],
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"path.leaf": tensor}`` of a ``{path: {leaf: tensor}}`` tree (the
    tensors are the tree's own), the names ``functional_call`` and the
    optimizers take; ``prefix`` re-roots the paths under it."""
    out = {}
    for path, leaves in tree.items():
        if prefix:
            if path == prefix:
                path = ""
            elif path.startswith(prefix + "."):
                path = path[len(prefix) + 1:]
            else:
                continue
        for leaf, v in leaves.items():
            out[f"{path}.{leaf}" if path else leaf] = v
    return out


def _spans(num_units: int, num_stages: int) -> List[Tuple[int, int]]:
    """Balanced contiguous split of ``num_units`` into ``num_stages``
    non-empty ``[lo, hi)`` ranges (earlier stages take the remainder)."""
    if num_stages > num_units:
        raise PipelinePartitionError(
            f"cannot split {num_units} layer unit(s) into {num_stages} "
            f"stages — every stage needs at least one")
    base, rem = divmod(num_units, num_stages)
    spans, lo = [], 0
    for i in range(num_stages):
        hi = lo + base + (1 if i < rem else 0)
        spans.append((lo, hi))
        lo = hi
    return spans


def _call(module: torch.nn.Module, stage_params, prefix: str, *args):
    """``module(*args)`` with its parameters taken from ``stage_params``
    under ``prefix`` (its buffers stay the module's own)."""
    return torch.func.functional_call(
        module, flat_params(stage_params, prefix), args, strict=False)


class _Embed(torch.nn.Module):
    """Token + learned positional embeddings (the model's own modules, so
    parameter names are the model's: ``tok.weight``, ``pos.weight``);
    ``pos`` is None for rope models."""

    def __init__(self, tok, pos):
        super().__init__()
        self.tok = tok
        self.pos = pos

    def forward(self, idx):
        if self.pos is None:
            return self.tok(idx)
        t = idx.shape[1]
        return self.tok(idx) + self.pos(torch.arange(t, device=idx.device))


class _Head(torch.nn.Module):
    """Final norm + LM head."""

    def __init__(self, ln_f, head):
        super().__init__()
        self.ln_f = ln_f
        self.head = head

    def forward(self, x):
        return self.head(self.ln_f(x))


class _Checkpointed(torch.nn.Module):
    """``block`` under :func:`nn.checkpoint <tpu_dist_torch.nn.checkpoint>`
    (which takes the tensors the block holds at the call: bound here by
    ``functional_call``)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, h):
        from ..nn import checkpoint
        return checkpoint(self.block, h)


def run_block(block: torch.nn.Module, params: Dict[str, torch.Tensor], x,
              remat: bool):
    """One block over flat ``params`` (its own names), under
    :func:`nn.checkpoint <tpu_dist_torch.nn.checkpoint>` when ``remat`` and
    gradients are on (the model's own rule)."""
    if remat and torch.is_grad_enabled():
        return torch.func.functional_call(
            _Checkpointed(block), {f"block.{k}": v for k, v in params.items()},
            (x,), strict=False)
    return torch.func.functional_call(block, params, (x,), strict=False)


class ModelPartition:
    """Base: unit spans + param-key ownership + per-stage forward."""

    def __init__(self, model, num_stages: int, num_units: int):
        self.model = model
        self.num_stages = num_stages
        self.spans = _spans(num_units, num_stages)

    def is_first(self, stage: int) -> bool:
        return stage == 0

    def is_last(self, stage: int) -> bool:
        return stage == self.num_stages - 1

    def owner_of(self, key: str) -> int:
        """Which stage owns param-tree key ``key``."""
        raise NotImplementedError

    def stage_params(self, params: Dict, stage: int) -> Dict:
        """The subset of the parameter tree stage ``stage`` owns — original
        keys, so subsets from all stages merge back into the
        single-process tree unchanged."""
        return {k: v for k, v in params.items()
                if self.owner_of(k) == stage}

    def merge_params(self, parts: Sequence[Dict]) -> Dict:
        """Inverse of :meth:`stage_params` over all stages' subsets."""
        out: Dict = {}
        for p in parts:
            out.update(p)
        return out

    def stage_fn(self, stage: int) -> Callable:
        """``fn(stage_params, x) -> h`` over the stage's span (modules hold
        topology; the tensors come from ``stage_params``)."""
        raise NotImplementedError


class TransformerPartition(ModelPartition):
    """Block spans over a TransformerLM; embeddings ride stage 0, the head
    rides the last stage."""

    def __init__(self, model, num_stages: int):
        depth = getattr(model, "depth", None)
        if depth is None or not hasattr(model, "block0") \
                or not hasattr(model, "tok"):
            raise PipelinePartitionError(
                f"{type(model).__name__} is not a TransformerLM-shaped "
                f"model (expects tok/block{{i}}/ln_f/head)")
        super().__init__(model, num_stages, depth)
        self._embed = _Embed(model.tok, model.pos)
        self._head = _Head(model.ln_f, model.head)

    def owner_of(self, key: str) -> int:
        head = key.split(".", 1)[0]
        if head in ("tok", "pos"):
            return 0
        if head in ("ln_f", "head"):
            return self.num_stages - 1
        if head.startswith("block") and head[len("block"):].isdigit():
            j = int(head[len("block"):])
            for i, (lo, hi) in enumerate(self.spans):
                if lo <= j < hi:
                    return i
        raise PipelinePartitionError(
            f"param key {key!r} does not belong to any stage span")

    def stage_fn(self, stage: int) -> Callable:
        lo, hi = self.spans[stage]
        blocks = [(getattr(self.model, f"block{j}"), f"block{j}")
                  for j in range(lo, hi)]
        first, last = self.is_first(stage), self.is_last(stage)
        embed, head = self._embed, self._head
        remat = bool(getattr(self.model, "remat", False))

        def fn(stage_params, x):
            if first:
                x = _call(embed, {k: stage_params[k] for k in ("tok", "pos")
                                  if k in stage_params}, "", x)
            for block, pfx in blocks:
                x = run_block(block, flat_params(stage_params, pfx), x,
                              remat)
            if last:
                x = _call(head, {"ln_f": stage_params["ln_f"],
                                 "head": stage_params["head"]}, "", x)
            return x

        return fn


class ConvNetPartition(ModelPartition):
    """The reference ConvNet as four sequential units:
    ``conv1+pool1``, ``conv2+pool2``, ``conv3+pool3``, ``flatten+fc1``."""

    _UNITS = (("conv1", "maxpool1"), ("conv2", "maxpool2"),
              ("conv3", "maxpool3"), ("fc1",))

    def __init__(self, model, num_stages: int):
        for names in self._UNITS:
            for n in names:
                if not hasattr(model, n):
                    raise PipelinePartitionError(
                        f"{type(model).__name__} is not a ConvNet-shaped "
                        f"model (missing {n!r})")
        super().__init__(model, num_stages, len(self._UNITS))

    def owner_of(self, key: str) -> int:
        head = key.split(".", 1)[0]
        for u, names in enumerate(self._UNITS):
            if head in names:
                for i, (lo, hi) in enumerate(self.spans):
                    if lo <= u < hi:
                        return i
        if head == "dropout":  # defined-but-unused in the reference net
            return self.num_stages - 1
        raise PipelinePartitionError(
            f"param key {key!r} does not belong to any stage span")

    def stage_fn(self, stage: int) -> Callable:
        lo, hi = self.spans[stage]
        model = self.model

        def fn(stage_params, x):
            for u in range(lo, hi):
                if u < 3:
                    conv = getattr(model, f"conv{u + 1}")
                    pool = getattr(model, f"maxpool{u + 1}")
                    x = _call(conv, stage_params, f"conv{u + 1}", x)
                    x = pool(model.relu(x))
                else:
                    x = x.reshape(x.shape[0], -1)
                    x = _call(model.fc1, stage_params, "fc1", x)
            return x

        return fn


def partition_model(model, num_stages: int) -> ModelPartition:
    """Dispatch on model shape: TransformerLM block spans or ConvNet
    units."""
    if hasattr(model, "block0") and hasattr(model, "tok"):
        return TransformerPartition(model, num_stages)
    if hasattr(model, "conv1") and hasattr(model, "fc1"):
        return ConvNetPartition(model, num_stages)
    raise PipelinePartitionError(
        f"no layer-span partitioner for {type(model).__name__}: supported "
        f"shapes are TransformerLM (tok/block{{i}}/ln_f/head) and ConvNet "
        f"(conv1..3/fc1)")
