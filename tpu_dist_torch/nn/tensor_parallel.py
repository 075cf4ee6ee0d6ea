"""Tensor parallelism in the layers — the port's side of the JAX package's
``TRANSFORMER_TP_RULES`` placement under the GSPMD step.

The JAX package places the parameters by the rule table (heads, the MLP
hidden width and the vocab on the ``model`` mesh axis) and lets XLA's
partitioner cut the one global program.  The port runs that program as a
per-rank torch program, so the layers carry the axis (as ``nn/moe.py`` does
for experts): :func:`split_model_axis` gives each layer that the rule table
splits its rank's slice, by the same layout table (``parallel/rules.py``),
and switches its forward to the Megatron pairs:

- column-parallel (the fused qkv projection, ``mlp.0``, the LM head): the
  input takes the identity forward and a backward summed over the model
  line (:class:`SumGradOverLine`); the output is this rank's columns;
- row-parallel (the attention ``out`` projection, ``mlp.2``): the partial
  products are summed over the model line forward, with an identity
  backward (:class:`SumOverLine`); the bias, whole on every rank, is added
  once after the sum, as XLA adds it after its psum;
- the vocab-parallel embedding: each rank looks up its rows, the others
  masked to zero, and the lookups are summed over the line;
- the fused qkv slice is ``[q_heads_r | k_heads_r | v_heads_r]`` (its rows
  factored ``(qkv3, heads, head_dim)``), so the attention runs on this
  rank's heads with no communication; the KV cache holds them;
- the LM head's output stays split on the vocab: :class:`ShardedLogits`
  carries the slice, and :func:`vocab_parallel_cross_entropy` takes the
  loss on it with K1f/K1b on the slice and two small (rows,) all-reduces
  (the max of the ranks' lse; the sum of ``exp(lse_r − max)`` stacked with
  the label's logit) in place of gathering the logits.

A split layer keeps its parameter names and draws its whole parameters
before keeping its slice (:func:`split_model_axis`, and
``nn.reset_parameters`` through :meth:`ModelSplit.reset`), so a seed gives
every rank the unsplit model's slices.  Over a line of size 1 nothing is
split.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..collectives import ops as _ops

__all__ = ["SumOverLine", "SumGradOverLine", "ModelSplit",
           "split_model_axis", "shard_dim", "unshard_dim", "ShardedLogits",
           "vocab_parallel_cross_entropy", "full_logits"]

# the sizes of the logical axes that may come before the split factor of a
# dim (the fused projection's q/k/v), which the layout names but a shape
# cannot tell
_FIXED = {"qkv3": 3}


class SumOverLine(torch.autograd.Function):
    """The sum over a mesh line forward, the identity backward: the combine
    of partial products (every rank of the line computes the same loss from
    the sum)."""

    @staticmethod
    def forward(ctx, x, line):
        return _ops.psum(x, line)

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumGradOverLine(torch.autograd.Function):
    """The identity forward, the sum over a mesh line backward: a tensor
    that every rank of the line feeds into its own share of the work."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ops.psum(g.contiguous(), ctx.line), None


def shard_dim(t: torch.Tensor, dim: int, index: int, size: int,
              parts: int = 1) -> torch.Tensor:
    """Slice ``index`` of ``size`` of ``t`` along ``dim``, whose length is
    ``parts`` equal groups each split into ``size`` chunks (the fused qkv:
    ``parts=3``, so a rank holds its chunk of q, of k and of v): a view."""
    g = t.unflatten(dim, (parts, t.shape[dim] // parts))
    n = g.shape[dim + 1] // size
    return g.narrow(dim + 1, index * n, n).flatten(dim, dim + 1)


def unshard_dim(local: torch.Tensor, dim: int, line, parts: int = 1):
    """The inverse of :func:`shard_dim` over a mesh line: every rank's
    slice gathered and put back in place (a collective over ``line``)."""
    if line.size == 1:
        return local
    stacked = _ops.all_gather(local.contiguous(), line)  # (size, *local)
    g = stacked.unflatten(dim + 1, (parts, local.shape[dim] // parts))
    return g.movedim(0, dim + 1).flatten(dim, dim + 2)


class ModelSplit(NamedTuple):
    """How a layer is split over its model line: the ``line``
    (:class:`~tpu_dist_torch.dist.AxisGroup`), ``leaves`` ``{name: (torch
    dim, parts)}`` for each split parameter, and ``full`` ``{name: whole
    shape}``."""
    line: object
    leaves: Dict[str, Tuple[int, int]]
    full: Dict[str, Tuple[int, ...]]

    def kind(self, name: str = "weight") -> str:
        """``"column"`` when the leaf's output dim is split, ``"row"`` when
        its input dim is (a 2-D weight in torch's (out, in) layout)."""
        return "column" if self.leaves[name][0] == 0 else "row"

    def take(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf (torch layout), a view."""
        dim, parts = self.leaves[name]
        return shard_dim(full, dim, self.line.index, self.line.size, parts)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice (a collective)."""
        dim, parts = self.leaves[name]
        return unshard_dim(local, dim, self.line, parts)

    @torch.no_grad()
    def reset(self, module, generator=None) -> None:
        """``module.reset_parameters(generator)`` on whole-shaped leaves,
        keeping this rank's slice: the unsplit layer's draws."""
        local = {n: module._parameters[n] for n in self.leaves}
        try:
            for n in self.leaves:
                module._parameters[n] = torch.nn.Parameter(
                    local[n].new_empty(self.full[n]))
            module.reset_parameters(generator)
            whole = {n: module._parameters[n] for n in self.leaves}
        finally:
            module._parameters.update(local)
        for n, p in local.items():
            p.copy_(self.take(n, whole[n]))


def _transposed(module, name: str) -> bool:
    """Whether the leaf's torch layout is the JAX layout transposed (the
    Linear weights and the attention projections), as in ``interop``."""
    from .attention import MultiheadSelfAttention
    from .layers import Linear
    return ((isinstance(module, Linear) and name == "weight")
            or (isinstance(module, MultiheadSelfAttention)
                and name in ("qkv_weight", "out_weight")))


def split_model_axis(model: torch.nn.Module,
                     axis: str = "model") -> torch.nn.Module:
    """Split ``model``'s layers over ``axis`` of the default process group,
    in place, and return it: every parameter the layout table factors with
    a logical axis that ``DEFAULT_RULES`` binds to ``"model"`` (read as
    ``axis``) becomes this rank's slice, and its layer's forward the
    Megatron pair (module docstring).
    Raises ``ValueError`` on a split that the axis does not divide (heads,
    MLP width or vocab)."""
    from .. import dist
    from ..parallel import rules as R
    from .attention import MultiheadSelfAttention
    from .layers import Embedding, Linear

    line = dist.axis_group(axis)
    if line.size == 1:
        return model
    binding = {k: (axis if v == "model" else v)
               for k, v in R.DEFAULT_RULES.items()}
    for path, mod in model.named_modules():
        leaves, full = {}, {}
        for name, p in mod.named_parameters(recurse=False):
            lay = R.layout_for(path, name)
            hit = None if lay is None else R._find_sharded(lay, binding,
                                                           axis)
            if hit is None:
                continue
            d, j = hit
            try:
                parts = math.prod(_FIXED[f] for f in lay.dims[d][:j])
            except KeyError as e:
                raise ValueError(f"{path}.{name}: no size for logical axis "
                                 f"{e.args[0]!r} before the split") from None
            tdim = p.dim() - 1 - d if _transposed(mod, name) else d
            if p.shape[tdim] % (parts * line.size):
                raise ValueError(
                    f"{path}.{name}: dim {tdim} of {tuple(p.shape)} does not "
                    f"split over the {line.size} ranks of mesh axis {axis!r}")
            leaves[name], full[name] = (tdim, parts), tuple(p.shape)
        if not leaves:
            continue
        if not isinstance(mod, (Linear, Embedding, MultiheadSelfAttention)):
            raise ValueError(f"{path} ({type(mod).__name__}): no split form "
                             f"for a model axis")
        if (isinstance(mod, MultiheadSelfAttention)
                and mod.num_heads % line.size):
            raise ValueError(f"{path}: {mod.num_heads} heads do not split "
                             f"over the {line.size} ranks of mesh axis "
                             f"{axis!r}")
        split = ModelSplit(line, leaves, full)
        with torch.no_grad():
            for name in leaves:
                old = mod._parameters[name]
                mod._parameters[name] = torch.nn.Parameter(
                    split.take(name, old.detach()).clone(),
                    requires_grad=old.requires_grad)
        mod.tp = split
        if isinstance(mod, MultiheadSelfAttention):
            mod.num_heads //= line.size
    return model


# ---------------------------------------------------------------------------
# logits split on the vocab
# ---------------------------------------------------------------------------

class ShardedLogits:
    """Logits whose last dim is split over a mesh line: ``local`` holds this
    rank's columns ``[index · v_local, (index + 1) · v_local)`` of
    ``vocab``.  It stands in for the global logits where the step, the
    loss and ``generate`` read them: ``reshape`` and indexing act on the
    leading dims, ``argmax(-1)`` is the global argmax (the lowest column on
    ties, as ``jnp.argmax``), :class:`~tpu_dist_torch.nn.CrossEntropyLoss`
    takes the loss on it without gathering it, and :meth:`gather` returns
    the whole tensor."""

    def __init__(self, local: torch.Tensor, line, vocab: int):
        if local.shape[-1] * line.size != vocab:
            raise ValueError(f"local logits {tuple(local.shape)} are not "
                             f"1/{line.size} of {vocab} columns")
        self.local, self.line, self.vocab = local, line, vocab

    @property
    def lo(self) -> int:
        return self.line.index * self.local.shape[-1]

    def _new(self, local):
        return ShardedLogits(local, self.line, self.vocab)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if shape[-1] != self.vocab:
            raise ValueError(f"reshape {shape}: the last dim stays the "
                             f"vocab ({self.vocab})")
        return self._new(self.local.reshape(*shape[:-1],
                                            self.local.shape[-1]))

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if len(idx) >= self.local.dim() or Ellipsis in idx:
            raise IndexError("index the leading dims of sharded logits only")
        return self._new(self.local[idx])

    def gather(self) -> torch.Tensor:
        """The whole logits (an all-gather over the line)."""
        return unshard_dim(self.local, self.local.dim() - 1, self.line)

    @torch.no_grad()
    def argmax(self, dim: int = -1) -> torch.Tensor:
        if dim not in (-1, self.local.dim() - 1):
            raise ValueError("sharded logits: argmax over the vocab only")
        val, idx = self.local.max(-1)
        best = _ops.all_reduce(val, self.line, "max")
        # the lowest global column holding the maximum, over the line
        cand = torch.where(val == best, idx + self.lo,
                           torch.full_like(idx, self.vocab))
        return _ops.all_reduce(cand, self.line, "min")


def full_logits(logits):
    """``logits`` as a plain tensor: a :class:`ShardedLogits` gathered."""
    return logits.gather() if isinstance(logits, ShardedLogits) else logits


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row nll of logits split on the vocab: K1f on this rank's slice
    with the labels shifted by its first column (out of range on the other
    ranks, where K1f picks nothing), the global lse from the ranks' lse (a
    max over the line, then a sum of ``exp(lse_r − m)``, all-reduced with
    the label's logit in one call); backward K1b on the slice with the
    GLOBAL lse: ``exp(logits − lse) − onehot``, the exact vocab-parallel
    gradient."""

    @staticmethod
    def forward(ctx, local, labels, line, fused):
        from ..ops import cross_entropy as ce
        v = local.shape[-1]
        fwd = ce.cross_entropy_fwd if fused else ce.cross_entropy_fwd_plain
        _, lse_r = fwd(local, labels)
        m = _ops.all_reduce(lse_r, line, "max")
        ok = (labels >= 0) & (labels < v)
        picked = local.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0]
        picked = torch.where(ok, picked.float(), torch.zeros_like(lse_r))
        both = _ops.psum(torch.stack([torch.exp(lse_r - m), picked]), line)
        lse = m + torch.log(both[0])
        ctx.fused = fused
        ctx.save_for_backward(local, labels, lse)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        from ..ops import cross_entropy as ce
        local, labels, lse = ctx.saved_tensors
        bwd = ce.cross_entropy_bwd if ctx.fused else ce.cross_entropy_bwd_plain
        return bwd(local, labels, lse, g.float().contiguous()), None, None, \
            None


def vocab_parallel_cross_entropy(logits: ShardedLogits, labels,
                                 reduction: str = "mean",
                                 ignore_index: int = -100,
                                 fused: bool = True):
    """Softmax cross-entropy of :class:`ShardedLogits` (..., vocab) and
    integer labels (...), without gathering the logits
    (:class:`_VocabParallelNLL`).  ``fused`` runs K1f/K1b on the slice
    (their plain versions on a CPU tensor); False, the plain versions
    everywhere.  Rows labelled ``ignore_index`` are masked, as
    :class:`~tpu_dist_torch.nn.CrossEntropyLoss` masks them."""
    local = logits.local.reshape(-1, logits.local.shape[-1]).contiguous()
    labels = labels.reshape(-1)
    keep = labels != ignore_index
    shifted = (torch.where(keep, labels, torch.zeros_like(labels))
               - logits.lo).contiguous()
    nll = _VocabParallelNLL.apply(local, shifted, logits.line, fused)
    nll = torch.where(keep, nll, torch.zeros_like(nll))
    if reduction == "mean":
        n = keep.sum().to(nll.dtype)
        return nll.sum() / n.clamp_min(torch.finfo(nll.dtype).tiny)
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"Unknown reduction {reduction!r}")
