"""One logical-axis rule table for host-path partition layouts — the host
half of ``tpu_dist/parallel/rules.py``.

- a **rule table** maps logical axis names (``batch``/``heads``/``mlp``/
  ``vocab``/``embed``/...) to mesh dims (:data:`DEFAULT_RULES` for dp×tp
  training, :data:`SERVING_RULES` for the tensor-parallel serving gang);
- a **layout table** (:data:`TRANSFORMER_LAYOUTS`) maps parameter paths to
  the logical factorization of each tensor dim (a fused qkv weight's
  columns are ``(qkv3, heads, head_dim)``);
- :func:`spec_for` / :func:`spec_for_key` / :func:`partition_pairs` bind
  them into partition specs, the port's plain stand-in for a JAX
  ``PartitionSpec``: a tuple with one mesh-axis name or ``None`` per
  leading dim, ``()`` for a replicated leaf (``parallel/gspmd.py``'s
  :class:`~tpu_dist_torch.parallel.gspmd.PartitionRules` takes the pairs);
- :func:`spans_for` binds the two into contiguous flat element spans of one
  rank's slice, which :func:`shard_leaf` materializes and
  ``serve/sharded.py`` range-reads out of checkpoints;
- :func:`chunk_bounds` / :func:`chunk_span` are the flat ZeRO / reshard
  chunk contract (``chunk_bounds`` is the ring's ``_bounds``: one
  implementation, re-exported by ``collectives.bucketer`` under this
  name).

The layouts are the JAX package's: a Linear weight is (in, out), the fused
``qkv_weight`` (d, 3d), ``out_weight`` (d, d).  Spans and shards here are
therefore byte for byte the JAX package's; a port module takes a shard
through :func:`tpu_dist_torch.interop.load_jax_params`, which transposes
into torch's (out, in).  The specs are the JAX package's entry for entry:
``tuple(P)`` of its ``PartitionSpec``, trailing ``None``s included.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..collectives.ring import _bounds as chunk_bounds

__all__ = ["DEFAULT_RULES", "SERVING_RULES", "LeafLayout",
           "TRANSFORMER_LAYOUTS", "ShardLayoutError", "layout_for",
           "spec_for", "spec_for_key", "partition_pairs", "spans_for",
           "shard_leaf", "chunk_bounds", "chunk_span", "model_axes",
           "mapped_axes"]


class ShardLayoutError(ValueError):
    """A leaf cannot be laid out as asked: logical-axis size not divisible
    by the shard world, a dim factored by two different mesh axes, or a
    factorization that does not multiply out to the tensor's shape."""


# ---------------------------------------------------------------------------
# rule tables: logical axis -> mesh dim (None = replicated along that axis)
# ---------------------------------------------------------------------------

#: Training default — dp×tp on a ("data", "model") mesh: attention heads,
#: the MLP hidden width and the vocab split over the model dim.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "data",
    "seq": None,
    "embed": None,
    "qkv3": None,
    "heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": None,
}

#: Serving binding (serve/sharded.py): the shard gang splits heads and the
#: MLP hidden width only — head/tok stay full on every rank (lockstep
#: sampling needs full logits).
SERVING_RULES: Dict[str, Optional[str]] = {
    "batch": None,
    "seq": None,
    "embed": None,
    "qkv3": None,
    "heads": "shard",
    "head_dim": None,
    "mlp": "shard",
    "vocab": None,
    "expert": None,
}


# ---------------------------------------------------------------------------
# layout table: parameter path -> per-dim logical factorization
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafLayout:
    """Logical factorization of one parameter tensor (JAX layout).

    ``dims``: for each leading tensor dim, the tuple of logical axis names
    whose sizes multiply to that dim, row-major — ``("qkv3", "heads",
    "head_dim")`` is the fused qkv column layout ``[3][H][hd]``.

    ``partial_axis``: set on row-parallel output biases (attn out_bias, mlp
    down bias): when the named axis is sharded, the matmul feeding the bias
    produces rank-partial sums and the bias must be added once after the
    combine — ``spans_for(partial="first")`` gives it to rank 0 alone,
    ``"replicate"`` to every rank."""

    dims: Tuple[Tuple[str, ...], ...]
    partial_axis: Optional[str] = None


#: (path regex, name regex, layout) — first fullmatch wins.  Paths are the
#: module paths of ``TransformerLM`` (the same in both packages).
TRANSFORMER_LAYOUTS: Tuple[Tuple[str, str, LeafLayout], ...] = (
    (r"block\d+\.attn", r"qkv_weight",
     LeafLayout((("embed",), ("qkv3", "heads", "head_dim")))),
    (r"block\d+\.attn", r"qkv_bias",
     LeafLayout((("qkv3", "heads", "head_dim"),))),
    (r"block\d+\.attn", r"out_weight",
     LeafLayout((("heads", "head_dim"), ("embed",)))),
    (r"block\d+\.attn", r"out_bias",
     LeafLayout((("embed",),), partial_axis="heads")),
    (r"block\d+\.mlp\.0", r"weight", LeafLayout((("embed",), ("mlp",)))),
    (r"block\d+\.mlp\.0", r"bias", LeafLayout((("mlp",),))),
    (r"block\d+\.mlp\.2", r"weight", LeafLayout((("mlp",), ("embed",)))),
    (r"block\d+\.mlp\.2", r"bias",
     LeafLayout((("embed",),), partial_axis="mlp")),
    (r"head", r"weight", LeafLayout((("embed",), ("vocab",)))),
    (r"head", r"bias", LeafLayout((("vocab",),))),
    (r"tok", r"weight", LeafLayout((("vocab",), ("embed",)))),
    (r"pos", r"weight", LeafLayout((("seq",), ("embed",)))),
    # MoE expert banks (nn.moe): leading dim is the expert bank
    (r"block\d+\.mlp", r"[wb][12]", LeafLayout((("expert",),))),
)


def layout_for(path: str, name: str,
               table: Sequence[Tuple[str, str, LeafLayout]] = None
               ) -> Optional[LeafLayout]:
    """First layout row whose (path, name) regexes fullmatch, else None
    (= unfactored: replicated under every rule binding)."""
    for ppat, npat, lay in (TRANSFORMER_LAYOUTS if table is None else table):
        if re.fullmatch(ppat, path) and re.fullmatch(npat, name):
            return lay
    return None


def mapped_axes(rules: Dict[str, Optional[str]], mesh_axis: str
                ) -> Tuple[str, ...]:
    """Logical axes the rule table binds to ``mesh_axis``."""
    return tuple(a for a, m in rules.items() if m == mesh_axis)


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------

def _dim_mesh_axis(factors: Tuple[str, ...],
                   rules: Dict[str, Optional[str]]) -> Optional[str]:
    mapped = [rules.get(f) for f in factors if rules.get(f) is not None]
    if len(set(mapped)) > 1:
        raise ShardLayoutError(
            f"dim factored as {factors} maps to multiple mesh axes "
            f"{sorted(set(mapped))} — a tensor dim shards along at most one")
    return mapped[0] if mapped else None


def _spec(lay: Optional[LeafLayout], rules: Dict[str, Optional[str]]
          ) -> tuple:
    if lay is None:
        return ()
    entries = tuple(_dim_mesh_axis(f, rules) for f in lay.dims)
    return entries if any(e is not None for e in entries) else ()


def spec_for(path: str, name: str, rules: Dict[str, Optional[str]] = None,
             table: Sequence[Tuple[str, str, LeafLayout]] = None) -> tuple:
    """The partition spec of one parameter under a rule binding: one mesh
    axis or ``None`` per factored dim, ``()`` when no dim is sharded (the
    spec an unmatched leaf gets from ``PartitionRules``)."""
    return _spec(layout_for(path, name, table),
                 DEFAULT_RULES if rules is None else rules)


_KEY_RE = re.compile(r"^\['([^']+)'\]\['([^']+)'\]$")


def spec_for_key(keystr: str, rules: Dict[str, Optional[str]] = None,
                 table: Sequence[Tuple[str, str, LeafLayout]] = None
                 ) -> tuple:
    """:func:`spec_for` addressed by a JAX ``keystr`` path like
    ``['block0.attn']['qkv_weight']`` (the form the rule regexes match);
    ``()`` for any other string."""
    m = _KEY_RE.match(keystr)
    if m is None:
        return ()
    return spec_for(m.group(1), m.group(2), rules, table)


def partition_pairs(rules: Dict[str, Optional[str]] = None,
                    table: Sequence[Tuple[str, str, LeafLayout]] = None
                    ) -> List[Tuple[str, tuple]]:
    """``(keystr regex, spec)`` pairs for :class:`~tpu_dist_torch.parallel.
    gspmd.PartitionRules`, derived from the layout and rule tables.  Rows
    that come out fully replicated are dropped (the rules answer ``()`` for
    an unmatched leaf)."""
    rules = DEFAULT_RULES if rules is None else rules
    pairs = []
    for ppat, npat, lay in (TRANSFORMER_LAYOUTS if table is None else table):
        spec = _spec(lay, rules)
        if spec:
            pairs.append((r"\['" + ppat + r"'\]\['" + npat + r"'\]", spec))
    return pairs


# ---------------------------------------------------------------------------
# host-path spans
# ---------------------------------------------------------------------------

def _find_sharded(lay: LeafLayout, rules: Dict[str, Optional[str]],
                  mesh_axis: str) -> Optional[Tuple[int, int]]:
    """(dim index, factor index) of the factor riding ``mesh_axis``."""
    hits = [(d, j) for d, factors in enumerate(lay.dims)
            for j, f in enumerate(factors) if rules.get(f) == mesh_axis]
    if len(hits) > 1:
        raise ShardLayoutError(
            f"layout {lay.dims} maps {len(hits)} factors to mesh axis "
            f"{mesh_axis!r} — host-path sharding splits exactly one")
    return hits[0] if hits else None


def _full(shape: Tuple[int, ...]):
    return [(0, int(np.prod(shape, dtype=np.int64)) if shape else 1)], shape


def spans_for(path: str, name: str, shape: Tuple[int, ...],
              axes: Dict[str, int], rank: int, world: int,
              rules: Dict[str, Optional[str]] = None,
              mesh_axis: str = "model", partial: str = "first",
              table: Sequence[Tuple[str, str, LeafLayout]] = None
              ) -> Optional[Tuple[List[Tuple[int, int]], Tuple[int, ...]]]:
    """``(contiguous flat element spans, local shape)`` of shard ``rank``'s
    slice of a parameter (JAX layout), or None when this rank holds nothing
    (a partial-sum bias under ``partial="first"`` on rank > 0).

    ``axes`` gives the logical axis sizes (:func:`model_axes`).  Every span
    is contiguous in the flat row-major layout, so in-memory slicing and
    checkpoint range-reads assemble identical shards."""
    if rules is None:
        rules = DEFAULT_RULES
    shape = tuple(int(s) for s in shape)
    lay = layout_for(path, name, table)
    if lay is None:
        return _full(shape)
    if lay.partial_axis is not None and rules.get(lay.partial_axis) \
            == mesh_axis and world > 1:
        if partial == "replicate":
            return _full(shape)
        return _full(shape) if rank == 0 else None
    sh = _find_sharded(lay, rules, mesh_axis)
    if sh is None:
        return _full(shape)
    d, j = sh
    factors = lay.dims[d]
    try:
        sizes = [int(axes[f]) for f in factors]
    except KeyError as e:
        raise ShardLayoutError(
            f"axis size for {e.args[0]!r} missing (leaf {path}.{name}); "
            f"pass it in `axes` (see model_axes)") from None
    if d >= len(shape) or int(np.prod(sizes, dtype=np.int64)) != shape[d]:
        raise ShardLayoutError(
            f"leaf {path}.{name} dim {d} is "
            f"{shape[d] if d < len(shape) else None}, "
            f"but factors {factors} multiply to {sizes}")
    nj = sizes[j]
    if nj % world:
        raise ShardLayoutError(
            f"logical axis {factors[j]!r} of size {nj} not divisible by "
            f"shard world {world} (leaf {path}.{name})")
    chunk = nj // world
    start = rank * chunk
    outer = int(np.prod(shape[:d], dtype=np.int64)) * \
        int(np.prod(sizes[:j], dtype=np.int64))
    inner = int(np.prod(sizes[j + 1:], dtype=np.int64)) * \
        int(np.prod(shape[d + 1:], dtype=np.int64))
    spans = [(o * nj * inner + start * inner,
              o * nj * inner + (start + chunk) * inner)
             for o in range(outer)]
    out_shape = shape[:d] + (shape[d] // world,) + shape[d + 1:]
    return spans, out_shape


def shard_leaf(arr: np.ndarray, plan) -> Optional[np.ndarray]:
    """Materialize one shard from a :func:`spans_for` plan (None passes
    through: the rank holds nothing)."""
    if plan is None:
        return None
    spans, out_shape = plan
    flat = np.ascontiguousarray(arr).reshape(-1)
    if len(spans) == 1:
        lo, hi = spans[0]
        return flat[lo:hi].reshape(out_shape).copy()
    return np.concatenate([flat[lo:hi] for lo, hi in spans]
                          ).reshape(out_shape)


# ---------------------------------------------------------------------------
# flat chunk bounds — the ZeRO / reshard contract
# ---------------------------------------------------------------------------

# chunk_bounds(n_elems, world): per-rank [lo, hi) bounds of a flat buffer
# split into ``world`` near-equal contiguous chunks (the first
# ``n_elems % world`` get one extra element) — the ring's ``_bounds``,
# imported above: the ring reduce-scatter's, ZeRO's and the reshard
# manifests' one contract.

def chunk_span(n_elems: int, world: int, rank: int) -> Tuple[int, int]:
    """Rank's own [lo, hi) from :func:`chunk_bounds`."""
    return chunk_bounds(n_elems, world)[rank]


# ---------------------------------------------------------------------------
# logical axis sizes
# ---------------------------------------------------------------------------

def model_axes(model) -> Dict[str, int]:
    """Logical axis sizes of a ``TransformerLM``-shaped model, keyed by the
    names the layout table uses, probed off its modules (``block0.attn``,
    ``block0.mlp``, ``head``, ``pos``)."""
    axes: Dict[str, int] = {"qkv3": 3}
    blk = getattr(model, "block0", None)
    attn = getattr(blk, "attn", None)
    if attn is not None:
        axes["embed"] = attn.embed_dim
        axes["heads"] = attn.num_heads
        axes["head_dim"] = attn.head_dim
    mlp = getattr(blk, "mlp", None)
    try:
        up = mlp[0] if mlp is not None else None
    except (TypeError, IndexError, KeyError, NotImplementedError):
        up = None
    if up is not None and hasattr(up, "out_features"):
        axes["mlp"] = up.out_features
    head = getattr(model, "head", None)
    if head is not None and hasattr(head, "out_features"):
        axes["vocab"] = head.out_features
    pos = getattr(model, "pos", None)
    if pos is not None and hasattr(pos, "num_embeddings"):
        axes["seq"] = pos.num_embeddings
    if mlp is not None and hasattr(mlp, "num_experts"):
        axes["expert"] = mlp.num_experts
    return axes
