"""Pytrees of the port's collectives: dicts (flattened in sorted key order,
as ``jax.tree`` flattens them), lists and tuples of leaves; ``None`` is an
empty subtree."""

from __future__ import annotations

from typing import Any, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX's flatten order."""
    leaves: List[Any] = []

    def walk(v):
        if v is None:
            return ("none",)
        if isinstance(v, dict):
            return ("dict", [(k, walk(v[k])) for k in sorted(v)])
        if _is_namedtuple(v):
            return ("ntuple", type(v), [walk(e) for e in v])
        if isinstance(v, (list, tuple)):
            return ("seq", type(v), [walk(e) for e in v])
        leaves.append(v)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in d[1]}
        if kind == "ntuple":
            return d[1](*(build(c) for c in d[2]))
        return d[1](build(c) for c in d[2])

    return build(treedef)


def tree_map(fn, tree):
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(v) for v in leaves])


def treedef_str(treedef) -> str:
    """``str(treedef)`` as JAX renders it (``PyTreeDef({'a': [*, None]})``),
    for a treedef of :func:`flatten`: the sanitizer hashes this string, so
    a mixed gang signs the same trees alike."""

    def show(d):
        kind = d[0]
        if kind == "none":
            return "None"
        if kind == "leaf":
            return "*"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {show(c)}" for k, c in d[1]) + "}"
        if kind == "ntuple":
            return (f"CustomNode(namedtuple[{d[1].__name__}], ["
                    + ", ".join(show(c) for c in d[2]) + "])")
        items = [show(c) for c in d[2]]
        if issubclass(d[1], tuple):
            return "(" + ", ".join(items) + ("," if len(items) == 1 else "") \
                + ")"
        return "[" + ", ".join(items) + "]"

    return f"PyTreeDef({show(treedef)})"
