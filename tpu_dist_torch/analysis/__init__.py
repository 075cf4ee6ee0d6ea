"""tpu_dist_torch.analysis — distributed-correctness tooling.

For now only the runtime collective sanitizer (``TPU_DIST_SANITIZE=1`` or
``python -m tpu_dist_torch.launch --sanitize``): every eager host
collective cross-checks a per-call signature (op, tree structure, leaf
dtypes and shapes, root rank, wire format) across ranks through the
generation-scoped store before any payload moves, and raises
:class:`CollectiveMismatchError` naming the divergent rank and call-site
within a bounded deadline instead of hanging.  The JAX package's linter,
role-graph protocol verifier and trace replay are ROADMAP A9.7.
"""

from .sanitizer import CollectiveMismatchError, check_collective, enabled

__all__ = ["CollectiveMismatchError", "check_collective", "enabled"]
