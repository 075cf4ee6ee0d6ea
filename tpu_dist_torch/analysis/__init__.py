"""tpu_dist_torch.analysis — distributed-correctness tooling; counterpart of
``tpu_dist.analysis`` (the same tools, rule codes and JSON schema).

Four tools:

- **tpudlint**, a static AST pass over the port's programs
  (``python -m tpu_dist_torch.analysis <paths>``): rule classes
  TD001–TD011 for the hazards that silently deadlock an eager-SPMD world —
  collectives under rank conditionals, divergent collective sequences,
  un-namespaced store keys, deadline-less blocking waits, host side
  effects under trace-once code (``jax.jit``, a ``torch.cuda.graph``
  capture, ``torch.jit``), inconsistent lock order.
  ``# tpudlint: disable=TDnnn`` suppressions, text/JSON output,
  CI-friendly exit codes.
- the **runtime sanitizer** (``TPU_DIST_SANITIZE=1`` or ``python -m
  tpu_dist_torch.launch --sanitize``): every eager host collective
  cross-checks a per-call signature (op, tree structure, leaf dtypes and
  shapes, root rank, wire format) across ranks through the
  generation-scoped store before any payload moves, and raises
  :class:`CollectiveMismatchError` naming the divergent rank and call-site
  within a bounded deadline instead of hanging.
- the **static whole-graph protocol verifier** (protocol.py,
  ``python -m tpu_dist_torch.analysis graph``, the launcher's
  ``--verify_graph`` pre-flight): model-checks a RoleGraph + ChannelSpec
  topology — bounded-channel deadlock cycles with a printed witness
  schedule, claim-safety under solo restarts, restart-policy soundness,
  dp-path feasibility (TD101–TD105).
- the **offline trace-replay sanitizer** (replay.py,
  ``python -m tpu_dist_torch.analysis replay <dump-dir>``): re-verifies a
  flight-recorder dump post-hoc — lockstep collective linearization,
  store-key lifecycle, channel cursor invariants, serve plan/ack pairing
  (TD110–TD115) — sharing one JSON schema with ``obs diagnose``.
"""

from .findings import Finding, render_json, render_text
from .linter import lint_file, lint_paths, lint_source
from .protocol import (GRAPH_RULE_DOCS, extract_channel_specs,
                       parse_channels_spec, verify_graph)
from .replay import (REPLAY_RULE_DOCS, ReplayReport, replay_dir,
                     replay_dumps)
from .rules import RULE_DOCS, RULES
from .sanitizer import CollectiveMismatchError, check_collective, enabled

__all__ = ["Finding", "lint_source", "lint_file", "lint_paths",
           "render_text", "render_json", "RULES", "RULE_DOCS",
           "CollectiveMismatchError", "check_collective", "enabled",
           "GRAPH_RULE_DOCS", "verify_graph", "extract_channel_specs",
           "parse_channels_spec",
           "REPLAY_RULE_DOCS", "ReplayReport", "replay_dumps",
           "replay_dir"]
