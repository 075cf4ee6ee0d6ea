"""``python -m tpu_dist_torch.analysis [lint|graph|replay]`` — the analysis
CLI; counterpart of ``tpu_dist/analysis/__main__.py`` (the same flags and
exit codes).

Three tools share one findings/JSON/exit-code machinery
(tpu_dist_torch/analysis/findings.py):

- ``lint`` (default — a bare ``python -m tpu_dist_torch.analysis <paths>``
  lints too): the tpudlint AST linter, TD001–TD011; with no paths, the
  port's library (``tpu_dist_torch/`` less ``tpu_dist_torch/benchmarks/``,
  the counterpart of the JAX package's ``tpu_dist`` + ``examples``).
- ``graph``: the static whole-graph protocol verifier (protocol.py),
  TD101–TD105 — deadlock cycles with a printed witness schedule,
  claim-safety, restart-policy soundness, dp-path feasibility.
- ``replay``: the offline trace-replay sanitizer (replay.py),
  TD110–TD115 — re-verifies a flight-recorder dump directory post-hoc
  and embeds the ``obs diagnose`` dict in its JSON report.

Exit codes (all three): 0 = clean (no unsuppressed finding at/above
``--fail-on``), 1 = findings, 2 = usage error.  ``--format json`` emits
the findings schema; ``replay --format json`` adds ``diagnosis`` (the
same schema ``python -m tpu_dist_torch.obs diagnose --json`` prints).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .findings import SEVERITY_ORDER, render_json, render_text
from .linter import lint_paths
from .rules import RULE_DOCS


def _default_paths() -> List[str]:
    """``tpu_dist_torch``'s modules and subpackages less ``benchmarks``
    (drivers, as the JAX package's top-level ``benchmarks/`` are),
    resolved against the CWD first and the repo/package root second — so
    the documented bare invocation works from any directory instead of
    emitting TD000 read errors."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for base in ("tpu_dist_torch", os.path.join(root, "tpu_dist_torch")):
        if os.path.isdir(base):
            paths = [os.path.join(base, name)
                     for name in sorted(os.listdir(base))
                     if name != "benchmarks"]
            return [p for p in paths
                    if os.path.isdir(p) or p.endswith(".py")]
    return []


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis",
        description="tpudlint: distributed-correctness linter for "
                    "tpu_dist_torch programs (rank-divergent collectives, "
                    "un-namespaced store keys, deadline-less waits, host "
                    "effects under jit or a capture, lock-order cycles).  "
                    "Subcommands: `graph` "
                    "(static role-graph protocol verifier) and `replay` "
                    "(offline flight-recorder replay sanitizer).")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: the "
                        "port's tpu_dist_torch dir less its benchmarks, "
                        "resolved against the CWD and then the installed "
                        "package root)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--rules", type=str, default=None,
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--fail-on", choices=("warning", "error", "never"),
                   default="warning",
                   help="minimum unsuppressed severity that makes the exit "
                        "code non-zero (default: warning, i.e. any finding)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed findings in text output")
    p.add_argument("--list-rules", action="store_true")
    return p


def _finish(findings, fmt: str, fail_on: str,
            show_suppressed: bool = False,
            extra_json: Optional[dict] = None) -> int:
    """Shared rendering + exit-code tail for all three subcommands."""
    if fmt == "json":
        doc = render_json(findings)
        if extra_json:
            doc.update(extra_json)
        print(json.dumps(doc, indent=2))
    else:
        print(render_text(findings, show_suppressed=show_suppressed))
    if fail_on == "never":
        return 0
    threshold = SEVERITY_ORDER[fail_on]
    worst = max((SEVERITY_ORDER[f.severity] for f in findings
                 if not f.suppressed), default=0)
    return 1 if worst >= threshold else 0


# -- graph subcommand ---------------------------------------------------------


def build_graph_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis graph",
        description="Static whole-graph protocol verifier (TD101-TD105): "
                    "model-checks a RoleGraph + ChannelSpec topology for "
                    "bounded-channel deadlock cycles (witness schedule "
                    "printed), claim-safety under solo restarts, "
                    "restart-policy soundness and dp-path feasibility — "
                    "before a single process is spawned.")
    p.add_argument("script", nargs="?", default=None,
                   help="Python file to AST-extract literal "
                        "ChannelSpec(...) calls from (combined with "
                        "--roles)")
    p.add_argument("--roles", type=str, default=None,
                   help="role spec, launcher grammar: "
                        "name:world[:policy][@node],...")
    p.add_argument("--channels", type=str, default=None,
                   help="channel spec: "
                        "name:src>dst[:depth][:queue|latest]"
                        "[:payload=BYTES],...")
    p.add_argument("--graph", type=str, default=None, dest="graph",
                   help="import a graph builder instead: file.py:func or "
                        "pkg.mod:func (called with --graph-args)")
    p.add_argument("--graph-args", type=str, default=None,
                   help="JSON list of positional args for --graph "
                        "(e.g. '[4]')")
    p.add_argument("--nnodes", type=int, default=None,
                   help="cluster size for @node pin validation")
    p.add_argument("--dp-threshold", type=int, default=None,
                   help="payload bytes for TD104 (default: "
                        "TPU_DIST_DP_THRESHOLD or 65536)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--fail-on", choices=("warning", "error", "never"),
                   default="warning")
    p.add_argument("--list-rules", action="store_true")
    return p


def graph_main(argv: List[str]) -> int:
    from .protocol import GRAPH_RULE_DOCS, build_graph, verify_graph

    args = build_graph_parser().parse_args(argv)
    if args.list_rules:
        for code in sorted(GRAPH_RULE_DOCS):
            print(f"{code}  {GRAPH_RULE_DOCS[code]}")
        return 0
    label = (args.graph or args.script
             or (f"--roles {args.roles}" if args.roles else "<graph>"))
    try:
        graph, findings, notes = build_graph(
            roles_spec=args.roles, script=args.script,
            channels_spec=args.channels, graph_target=args.graph,
            graph_args=args.graph_args, path=label)
    except Exception as e:
        sys.stderr.write(f"graph: {e}\n")
        return 2
    for note in notes:
        sys.stderr.write(f"note: {note}\n")
    if graph is not None:
        findings = findings + verify_graph(
            graph, nnodes=args.nnodes, dp_threshold=args.dp_threshold,
            path=label)
        extra = {"graph": json.loads(graph.to_json()), "tool": "graph"}
    else:
        extra = {"graph": None, "tool": "graph"}
    return _finish(findings, args.format, args.fail_on, extra_json=extra)


# -- replay subcommand --------------------------------------------------------


def build_replay_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis replay",
        description="Offline trace-replay sanitizer (TD110-TD115): "
                    "re-verifies a flight-recorder dump directory — "
                    "lockstep collective linearization, store-key "
                    "lifecycle, channel cursor invariants, serve "
                    "plan/ack pairing — and embeds the obs diagnose "
                    "verdict in its JSON report.")
    p.add_argument("path",
                   help="dump directory (obs_g*_r*.json) or one dump file")
    p.add_argument("--generation", type=int, default=None,
                   help="replay this generation (default: newest found)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--fail-on", choices=("warning", "error", "never"),
                   default="warning")
    p.add_argument("--list-rules", action="store_true")
    return p


def replay_main(argv: List[str]) -> int:
    from .replay import REPLAY_RULE_DOCS, replay_dir

    if "--list-rules" in argv:
        for code in sorted(REPLAY_RULE_DOCS):
            print(f"{code}  {REPLAY_RULE_DOCS[code]}")
        return 0
    args = build_replay_parser().parse_args(argv)
    report = replay_dir(args.path, generation=args.generation)
    if not report.ranks:
        sys.stderr.write(f"replay: no flight-recorder dumps under "
                         f"{args.path!r}\n")
        return 2
    doc = report.to_json()
    extra = {k: doc[k] for k in ("tool", "generation", "ranks",
                                 "diagnosis")}
    if args.format == "text":
        from ..obs.trace import render_diagnosis
        print(f"replay: generation {report.generation}, "
              f"ranks {report.ranks}")
        print(render_diagnosis(report.diagnosis))
    return _finish(report.findings, args.format, args.fail_on,
                   extra_json=extra)


# -- dispatch -----------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "graph":
        return graph_main(argv[1:])
    if argv and argv[0] == "replay":
        return replay_main(argv[1:])
    if argv and argv[0] == "lint":
        argv = argv[1:]
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for code in sorted(RULE_DOCS):
            print(f"{code}  {RULE_DOCS[code]}")
        return 0
    paths = args.paths or _default_paths()
    if not paths:
        sys.stderr.write("no paths given and no tpu_dist_torch dir "
                         "found near the CWD or package root\n")
        return 2
    rules = ([r.strip().upper() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    if rules:
        unknown = [r for r in rules if r not in RULE_DOCS and r != "TD000"]
        if unknown:
            sys.stderr.write(f"unknown rule(s): {', '.join(unknown)} "
                             f"(see --list-rules)\n")
            return 2
    findings = lint_paths(paths, rules=rules)
    return _finish(findings, args.format, args.fail_on,
                   show_suppressed=args.show_suppressed)


if __name__ == "__main__":
    sys.exit(main())
