"""``tpudlint`` driver: walk paths, parse, run rules, apply suppressions —
counterpart of ``tpu_dist/analysis/linter.py``.

Programmatic entry points (the CLI in ``__main__.py`` is a thin wrapper,
and tests/test_torch_lint_self.py gates the port on :func:`lint_paths`):

    from tpu_dist_torch.analysis import lint_paths
    findings = lint_paths(["tpu_dist_torch"])
    errors = [f for f in findings if not f.suppressed]
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional

from .findings import Finding, apply_suppressions
from .rules import RULES, run_rules

__all__ = ["lint_source", "lint_file", "lint_paths", "iter_python_files"]

_SKIP_DIRS = {"__pycache__", ".git", ".eggs", "build", "dist",
              ".pytest_cache"}


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one source string; returns findings with suppressions applied
    (suppressed findings are kept, marked ``suppressed=True``)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("TD000", "error", path, e.lineno or 1,
                        (e.offset or 1) - 1,
                        f"file does not parse: {e.msg}")]
    if rules is None:
        findings = run_rules(tree, path)
    else:
        wanted = {r.upper() for r in rules}
        findings = []
        for code, fn in RULES.items():
            out = fn(tree, path)
            # one rule function may emit several codes (TD001/TD002)
            findings.extend(f for f in out if f.rule in wanted)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    apply_suppressions(findings, source)
    return findings


def lint_file(path: str,
              rules: Optional[Iterable[str]] = None) -> List[Finding]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
    except OSError as e:
        return [Finding("TD000", "error", path, 1, 0,
                        f"cannot read file: {e}")]
    return lint_source(source, path, rules=rules)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            out.append(p)  # surfaces as a TD000 read error
    return sorted(dict.fromkeys(out))


def lint_paths(paths: Iterable[str],
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        findings.extend(lint_file(path, rules=rules))
    return findings
