"""Finding model + suppression handling for ``tpudlint`` — counterpart of
``tpu_dist/analysis/findings.py`` (the same grammar, schema and order).

A :class:`Finding` is one rule violation at one source location.  Findings
carry a severity (``error`` > ``warning``) and render to the stable text
format ``path:line:col: TDnnn [severity] message`` or to the JSON schema::

    {"version": 1,
     "findings": [{"rule": "TD001", "severity": "error", "path": "...",
                   "line": 3, "col": 4, "message": "..."}],
     "counts": {"error": 1, "warning": 0, "suppressed": 2}}

Suppressions (``# tpudlint: disable=TD001`` or ``disable=TD001,TD004``):

- on the same physical line as the finding — suppresses those rules for
  that line;
- on a standalone comment line — suppresses those rules for the next
  non-blank line (so long flagged lines can carry a justification above);
- ``disable=all`` suppresses every rule for the covered line.

Suppressed findings are kept (marked) rather than dropped, so the JSON
output can audit what was silenced and the self-lint gate can distinguish
"clean" from "suppressed with a justification".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

__all__ = ["Finding", "SEVERITY_ORDER", "suppressed_rules_by_line",
           "apply_suppressions", "render_text", "render_json"]

# higher = more severe; CLI --fail-on thresholds compare through this
SEVERITY_ORDER = {"warning": 1, "error": 2}

_SUPPRESS_RE = re.compile(
    r"#\s*tpudlint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:#|$)")


@dataclasses.dataclass
class Finding:
    rule: str          # "TD001" .. "TD006" ("TD000" = file failed to parse)
    severity: str      # "error" | "warning"
    path: str
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    suppressed: bool = False

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "message": self.message, "suppressed": self.suppressed}

    def render(self) -> str:
        sup = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.severity}]{sup} {self.message}")


def suppressed_rules_by_line(source: str) -> Dict[int, set]:
    """Map 1-based line number -> set of rule codes suppressed there.

    The set may contain ``"all"``.  A standalone suppression comment covers
    the next non-blank line as well as its own.
    """
    out: Dict[int, set] = {}
    lines = source.splitlines()
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip().upper() if r.strip().lower() != "all" else "all"
                 for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if raw.lstrip().startswith("#"):
            # standalone comment: also covers the next code line (blank
            # lines and further comment lines — e.g. a stacked suppression
            # — are skipped, so stacked standalone suppressions all land
            # on the same code line)
            for j in range(i, len(lines)):
                stripped = lines[j].strip()
                if stripped and not stripped.startswith("#"):
                    out.setdefault(j + 1, set()).update(rules)
                    break
    return out


def apply_suppressions(findings: List[Finding], source: str) -> None:
    """Mark findings whose line carries a matching suppression comment."""
    by_line = suppressed_rules_by_line(source)
    for f in findings:
        rules = by_line.get(f.line)
        if rules and ("all" in rules or f.rule.upper() in rules):
            f.suppressed = True


def counts(findings: List[Finding]) -> Dict[str, int]:
    out = {"error": 0, "warning": 0, "suppressed": 0}
    for f in findings:
        if f.suppressed:
            out["suppressed"] += 1
        else:
            out[f.severity] = out.get(f.severity, 0) + 1
    return out


def render_text(findings: List[Finding],
                show_suppressed: bool = False) -> str:
    lines = [f.render() for f in findings
             if show_suppressed or not f.suppressed]
    c = counts(findings)
    lines.append(f"tpudlint: {c['error']} error(s), {c['warning']} "
                 f"warning(s), {c['suppressed']} suppressed")
    return "\n".join(lines)


def render_json(findings: List[Finding],
                show_suppressed: bool = True) -> Dict:
    return {"version": 1,
            "findings": [f.to_dict() for f in findings
                         if show_suppressed or not f.suppressed],
            "counts": counts(findings)}


def worst_unsuppressed(findings: List[Finding]) -> Optional[str]:
    """The highest severity among unsuppressed findings, or None."""
    worst = None
    for f in findings:
        if f.suppressed:
            continue
        if worst is None or SEVERITY_ORDER[f.severity] > SEVERITY_ORDER[worst]:
            worst = f.severity
    return worst
