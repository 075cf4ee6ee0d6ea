"""CI gate: tpudlint reports ZERO unsuppressed findings on the port's own
library — the default paths of ``python -m tpu_dist_torch.analysis``,
``tpu_dist_torch/`` less ``tpu_dist_torch/benchmarks/`` (the counterpart of
tests/test_lint_self.py's ``tpu_dist/`` + ``examples/``).

Suppressions stay within the JAX gate's bound, and each one carries its
reason in the comment.
"""

import functools
import os
import re
import subprocess
import sys

import pytest

from tpu_dist_torch.analysis import lint_paths
from tpu_dist_torch.analysis.__main__ import _default_paths

pytestmark = [pytest.mark.analysis]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a suppression comment, then its justification after a second '#'
_JUSTIFIED = re.compile(
    r"#\s*tpudlint:\s*disable=[A-Za-z0-9_,\s]+?\s*#\s*\S.{8,}")


@functools.lru_cache(maxsize=None)
def _findings():
    cwd = os.getcwd()
    try:
        os.chdir(_REPO)
        return lint_paths([os.path.abspath(p) for p in _default_paths()])
    finally:
        os.chdir(cwd)


def test_default_paths_are_the_library(monkeypatch):
    monkeypatch.chdir(_REPO)
    paths = _default_paths()
    names = {os.path.basename(p) for p in paths}
    assert "benchmarks" not in names
    assert {"analysis", "collectives", "dist", "examples", "launch",
            "checkpoint.py"} <= names
    # resolved against the package root from any other directory
    monkeypatch.chdir(os.path.dirname(_REPO))
    assert [os.path.basename(p) for p in _default_paths()] == sorted(names)


def test_tpudlint_clean_on_the_port():
    unsuppressed = [f for f in _findings() if not f.suppressed]
    assert not unsuppressed, (
        "tpudlint found unsuppressed distributed-correctness issues "
        "(fix them, or suppress WITH a justification comment):\n"
        + "\n".join(f.render() for f in unsuppressed))


def test_suppressions_stay_bounded():
    # the JAX gate's bound: raise it consciously, in review, alongside
    # new justifications
    suppressed = [f for f in _findings() if f.suppressed]
    assert len(suppressed) <= 10, "\n".join(f.render() for f in suppressed)


def test_every_suppression_carries_its_reason():
    for f in _findings():
        if not f.suppressed:
            continue
        with open(f.path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        # the finding's line, or the standalone comment lines above it
        cands = [lines[f.line - 1]]
        i = f.line - 2
        while i >= 0 and lines[i].lstrip().startswith("#"):
            cands.append(lines[i])
            i -= 1
        assert any(_JUSTIFIED.search(c) for c in cands
                   if f.rule in c or "all" in c), f.render()


def test_bare_invocation_exits_0(tmp_path):
    # from outside the repo: the default paths resolve against the
    # package root
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "tpu_dist_torch.analysis"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 error(s), 0 warning(s)" in r.stdout
    assert "TD000" not in r.stdout
