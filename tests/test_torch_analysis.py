"""tpudlint in the port (``tpu_dist_torch.analysis``) against the JAX
package's linter.

Every fixture of tests/test_analysis.py — one positive and one negative
source per rule TD001–TD011, both TD007 pairs, the inline sources of its
method tests, the suppression variants and the JSON schema — goes through
both linters: the ``(rule, severity, line, col, suppressed)`` lists are
identical and the messages differ at most in the package's name.  The
port's own TD005 fixtures (a ``torch.cuda.graph`` capture,
``make_graphed_callables``, ``torch.jit``) fire in the port only.
"""

import importlib.util
import json
import pathlib
import textwrap

import pytest

from tpu_dist.analysis import lint_source as jlint
from tpu_dist.analysis.__main__ import main as jmain
from tpu_dist.analysis.findings import render_json as jrender_json
from tpu_dist.analysis.rules import RULE_DOCS as JRULE_DOCS
from tpu_dist_torch.analysis import lint_source as tlint
from tpu_dist_torch.analysis.__main__ import main as tmain
from tpu_dist_torch.analysis.findings import render_json as trender_json
from tpu_dist_torch.analysis.rules import RULE_DOCS as TRULE_DOCS

pytestmark = [pytest.mark.analysis]

_TESTS = pathlib.Path(__file__).resolve().parent


def _jax_fixtures():
    """The module-level ``TDnnn_*`` sources of tests/test_analysis.py."""
    spec = importlib.util.spec_from_file_location(
        "_jax_analysis_fixtures", _TESTS / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if k.startswith("TD") and isinstance(v, str)}


FIXTURES = _jax_fixtures()

# the sources tests/test_analysis.py builds inside its method tests
INLINE = {
    "td002_nested_matching": """
        def step(x, rank, fast, group):
            if rank == 0:
                y = C.all_reduce_host(x, group=group)
            else:
                if fast:
                    y = C.all_reduce_host(x, group=group)
                else:
                    y = C.all_reduce_host(x, group=group)
            return y
    """,
    "td006_multi_item": """
        class T:
            def a(self):
                with self._mu, self._cv:
                    pass

            def b(self):
                with self._cv:
                    with self._mu:
                        pass
    """,
    "td007_sync_and_used": """
        def sync_grads(g, group, works):
            C.all_reduce_host(g, group=group, op="avg")   # sync: fine
            w = C.broadcast_host(g, group=group, async_op=True)
            works.append(w)                               # use: fine
            h = C.recv(src=1, group=group, async_op=True)
            return h.wait(timeout=300)
    """,
    "stacked_suppressions": """
        def sync(store, keys):
            # tpudlint: disable=TD004  # caller owns the deadline
            # tpudlint: disable=TD003  # would-be second concern
            store.wait(keys)
    """,
    "syntax_error": "def broken(:\n",
}

_CALL = "y = C.all_reduce_host(x, group=group)"
# the suppression variants of tests/test_analysis.py::TestSuppressions
SUPPRESSED = {
    "same_line": FIXTURES["TD001_POS"].replace(
        _CALL, _CALL + "  # tpudlint: disable=TD001"),
    "standalone": FIXTURES["TD001_POS"].replace(
        "        " + _CALL,
        "        # tpudlint: disable=TD001  # justified: rank-0 only "
        "world\n        " + _CALL),
    "rule_specific": FIXTURES["TD001_POS"].replace(
        _CALL, _CALL + "  # tpudlint: disable=TD004"),
    "disable_all": FIXTURES["TD001_POS"].replace(
        _CALL, _CALL + "  # tpudlint: disable=all"),
}

SOURCES = dict(FIXTURES)
SOURCES.update({k: textwrap.dedent(v) for k, v in INLINE.items()})
SOURCES.update({f"suppressed_{k}": v for k, v in SUPPRESSED.items()})


def _norm(message: str) -> str:
    return message.replace("tpu_dist_torch", "tpu_dist")


def _shape(findings):
    return [(f.rule, f.severity, f.path, f.line, f.col, f.suppressed,
             _norm(f.message)) for f in findings]


def test_every_jax_fixture_is_covered():
    # 12 rule pairs + the TD001 early exit + the extra TD003/TD004/TD007/
    # TD008/TD009/TD010 sources; a fixture added later joins the matrix
    assert len(FIXTURES) >= 40
    for rule in ("TD001", "TD002", "TD003", "TD004", "TD005", "TD006",
                 "TD007", "TD008", "TD009", "TD010", "TD011"):
        assert f"{rule}_POS" in FIXTURES and f"{rule}_NEG" in FIXTURES


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_both_linters_give_identical_findings(name):
    src = SOURCES[name]
    path = f"{name.lower()}.py"
    jf, tf = jlint(src, path), tlint(src, path)
    assert _shape(tf) == _shape(jf)
    if name.endswith("_POS") and name[:5] in JRULE_DOCS:
        assert name[:5] in [f.rule for f in tf if not f.suppressed]
    if name.endswith("_NEG"):
        assert [f for f in tf if not f.suppressed] == []


@pytest.mark.parametrize("path", ["tpu_dist/parallel/rules.py",
                                  "tpu_dist/parallel/gspmd.py",
                                  "tpu_dist/parallel/fsdp.py",
                                  "tpu_dist_torch/parallel/rules.py",
                                  "t.py"])
def test_td011_allowlist_is_the_same(path):
    src = FIXTURES["TD011_POS"]
    assert _shape(tlint(src, path)) == _shape(jlint(src, path))


@pytest.mark.parametrize("rules", [["TD004"], ["TD001", "TD003"],
                                   ["td007"]])
def test_rule_subsets_agree(rules):
    src = "\n".join(FIXTURES[k] for k in ("TD001_POS", "TD003_POS",
                                           "TD004_POS", "TD007_POS"))
    assert _shape(tlint(src, "t.py", rules=rules)) == \
        _shape(jlint(src, "t.py", rules=rules))


def test_json_schema_is_the_same():
    found = (tlint(FIXTURES["TD001_POS"], "t.py"),
             jlint(FIXTURES["TD001_POS"], "t.py"))
    docs = [trender_json(found[0]), jrender_json(found[1])]
    assert docs[0]["version"] == 1
    assert set(docs[0]["findings"][0]) == {"rule", "severity", "path",
                                           "line", "col", "message",
                                           "suppressed"}
    assert json.loads(_norm(json.dumps(docs[0]))) == docs[1]


def test_rule_docs_cover_the_same_codes():
    assert sorted(TRULE_DOCS) == sorted(JRULE_DOCS)


@pytest.mark.parametrize("argv", [
    ["{bad}", "--format", "json"], ["{good}"], ["{bad}", "--fail-on",
                                                 "never"],
    ["{bad}", "--fail-on", "error"], ["lint", "{warn}"],
    ["{warn}", "--fail-on", "error"], ["{bad}", "--rules", "TD004"],
    ["{bad}", "--rules", "TD999"], ["--list-rules"]])
def test_cli_exit_codes_match(tmp_path, capsys, argv):
    files = {"bad": FIXTURES["TD001_POS"], "good": FIXTURES["TD001_NEG"],
             "warn": FIXTURES["TD004_POS"]}
    for name, src in files.items():
        (tmp_path / f"{name}.py").write_text(src)
    argv = [a.format(**{k: str(tmp_path / f"{k}.py") for k in files})
            for a in argv]
    rc_port = tmain(list(argv))
    out_port = capsys.readouterr()
    rc_jax = jmain(list(argv))
    out_jax = capsys.readouterr()
    assert rc_port == rc_jax
    if "--list-rules" not in argv:
        assert _norm(out_port.out) == out_jax.out
        assert _norm(out_port.err) == out_jax.err


# -- TD005 over the port's trace-once constructs ------------------------------

TD005_TORCH_POS = {
    "graph_capture": """
        import time
        import torch

        def capture(model, x, g):
            with torch.cuda.graph(g):
                t0 = time.perf_counter()
                y = model(x)
            return y, t0
    """,
    "graph_alias": """
        import random
        from torch.cuda import graph as cuda_graph

        def capture(model, x, g):
            with cuda_graph(g):
                return model(x) * random.random()
    """,
    "make_graphed_callables": """
        import torch

        def step(x, store):
            store.set("tpu_dist/g0/step", b"1")
            return x * 2

        graphed = torch.cuda.make_graphed_callables((step,), (x0,))
    """,
    "jit_trace": """
        import numpy as np
        import torch

        def fwd(x):
            return x + np.random.rand()

        traced = torch.jit.trace(fwd, (x0,))
    """,
    "jit_script_decorator": """
        import time
        import torch

        @torch.jit.script
        def fwd(x, group):
            C.all_reduce_host(x, group=group)
            return x * time.time()
    """,
}

TD005_TORCH_NEG = """
import time
import torch

def capture(model, x, g, store):
    t0 = time.perf_counter()               # before the capture: per call
    with torch.cuda.graph(g):
        y = model(x)
    store.set("tpu_dist/g0/captured", b"1")
    return y, time.perf_counter() - t0

def fwd(x):
    return x * 2

def untouched(x):
    return x + time.time()                 # never traced

with graph_lock:                           # not torch.cuda.graph
    time.sleep(0)

traced = torch.jit.trace(fwd, (x0,))
graphed = torch.cuda.make_graphed_callables(fwd, (x0,))
"""


@pytest.mark.parametrize("name", sorted(TD005_TORCH_POS))
def test_td005_port_trace_once_constructs_flag(name):
    src = textwrap.dedent(TD005_TORCH_POS[name])
    found = [f for f in tlint(src, "t.py") if f.rule == "TD005"]
    assert found and {f.severity for f in found} == {"error"}
    assert all("not on every replay" in f.message for f in found)
    # the JAX anchors alone see none of these
    assert [f for f in jlint(src, "t.py") if f.rule == "TD005"] == []


def test_td005_port_fixture_names_the_construct():
    (f,) = tlint(textwrap.dedent(TD005_TORCH_POS["graph_capture"]), "t.py")
    assert "time.perf_counter" in f.message
    assert "torch.cuda.graph capture at line" in f.message
    found = tlint(textwrap.dedent(TD005_TORCH_POS["jit_script_decorator"]),
                  "t.py")
    assert [f.rule for f in found] == ["TD005", "TD005"]
    assert all("traced by torch.jit.script()" in f.message for f in found)
    (g,) = tlint(textwrap.dedent(TD005_TORCH_POS["jit_trace"]), "t.py")
    assert "torch.Generator" in g.message


def test_td005_port_negative_passes():
    assert tlint(TD005_TORCH_NEG, "t.py") == []


def test_td005_jit_and_capture_report_a_call_once():
    src = textwrap.dedent("""
        import jax, time, torch

        @jax.jit
        def step(x):
            return x * time.time()

        traced = torch.jit.trace(step, (x0,))
    """)
    assert [f.rule for f in tlint(src, "t.py")] == ["TD005"]
