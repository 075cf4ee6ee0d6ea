"""The port's static whole-graph protocol verifier
(``tpu_dist_torch.analysis.protocol``) against the JAX package's.

Every case class of tests/test_protocol.py — deadlock cycles with witness
schedules (TD101), credit-disciplined rings, claim-safety (TD102),
restart-policy soundness (TD103), dp-path feasibility (TD104), spec
mismatches (TD105) and the graph sources — is built twice, from
``tpu_dist.roles.graph`` and from ``tpu_dist_torch.roles.graph``, and both
verifiers must give the same findings: rule, severity, message and
witness text.  The port's shipped graphs verify clean, the CLI's exit
codes match, and the port's launcher refuses an under-depth pipelined
graph with exit 2 before any rank is spawned.
"""

import dataclasses
import json
import os
import textwrap

import pytest

import tpu_dist.analysis.protocol as jproto
import tpu_dist.roles.graph as jgraph
import tpu_dist_torch.analysis.protocol as tproto
import tpu_dist_torch.roles.graph as tgraph
from tpu_dist.analysis.__main__ import main as jmain
from tpu_dist_torch.analysis.__main__ import main as tmain
from tpu_dist_torch.launch import cli as tcli

pytestmark = [pytest.mark.analysis]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring(g, act_depth, act_credits=3, grad_depth=4, grad_credits=4):
    return [g.Role("stage0", 1), g.Role("stage1", 1)], [
        g.ChannelSpec("act", src="stage0", dst="stage1", depth=act_depth,
                      credits=act_credits),
        g.ChannelSpec("grad", src="stage1", dst="stage0", depth=grad_depth,
                      credits=grad_credits)]


# name -> (builder of (roles, channels) from a roles.graph module,
#          verify_graph keyword arguments)
CASES = {
    # TestDeadlockCycles
    "two_role_cycle": (lambda g: ([g.Role("a", 1), g.Role("b", 1)], [
        g.ChannelSpec("fwd", src="a", dst="b", depth=2),
        g.ChannelSpec("bwd", src="b", dst="a", depth=3)]), {}),
    "self_loop": (lambda g: ([g.Role("a", 2)], [
        g.ChannelSpec("loop", src="a", dst="a", depth=4)]), {}),
    "latest_breaks_cycle": (lambda g: ([g.Role("a", 1), g.Role("b", 1)], [
        g.ChannelSpec("fwd", src="a", dst="b", depth=2),
        g.ChannelSpec("bwd", src="b", dst="a", kind="latest")]), {}),
    "dedicated_drain": (lambda g: ([g.Role("a", 1), g.Role("b", 1)], [
        g.ChannelSpec("fwd", src="a", dst="b", depth=2),
        g.ChannelSpec("bwd", src="b", dst="a", depth=2,
                      drain="dedicated")]), {}),
    "acyclic_chain": (lambda g: (
        [g.Role("a", 1), g.Role("b", 1), g.Role("c", 1)],
        [g.ChannelSpec("ab", src="a", dst="b", depth=2),
         g.ChannelSpec("bc", src="b", dst="c", depth=2)]), {}),
    "two_disjoint_cycles": (lambda g: (
        [g.Role(n, 1) for n in ("a", "b", "c", "d")],
        [g.ChannelSpec("ab", src="a", dst="b", depth=1),
         g.ChannelSpec("ba", src="b", dst="a", depth=1),
         g.ChannelSpec("cd", src="c", dst="d", depth=1),
         g.ChannelSpec("dc", src="d", dst="c", depth=1)]), {}),
    "three_role_cycle": (lambda g: (
        [g.Role(n, 1) for n in ("p", "q", "r")],
        [g.ChannelSpec("pq", src="p", dst="q", depth=5),
         g.ChannelSpec("qr", src="q", dst="r", depth=1),
         g.ChannelSpec("rp", src="r", dst="p", depth=2)]), {}),
    # TestCreditDiscipline
    "credit_ring_depth_eq": (lambda g: _ring(g, 3), {}),
    "credit_ring_depth_gt": (lambda g: _ring(g, 8), {}),
    "credit_ring_underdepth": (lambda g: _ring(g, 1), {}),
    "credit_ring_both_under": (lambda g: _ring(g, 1, grad_depth=2), {}),
    "partially_annotated": (lambda g: ([g.Role("a", 1), g.Role("b", 1)], [
        g.ChannelSpec("fwd", src="a", dst="b", depth=4, credits=4),
        g.ChannelSpec("bwd", src="b", dst="a", depth=4)]), {}),
    # TestClaimSafety
    "tight_multi_consumer": (lambda g: (
        [g.Role("src", 1), g.Role("pool", 4, restart="solo")],
        [g.ChannelSpec("work", src="src", dst="pool", depth=4)]), {}),
    "depth_above_consumers": (lambda g: (
        [g.Role("src", 1), g.Role("pool", 4, restart="solo")],
        [g.ChannelSpec("work", src="src", dst="pool", depth=8)]), {}),
    "gang_consumers": (lambda g: (
        [g.Role("src", 1), g.Role("pool", 4)],
        [g.ChannelSpec("work", src="src", dst="pool", depth=2)]), {}),
    "single_solo_consumer": (lambda g: (
        [g.Role("src", 1), g.Role("sink", 1, restart="solo")],
        [g.ChannelSpec("work", src="src", dst="sink", depth=1)]), {}),
    # TestRestartSoundness
    "node_pin_beyond": (lambda g: (
        [g.Role("a", 1), g.Role("b", 1, node=3)], []), {"nnodes": 2}),
    "node_pin_no_nnodes": (lambda g: (
        [g.Role("a", 1), g.Role("b", 1, node=3)], []), {}),
    "all_solo": (lambda g: (
        [g.Role("a", 1, restart="solo"), g.Role("b", 2, restart="solo")],
        []), {}),
    "solo_producers_wide": (lambda g: (
        [g.Role("actors", 4, restart="solo"), g.Role("learner", 1)],
        [g.ChannelSpec("batches", src="actors", dst="learner",
                       depth=2)]), {}),
    # TestDpPath
    "big_payload": (lambda g: ([g.Role("a", 1), g.Role("b", 2)], [
        g.ChannelSpec("big", src="a", dst="b", payload_bytes=1 << 20)]),
        {}),
    "below_threshold": (lambda g: (
        [g.Role("a", 1), g.Role("b", 2), g.Role("c", 1)],
        [g.ChannelSpec("small", src="a", dst="b", payload_bytes=1024),
         g.ChannelSpec("big1", src="a", dst="c",
                       payload_bytes=1 << 20)]), {}),
    "threshold_override_hit": (lambda g: ([g.Role("a", 1), g.Role("b", 2)], [
        g.ChannelSpec("mid", src="a", dst="b", payload_bytes=2048)]),
        {"dp_threshold": 2048}),
    "threshold_override_miss": (lambda g: (
        [g.Role("a", 1), g.Role("b", 2)],
        [g.ChannelSpec("mid", src="a", dst="b", payload_bytes=2048)]),
        {"dp_threshold": 4096}),
}


def _shape(findings):
    return [(f.rule, f.severity, f.path, f.line, f.col, f.message)
            for f in findings]


def _both(name, **extra):
    build, kw = CASES[name]
    out = []
    for g, proto in ((jgraph, jproto), (tgraph, tproto)):
        roles, chans = build(g)
        out.append(proto.verify_graph(g.RoleGraph(roles, chans),
                                      **dict(kw, **extra)))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_both_verifiers_give_the_same_findings(name):
    jf, tf = _both(name)
    assert _shape(tf) == _shape(jf)


def test_the_matrix_exercises_every_rule():
    rules = {f.rule for name in CASES for f in _both(name)[1]}
    assert rules == {"TD101", "TD102", "TD103", "TD104"}
    (f,) = _both("credit_ring_underdepth")[1]
    assert "'act'(depth 1 < credits 3)" in f.message
    assert "raise depth to at least credits" in f.message


def test_dp_threshold_env_is_read_alike(monkeypatch):
    monkeypatch.setenv("TPU_DIST_DP_THRESHOLD", "2048")
    jf, tf = _both("threshold_override_miss", dp_threshold=None)
    assert [f.rule for f in tf] == ["TD104"]
    assert _shape(tf) == _shape(jf)


def test_witnesses_render_alike():
    cycle = {}
    for name, g in (("jax", jgraph), ("port", tgraph)):
        ch1 = g.ChannelSpec("x", src="p", dst="q", depth=5, credits=7)
        ch2 = g.ChannelSpec("y", src="q", dst="p", depth=1, credits=1)
        cycle[name] = [("p", ch1), ("q", ch2)]
    assert tproto.render_witness(cycle["port"]) == \
        jproto.render_witness(cycle["jax"])
    over = {k: v[:1] for k, v in cycle.items()}
    assert tproto.render_credit_witness(cycle["port"], over["port"]) == \
        jproto.render_credit_witness(cycle["jax"], over["jax"])


# -- graph sources ------------------------------------------------------------


def _specs(specs):
    return [dataclasses.asdict(s) for s in specs]


def test_parse_channels_spec_alike():
    text = "work:a>b:4,pub:b>a:latest,big:a>b:2:payload=65536"
    assert _specs(tproto.parse_channels_spec(text)) == \
        _specs(jproto.parse_channels_spec(text))
    for bad in ("nocolonhere", "work:a>b:wat"):
        with pytest.raises(tgraph.RoleGraphError):
            tproto.parse_channels_spec(bad)


def test_extract_channel_specs_alike(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        from tpu_dist_torch.roles import ChannelSpec
        DEPTH = 4
        A = ChannelSpec("batches", src="actor", dst="learner", depth=8)
        B = ChannelSpec("weights", "learner", "actor", 1, "latest")
        C = ChannelSpec("dyn", src="actor", dst="learner", depth=DEPTH)
        D = ChannelSpec("act", src="stage0", dst="stage1", depth=4,
                        credits=4)
        E = ChannelSpec("bad", src="x", dst="y", depth=0)
    """))
    tspecs, tnotes = tproto.extract_channel_specs(str(script))
    jspecs, jnotes = jproto.extract_channel_specs(str(script))
    assert _specs(tspecs) == _specs(jspecs) and tnotes == jnotes
    assert {s.name for s in tspecs} == {"batches", "weights", "act"}
    assert len(tnotes) == 2


@pytest.mark.parametrize("kw", [
    {"roles_spec": "a:1,b:1", "channels_spec": "work:a>ghost:2"},
    {"roles_spec": "a:1,b:2:solo", "channels_spec": "x:a>b:1,y:b>a:1"},
    {"roles_spec": "stage0:1,stage1:1"}])
def test_build_graph_alike(kw):
    jg, jf, jn = jproto.build_graph(**kw)
    tg, tf, tn = tproto.build_graph(**kw)
    assert tg.to_json() == jg.to_json()
    assert _shape(tf) == _shape(jf) and tn == jn
    assert _shape(tproto.verify_graph(tg)) == \
        _shape(jproto.verify_graph(jg))


def test_build_graph_without_a_source_is_refused():
    with pytest.raises(tgraph.RoleGraphError, match="no graph source"):
        tproto.build_graph()


# -- the port's shipped graphs verify clean, as the JAX package's do ----------

SHIPPED = [
    ("examples/actor_learner.py:build_graph",
     "tpu_dist_torch/examples/actor_learner.py:build_graph", "[4]"),
    ("examples/param_server.py:build_graph",
     "tpu_dist_torch/examples/param_server.py:build_graph", "[4]"),
    ("examples/pipeline_train.py:build_graph",
     "tpu_dist_torch/examples/pipeline_train.py:build_graph", "[3]"),
    ("tpu_dist.serve.disagg:disagg_graph",
     "tpu_dist_torch.serve.disagg:disagg_graph", "[2, 2]"),
]


@pytest.mark.parametrize("jax_target,port_target,args", SHIPPED,
                         ids=["actor_learner", "param_server",
                              "pipeline_train", "serve_disagg"])
def test_shipped_graphs_verify_clean(monkeypatch, jax_target, port_target,
                                     args):
    monkeypatch.chdir(REPO)
    tg = tproto.load_graph_builder(port_target, args)
    jg = jproto.load_graph_builder(jax_target, args)
    assert tg.to_json() == jg.to_json()
    assert tproto.verify_graph(tg) == []


def test_load_graph_builder_module_target():
    g = tproto.load_graph_builder(
        "tpu_dist_torch.examples.actor_learner:build_graph", "4")
    assert {r.name for r in g.roles} == {"learner", "actor"}
    with pytest.raises(ValueError, match="file.py:func"):
        tproto.load_graph_builder("no_colon")


def test_pipeline_builder_graphs_admit_both_schedules():
    from tpu_dist_torch.pipeline import build_pipeline_graph
    for schedule in ("gpipe", "1f1b"):
        for s, m in ((2, 4), (4, 8), (3, 2)):
            g = build_pipeline_graph(s, num_microbatches=m,
                                     schedule=schedule)
            assert tproto.verify_graph(g) == [], (schedule, s, m)
    assert tproto.verify_graph(build_pipeline_graph(3, dp=2)) == []


# -- CLI: `analysis graph` exit codes and output, both packages ---------------

_DEADLOCK = textwrap.dedent("""
    from tpu_dist_torch.roles import ChannelSpec

    FWD = ChannelSpec("fwd", src="a", dst="b", depth=2)
    BWD = ChannelSpec("bwd", src="b", dst="a", depth=2)
""")


@pytest.mark.parametrize("argv", [
    ["--list-rules"],
    ["{dead}", "--roles", "a:1,b:1"],
    ["{dead}", "--roles", "a:1,b:1", "--format", "json"],
    ["{dead}", "--roles", "a:1,b:1", "--fail-on", "never"],
    ["--roles", "a:1,b:1", "--channels", "fwd:a>b:2,bwd:b>a:2"],
    ["--roles", "a:1,b:2:solo", "--channels", "w:a>b:2",
     "--fail-on", "error"],
    ["--roles", "a:1,b:1@node3", "--nnodes", "2"],
    ["--roles", "a:1,b:2", "--channels", "big:a>b:2:payload=4096",
     "--dp-threshold", "4096"],
    ["--graph", "{builder}:build_graph", "--graph-args", "[3]"],
    [],
    ["--roles", "a:1", "--channels", "bogus"]])
def test_graph_cli_alike(tmp_path, capsys, argv):
    dead = tmp_path / "dead.py"
    dead.write_text(_DEADLOCK)
    builder = tmp_path / "ring.py"
    builder.write_text(textwrap.dedent("""
        def build_graph(depth):
            from tpu_dist_torch.roles import ChannelSpec, Role, RoleGraph
            return RoleGraph([Role("a", 1), Role("b", 1)], [
                ChannelSpec("x", src="a", dst="b", depth=depth),
                ChannelSpec("y", src="b", dst="a", depth=1)])
    """))
    argv = [a.format(dead=dead, builder=builder) for a in argv]
    rc_port = tmain(["graph"] + argv)
    port = capsys.readouterr()
    rc_jax = jmain(["graph"] + argv)
    jax = capsys.readouterr()
    assert rc_port == rc_jax
    assert port.out == jax.out
    assert port.err.replace("tpu_dist_torch", "tpu_dist") == jax.err
    if "json" in argv:
        doc = json.loads(port.out)
        assert doc["tool"] == "graph" and doc["counts"]["error"] == 1


# -- the launcher's pre-flight ------------------------------------------------


def test_launcher_auto_preflight_refuses_underdepth_pipeline(
        monkeypatch, capfd):
    """The twin of tests/test_protocol.py's launcher case: a pipelined
    launch (>= 2 stageN roles) runs the pre-flight without
    ``--verify_graph``, loads the example's ``build_graph()`` by path and
    refuses the under-depth act ring with exit 2 before any rank is
    spawned."""
    import tpu_dist_torch.roles as troles
    spawned = []
    monkeypatch.setattr(troles, "spawn_graph",
                        lambda *a, **k: spawned.append(a) or 0)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("PIPELINE_STAGES", "3")
    monkeypatch.setenv("PIPELINE_ACT_DEPTH", "1")
    rc = tcli.main(["--roles", "stage0:1,stage1:1,stage2:1",
                    os.path.join(REPO, "tpu_dist_torch", "examples",
                                 "pipeline_train.py")])
    err = capfd.readouterr().err
    assert rc == 2 and not spawned, err
    assert "build_graph()" in err                 # the builder was used
    assert "credit-annotated queue cycle" in err
    assert "under-depth" in err and "witness schedule" in err
    assert "refusing to launch" in err
    # at the schedule's own depths the same launch goes to the spawner
    monkeypatch.delenv("PIPELINE_ACT_DEPTH")
    monkeypatch.setenv("PIPELINE_STAGES", "2")
    assert tcli.main(["--roles", "stage0:1,stage1:1",
                      os.path.join(REPO, "tpu_dist_torch", "examples",
                                   "pipeline_train.py")]) == 0
    assert len(spawned) == 1
    assert "--verify_graph: note: graph from" in capfd.readouterr().err


def test_launcher_module_target_checks_the_roles_spec(monkeypatch, capfd):
    """``-m pkg.mod``: as in the JAX launcher, the pre-flight checks the
    ``--roles`` spec alone, and a note names that source."""
    import tpu_dist_torch.roles as troles
    monkeypatch.setattr(troles, "spawn_graph", lambda *a, **k: 0)
    assert tcli.main(["--roles", "stage0:1,stage1:1", "-m",
                      "tpu_dist_torch.examples.pipeline_train"]) == 0
    err = capfd.readouterr().err
    assert "--verify_graph: note: graph from the --roles spec\n" in err
    assert "without the verifier" not in err


@pytest.mark.multiprocess
def test_launcher_verify_graph_refuses_deadlock_as_a_process(tmp_path):
    """Through ``python -m tpu_dist_torch.launch``: the refusal comes
    before any spawn (the script would write its argument if run)."""
    import subprocess
    import sys
    script = tmp_path / "dead.py"
    script.write_text(_DEADLOCK + textwrap.dedent("""
        if __name__ == "__main__":
            import sys
            open(sys.argv[1], "w").close()
    """))
    marker = tmp_path / "ran"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "tpu_dist_torch.launch",
                        "--roles", "a:1,b:1", "--verify_graph", str(script),
                        str(marker)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "TD101" in r.stderr and "witness schedule" in r.stderr
    assert "refusing to launch" in r.stderr
    assert not marker.exists()
