"""The port's launcher (``python -m tpu_dist_torch.launch``) against the JAX
package's (``python -m tpu_dist.launch``): the same argv and the same
worker give the same env contract (ports aside) and the same exit codes —
the env contract itself, ``--pass_local_rank``, fail-fast, the refused
flag combinations, ``--max_restarts`` recovered and exhausted, a worker's
130, ``--standalone`` and ``--module``, the control plane's flags
(``--sanitize``, ``--flight-recorder``, ``--roles``, ``--role_script``,
``--solo_restarts``, ``--store_endpoints``, ``--store_replica``,
``--netchaos``) — and two of the port's launchers with ``--nnodes=2``
agree on a restart, or on giving up.  Flags whose machinery is a later
ROADMAP item exit 2 before anything is spawned, naming the item;
``spawn(max_restarts=)`` restarts its world.

The worker uses the standard library only: it writes its env, argv and
exit code to a JSON file per rank and generation.  Every launch and every
subprocess has a timeout of its own."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from tpu_dist.launch import cli as jcli
from tpu_dist_torch.launch import cli as tcli

pytestmark = pytest.mark.multiprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
            "NODE_RANK", "MASTER_ADDR", "MASTER_PORT",
            "TPU_DIST_RESTART_COUNT", "TPU_DIST_STORE_ADDR",
            "TPU_DIST_HEARTBEAT_TIMEOUT")
PORTS = ("MASTER_PORT", "TPU_DIST_STORE_ADDR")

# argv: OUT_DIR MODE [rest...]; MODE picks the exit code
WORKER = textwrap.dedent("""
    import json, os, sys, time
    out, mode = sys.argv[1], sys.argv[2]
    gen = os.environ.get("TPU_DIST_RESTART_COUNT", "-")
    rank = os.environ.get("RANK", "-")
    rc = {"ok": 0, "always": 9}.get(mode, 0)
    if mode == "flaky" and gen == "0":
        rc = 7
    if mode == "sigint" and gen == "0":
        rc = 130
    rec = {"env": {k: os.environ.get(k) for k in %r},
           "argv": sys.argv[3:], "rc": rc}
    with open(os.path.join(out, f"g{gen}_r{rank}.json"), "w") as f:
        json.dump(rec, f)
    if mode == "failfast" and rank != "0":
        time.sleep(30)       # must be torn down, not waited out
        rc = 0
    if mode == "failfast" and rank == "0":
        rc = 7
    if rc:
        # fail only once every rank of this node and generation wrote its
        # record: the teardown that follows must not race a sibling's start
        n = int(os.environ["LOCAL_WORLD_SIZE"])
        for _ in range(600):
            if sum(name.startswith(f"g{gen}_") for name in
                   os.listdir(out)) >= n:
                break
            time.sleep(0.05)
    sys.exit(rc)
""" % (CONTRACT,))


@pytest.fixture
def worker(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text(WORKER)
    return path


def _records(out_dir):
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            for k in PORTS:
                v = rec["env"][k]
                if v is not None:
                    rec["env"][k] = v.rsplit(":", 1)[0] + ":<port>" \
                        if ":" in v else "<port>"
            recs[name] = rec
    return recs


def _both(tmp_path, worker, argv, mode="ok", extra=()):
    """Run the JAX launcher then the port's in this process on the same
    argv and worker → ``[(rc, records, seconds)]`` for each."""
    out = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = tmp_path / name
        d.mkdir()
        t0 = time.monotonic()
        rc = cli.main([*argv, str(worker), str(d), mode, *extra])
        out.append((rc, _records(d), time.monotonic() - t0))
    return out


@pytest.mark.parametrize("argv,mode,extra,want_rc", [
    (["--nproc_per_node=2", "--nnodes=2", "--node_rank=1",
      "--master_addr=10.1.2.3", "--master_port=12345"], "ok", ["-x", "1"],
     0),
    (["--nproc_per_node=2", "--pass_local_rank", "--heartbeat_timeout=30"],
     "ok", [], 0),
    (["--nproc_per_node=2"], "failfast", [], 7),
    (["--nproc_per_node=2", "--max_restarts=1", "--restart_backoff=0.05"],
     "flaky", [], 0),
    (["--nproc_per_node=1", "--max_restarts=2", "--restart_backoff=0.05"],
     "always", [], 9),
    (["--nproc_per_node=1", "--max_restarts=1", "--no_store",
      "--restart_backoff=0.05"], "sigint", [], 0),
], ids=["contract", "local_rank", "failfast", "restart-recovered",
        "restart-exhausted", "rc130-restarted"])
def test_same_contract_and_exit_code_as_the_jax_launcher(
        tmp_path, worker, argv, mode, extra, want_rc):
    (jrc, jrec, _), (trc, trec, tsec) = _both(tmp_path, worker, argv, mode,
                                              extra)
    assert trc == jrc == want_rc
    assert trec == jrec and trec
    if mode == "failfast":
        assert tsec < 25   # the sleeping rank was torn down
    if mode == "flaky":
        assert {r["env"]["TPU_DIST_RESTART_COUNT"] for r in trec.values()} \
            == {"0", "1"}


@pytest.mark.parametrize("argv", [
    ["--nnodes=2", "--node_rank=2"],
    ["--max_restarts=-1"],
    ["--master_port=0", "--no_store"],
    ["--nnodes=2", "--max_restarts=1", "--no_store"],
    ["--serve", "--no_store"],
], ids=["node_rank", "negative-restarts", "negotiation-without-store",
        "multinode-restarts-without-store", "serve-without-store"])
def test_bad_flags_exit_2_like_the_jax_launcher(tmp_path, worker, argv):
    (jrc, jrec, _), (trc, trec, _) = _both(tmp_path, worker, argv)
    assert trc == jrc == 2
    assert trec == jrec == {}


def test_coll_timeout_reaches_the_child_as_under_the_jax_launcher(tmp_path):
    # --coll_timeout left the refused flags with the host data plane: both
    # launchers export it to the child as TPU_DIST_COLL_TIMEOUT
    probe = tmp_path / "coll.py"
    probe.write_text(textwrap.dedent("""
        import os, sys
        with open(sys.argv[1], "w") as f:
            f.write(os.environ.get("TPU_DIST_COLL_TIMEOUT", "<unset>"))
    """))
    seen = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.txt"
        assert cli.main(["--nproc_per_node=1", "--coll_timeout=5",
                         str(probe), str(out)]) == 0
        seen[name] = out.read_text()
    assert seen["port"] == seen["jax"] == "5.0"


_DEADLOCK = textwrap.dedent("""
    from tpu_dist_torch.roles import ChannelSpec

    FWD = ChannelSpec("fwd", src="{a}", dst="{b}", depth=2)
    BWD = ChannelSpec("bwd", src="{b}", dst="{a}", depth=2)
""")


@pytest.mark.parametrize("flag,item", [
    ("--verify_graph", "TD101"), ("--no_verify_graph", "TD101")])
def test_unported_flag_exits_2_naming_its_item(tmp_path, capfd, monkeypatch,
                                               flag, item):
    """The verifier's flags, ported: a graph whose script declares a
    deadlocking queue cycle is refused with exit 2 naming the finding
    (``item``) before anything is spawned, by both launchers.
    ``--verify_graph`` asks for the pre-flight on any graph; a pipelined
    graph (``stageN`` roles) gets it unasked, and ``--no_verify_graph``
    skips that automatic pre-flight (the graph goes to the spawner)."""
    import tpu_dist.roles as jroles
    import tpu_dist_torch.roles as troles
    spawned = []
    for mod in (jroles, troles):
        monkeypatch.setattr(mod, "spawn_graph",
                            lambda graph, *a, **k: spawned.append(graph)
                            or 0)
    a, b = ("a", "b") if flag == "--verify_graph" else ("stage0", "stage1")
    script = tmp_path / "dead.py"
    script.write_text(_DEADLOCK.format(a=a, b=b))
    roles = ["--roles", f"{a}:1,{b}:1"]
    argv = roles + ([flag] if flag == "--verify_graph" else []) + [
        str(script)]
    errs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main(argv) == 2
        errs[name] = capfd.readouterr().err
    assert not spawned                       # nothing was spawned
    for err in errs.values():
        assert item in err and "witness schedule" in err
        assert "--verify_graph: refusing to launch" in err
    assert "python -m tpu_dist_torch.analysis graph" in errs["port"]
    if flag == "--no_verify_graph":
        for cli in (jcli, tcli):
            assert cli.main(roles + [flag, str(script)]) == 0
            assert "--verify_graph" not in capfd.readouterr().err
        assert len(spawned) == 2


@pytest.mark.parametrize("flags", [
    "--store_replica", "--store_endpoints=EP --no_store",
    "--nnodes=2 --elastic_world=1:3", "--nnodes=2 --elastic_world=1:2 "
    "--no_store", "--nnodes=2 --node_rank=0 --elastic_world=0:2"])
def test_cluster_flag_misuse_exits_2_like_jax(tmp_path, worker, capfd,
                                              flags):
    """The cluster flags' refusals: --store_replica without an endpoints
    file, either flag without the store, a multi-node --elastic_world MAX
    other than the full world: both launchers exit 2 with the same
    message and spawn nothing."""
    argv = flags.replace("EP", str(tmp_path / "ep.json")).split()
    errs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main([*argv, str(worker), str(tmp_path), "ok"]) == 2
        errs[name] = capfd.readouterr().err
    assert errs["port"] == errs["jax"] and errs["port"]
    assert os.listdir(tmp_path) == ["probe.py"]


# argv: OUT; the child's view of the cluster flags
CLUSTER_ENV = ("TPU_DIST_STORE_ENDPOINTS", "TPU_DIST_STORE_REPLICATE",
               "TPU_DIST_NETCHAOS")
CLUSTER_PROBE = textwrap.dedent("""
    import json, os, sys
    from tpu_dist_torch.dist import TCPStore
    rec = {k: os.environ.get(k) for k in %r}
    host, _, port = os.environ["TPU_DIST_STORE_ADDR"].rpartition(":")
    s = TCPStore(host, int(port), timeout=30)
    rec["store_addr"] = os.environ["TPU_DIST_STORE_ADDR"]
    rec["native"] = s.native
    rec["master_port_published"] = s.check("tpu_dist/master_port")
    s.close()
    with open(sys.argv[1], "w") as f:
        json.dump(rec, f)
""" % (CLUSTER_ENV,))


@pytest.mark.parametrize("mode", ["endpoints", "replica", "netchaos"])
def test_cluster_flags_launch_like_jax(tmp_path, monkeypatch, mode):
    """``--store_endpoints`` (client of an external leader named by the
    file), ``--store_replica`` (node 0 hosts the replicating store and
    writes the file at epoch 0) and ``--netchaos`` (exported to every
    worker): the child of either launcher sees the same."""
    from tpu_dist_torch.cluster import read_endpoints, write_endpoints
    from tpu_dist_torch.dist.store import PyTCPStoreServer
    probe = tmp_path / "cluster.py"
    probe.write_text(CLUSTER_PROBE)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    for var in ("TPU_DIST_STORE_ENDPOINTS", "TPU_DIST_STORE_REPLICATE"):
        monkeypatch.setenv(var, "x")   # the launcher sets them in-process:
        monkeypatch.delenv(var)        # undone after the test
    seen = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        ep = tmp_path / f"{name}_ep.json"
        srv = None
        argv = []
        if mode == "endpoints":
            srv = PyTCPStoreServer(0, replicate=True)
            write_endpoints(str(ep), f"127.0.0.1:{srv.port}", 0)
            argv = [f"--store_endpoints={ep}"]
        elif mode == "replica":
            argv = [f"--store_endpoints={ep}", "--store_replica"]
        else:
            argv = ["--netchaos=delay:surface=tcp,delay=0.01"]
        out = tmp_path / f"{name}.json"
        try:
            assert cli.main(argv + [str(probe), str(out)]) == 0
        finally:
            if srv is not None:
                srv.stop()
        rec = json.loads(out.read_text())
        if mode != "netchaos":
            doc = read_endpoints(str(ep))
            assert doc["epoch"] == 0 and rec["store_addr"] == doc["leader"]
            assert rec["TPU_DIST_STORE_ENDPOINTS"] == str(ep)
            assert rec["native"] is False      # the Python wire
            rec["TPU_DIST_STORE_ENDPOINTS"] = "EP"
        assert rec["master_port_published"]
        rec.pop("store_addr")
        seen[name] = rec
        for var in ("TPU_DIST_STORE_ENDPOINTS", "TPU_DIST_STORE_REPLICATE"):
            os.environ.pop(var, None)
    assert seen["port"] == seen["jax"]
    if mode == "replica":
        assert seen["port"]["TPU_DIST_STORE_REPLICATE"] == "1"
    if mode == "netchaos":
        assert seen["port"]["TPU_DIST_NETCHAOS"] == \
            "delay:surface=tcp,delay=0.01"


# what a child of either launcher sees of the control plane's flags
CTRL_ENV = ("RANK", "WORLD_SIZE", "TPU_DIST_SANITIZE", "TPU_DIST_OBS",
            "TPU_DIST_OBS_DIR", "TPU_DIST_ROLES", "TPU_DIST_ROLE",
            "TPU_DIST_ROLE_RANK", "TPU_DIST_ROLE_WORLD",
            "TPU_DIST_ROLE_INCARNATION", "TPU_DIST_RESTART_COUNT")
# argv: OUT; a first incarnation under TPU_DIST_PROBE_DIE exits 3 (the solo
# respawn's incarnation 1 then writes the record)
CTRL_PROBE = textwrap.dedent("""
    import json, os, sys
    if (os.environ.get("TPU_DIST_PROBE_DIE")
            and os.environ.get("TPU_DIST_ROLE_INCARNATION") == "0"):
        sys.exit(3)
    with open(sys.argv[1], "w") as f:
        json.dump({k: os.environ.get(k) for k in %r}, f)
""" % (CTRL_ENV,))


@pytest.mark.parametrize("flags", [
    ["--sanitize"], ["--flight-recorder"], ["--roles=learner:1"],
    ["--roles=learner:1", "--role_script=learner={probe}"],
    ["--roles=learner:1:solo", "--solo_restarts=1"]],
    ids=["sanitize", "flight-recorder", "roles", "role_script",
         "solo_restarts"])
def test_control_plane_flag_launches(tmp_path, monkeypatch, flags):
    """The flags that came with the control plane launch, and the child
    sees under the port's launcher what it sees under the JAX one."""
    probe = tmp_path / "ctrl.py"
    probe.write_text(CTRL_PROBE)
    monkeypatch.setenv("TPU_DIST_OBS_DIR", str(tmp_path / "obs"))
    if "--solo_restarts=1" in flags:
        monkeypatch.setenv("TPU_DIST_PROBE_DIE", "1")
    seen = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.json"
        argv = [f.format(probe=probe) for f in flags]
        assert cli.main(argv + [str(probe), str(out)]) == 0
        seen[name] = json.loads(out.read_text())
    assert seen["port"] == seen["jax"]
    env = seen["port"]
    if "--sanitize" in flags:
        assert env["TPU_DIST_SANITIZE"] == "1"
    if "--flight-recorder" in flags:
        assert env["TPU_DIST_OBS"] == "1"
        assert env["TPU_DIST_OBS_DIR"] == str(tmp_path / "obs")
    if flags[0].startswith("--roles"):
        assert env["TPU_DIST_ROLE"] == "learner"
        assert env["TPU_DIST_ROLES"] == flags[0].split("=")[1]
        assert env["TPU_DIST_ROLE_RANK"] == "0"
        assert env["TPU_DIST_ROLE_INCARNATION"] == (
            "1" if "--solo_restarts=1" in flags else "0")


def test_flight_recorder_env_refused(tmp_path, monkeypatch):
    """An armed run (``TPU_DIST_OBS=1`` in the launcher's env, which it
    once refused) leaves the worker's dump, which the trace tools read."""
    probe = tmp_path / "armed.py"
    probe.write_text(textwrap.dedent("""
        from tpu_dist_torch.obs import hooks
        rec = hooks.install_from_env()
        rec.record("user", "probe", step=1)
    """))
    monkeypatch.setenv("TPU_DIST_OBS", "1")
    monkeypatch.setenv("TPU_DIST_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    assert tcli.main([str(probe)]) == 0
    from tpu_dist_torch.obs import trace
    dumps = trace.read_dumps(str(tmp_path / "obs"))
    assert [d["rank"] for d in dumps] == [0]
    assert dumps[0]["reason"] == "exit"
    assert [e["op"] for e in dumps[0]["events"]] == ["probe"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("how", ["standalone", "module"])
def test_cli_entry_points_match(tmp_path, worker, how):
    """``python -m <pkg>.run --standalone`` and ``python -m <pkg>.launch
    --module``, each package's, as real subprocesses."""
    (tmp_path / "mods").mkdir()
    (tmp_path / "mods" / "probe_mod.py").write_text(WORKER)
    env = _env()
    env["PYTHONPATH"] = str(tmp_path / "mods") + os.pathsep + \
        env["PYTHONPATH"]
    recs = []
    for pkg in ("tpu_dist", "tpu_dist_torch"):
        d = tmp_path / pkg
        d.mkdir()
        if how == "standalone":
            argv = ["-m", f"{pkg}.run", "--standalone", "--nproc_per_node=2",
                    str(worker)]
        else:
            argv = ["-m", f"{pkg}.launch", "--nproc_per_node=2", "--module",
                    "probe_mod"]
        r = subprocess.run([sys.executable, *argv, str(d), "ok"], env=env,
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        recs.append(_records(d))
    assert recs[0] == recs[1] and len(recs[1]) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TWO_NODE_WORKER = textwrap.dedent("""
    import os, sys, time
    out, mode = sys.argv[1], sys.argv[2]
    rnd, rank = os.environ["TPU_DIST_RESTART_COUNT"], os.environ["RANK"]
    open(os.path.join(out, f"round{rnd}_rank{rank}"), "w").close()
    if rank == "1" and (mode == "always" or rnd == "0"):
        # node 1's worker fails, once node 0's has started this round
        for _ in range(600):
            if os.path.exists(os.path.join(out, f"round{rnd}_rank0")):
                break
            time.sleep(0.05)
        sys.exit(3)
    time.sleep(1.5)       # node 0's worker outlives the failure: it must be
                          # stopped by the remote-failure poll
""")


@pytest.mark.parametrize("mode", ["flaky", "always"])
def test_two_launchers_agree_on_a_restart(tmp_path, mode):
    """--nnodes=2 on localhost: node 1's worker fails in round 0; both
    launchers agree through the store and relaunch (``flaky``), or agree
    that the budget is spent and both exit non-zero (``always``)."""
    script = tmp_path / "w.py"
    script.write_text(TWO_NODE_WORKER)
    store_port, master_port = _free_port(), _free_port()

    def launcher(node_rank):
        return subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.launch",
             "--nproc_per_node=1", "--nnodes=2", f"--node_rank={node_rank}",
             "--master_addr=127.0.0.1", f"--master_port={master_port}",
             f"--store_port={store_port}", "--max_restarts=1",
             "--restart_backoff=0.1", str(script), str(tmp_path), mode],
            env=_env(), stderr=subprocess.PIPE, text=True)

    l0 = launcher(0)
    time.sleep(0.5)  # node 0 hosts the store
    l1 = launcher(1)
    try:
        err0 = l0.communicate(timeout=120)[1]
        err1 = l1.communicate(timeout=120)[1]
    finally:
        for p in (l0, l1):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "agreed restart 1/1" in err0 + err1, (err0, err1)
    assert "agreement failed" not in err0 + err1, (err0, err1)
    for rnd in (0, 1):
        for rank in (0, 1):
            assert (tmp_path / f"round{rnd}_rank{rank}").exists()
    if mode == "flaky":
        assert l0.returncode == 0 and l1.returncode == 0, (err0, err1)
    else:
        assert l0.returncode != 0 and l1.returncode != 0, (err0, err1)
