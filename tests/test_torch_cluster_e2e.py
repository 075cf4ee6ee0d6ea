"""The port's cluster control plane end to end, the two runs of
tests/test_cluster_e2e.py at the port's CPU scale: real OS processes, gloo,
the ``elastic_train`` twin with ``--device cpu``.

1. **The store leader SIGKILLed mid-training**: two
   ``python -m tpu_dist_torch.cluster.agent`` processes host the
   replicated store (node 0 leads, node 1 follows); the launcher runs in
   ``--store_endpoints`` client mode with ``--heartbeat_timeout``, so the
   workers' heartbeats and the launcher's watchdog make store requests
   across the kill.  Node 1's agent wins the election, the endpoints file
   moves to epoch 1, every client re-resolves, and the run ends in
   generation 0 with the losses and parameters of an unkilled run.
2. **Two launchers, 2 → 1 → 2 across the node boundary**
   (``benchmarks/cluster_elastic.py``): one rank a node, ``--store_replica
   --elastic_world=1:2 --zero``; chaos preempts node 1's rank at step 20
   (node 1 idles at zero ranks) and grows the world back at step 35.  Each
   destination-world phase equals, bit for bit, a single-launcher run at
   that world resumed from a copy of the same checkpoint tree.

Every process has a timeout and is killed at the end."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

pytestmark = [pytest.mark.cluster, pytest.mark.chaos,
              pytest.mark.multiprocess]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 240


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR", "TPU_DIST_CHAOS",
                "TPU_DIST_RESTART_COUNT", "TPU_DIST_STORE_ENDPOINTS",
                "TPU_DIST_STORE_REPLICATE"):
        env.pop(var, None)
    # the JAX e2e's fast failover: leases every 0.2 s, the leader condemned
    # after 1 s of dead probes, the follower tailing at 20 ms
    env.update({"TPU_DIST_CLUSTER_LEASE_INTERVAL": "0.2",
                "TPU_DIST_CLUSTER_LEASE_TTL": "1.0",
                "TPU_DIST_STORE_REPL_POLL": "0.02",
                "TPU_DIST_STORE_DOWN_AFTER": "1.0"})
    env.update(extra or {})
    return env


def _spawn_agent(node_id, ep, ready, lead=False):
    cmd = [sys.executable, "-m", "tpu_dist_torch.cluster.agent",
           "--node_id", str(node_id), "--endpoints", str(ep),
           "--ready_file", str(ready)] + (["--lead"] if lead else [])
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    deadline = time.monotonic() + 60
    while not os.path.exists(ready):
        assert proc.poll() is None, f"agent {node_id} died before ready"
        assert time.monotonic() < deadline, f"agent {node_id} never ready"
        time.sleep(0.05)
    with open(ready) as f:
        return proc, json.load(f)


def _twin(launcher_args, twin_args, cwd, env):
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", *launcher_args,
         "-m", "tpu_dist_torch.examples.elastic_train", "--device", "cpu",
         "--synthetic", *twin_args], cwd=str(cwd), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _records(path):
    try:
        with open(path) as f:
            return [json.loads(line) for line in f]
    except OSError:
        return []


def _losses(recs):
    return {(r["rank"], r["step"]): r["loss"] for r in recs if "step" in r}


def _kill_all(procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.communicate(timeout=30)


def test_store_leader_sigkill_training_rides_failover(tmp_path):
    ep = tmp_path / "ep.json"
    leader, _ = _spawn_agent(0, ep, tmp_path / "r0.json", lead=True)
    follower, foll = _spawn_agent(1, ep, tmp_path / "r1.json")
    # every gradient leaf on the data plane, no checkpoint mid-run: no
    # at-most-once store op of the training path lands in the election
    env = _env({"TPU_DIST_DP_THRESHOLD": "0"})
    twin = ["--max-steps", "80", "--save-every", "1000"]
    killed = plain = None
    try:
        killed = _twin(["--nproc_per_node=2", "--master_port=0",
                        "--max_restarts=1", "--restart_backoff=0.1",
                        "--heartbeat_timeout=10", f"--store_endpoints={ep}"],
                       twin + ["--record", "killed.jsonl", "--ckpt-root",
                               "ck_killed"], tmp_path, env)
        plain = _twin(["--standalone", "--nproc_per_node=2"],
                      twin + ["--record", "plain.jsonl", "--ckpt-root",
                              "ck_plain"], tmp_path, env)
        deadline = time.monotonic() + RUN_TIMEOUT
        while not any(k == (0, 8) for k in
                      _losses(_records(tmp_path / "killed.jsonl"))):
            assert killed.poll() is None and leader.poll() is None, \
                killed.communicate(timeout=30)
            assert time.monotonic() < deadline, "step 8 never came"
            time.sleep(0.05)
        leader.send_signal(signal.SIGKILL)     # mid-run
        t_kill = time.time()
        _, err = killed.communicate(timeout=RUN_TIMEOUT)
        _, perr = plain.communicate(timeout=RUN_TIMEOUT)
        assert killed.returncode == 0, err[-4000:]
        assert plain.returncode == 0, perr[-4000:]
        # the failover rode outside the restart budget, and clients rode it
        assert "relaunching" not in err, err[-4000:]
        assert "store-failover old=" in err, err[-4000:]
        recs = _records(tmp_path / "killed.jsonl")
        assert {r["gen"] for r in recs} == {0}
        after = [r for r in recs if "step" in r and r["t"] > t_kill + 1.0]
        assert after, "no step ran after the election"
        got, want = _losses(recs), _losses(_records(tmp_path / "plain.jsonl"))
        assert set(got) == {(r, s) for r in (0, 1) for s in range(80)}
        assert got == want
        finals = {r["final"] for r in recs + _records(tmp_path / "plain.jsonl")
                  if "final" in r}
        assert len(finals) == 1
        published = json.loads(ep.read_text())
        assert published["epoch"] == 1, published
        assert published["leader"] == f"127.0.0.1:{foll['port']}"
        follower.send_signal(signal.SIGTERM)
        out = follower.communicate(timeout=30)[0]
        assert "store-failover-promoted" in out, out
    finally:
        _kill_all([killed, plain, leader, follower])


@pytest.mark.zero
@pytest.mark.elastic
def test_two_launchers_2_1_2_across_node_boundary():
    """``benchmarks/cluster_elastic.py`` at world 2 on the CPU: two
    launchers (``--nnodes=2``, one rank each, ``--store_replica
    --elastic_world=1:2``, the twin with ``--zero --exit-on-preempt``),
    node 1's rank preempted at step 20 (node 1 idles at zero ranks) and a
    grow at step 35; both re-forms cluster decisions with JAX's plans,
    outside the restart budget, and each destination world's phase bit
    for bit a single launcher's resumed from a copy of the same tree."""
    from tpu_dist_torch.benchmarks import cluster_elastic
    row = cluster_elastic.run(world=2, device="cpu")
    assert row["ok"], row
    assert row["plans_acted"] == [{"0": [0, 1], "1": [1, 0]},
                                  {"0": [0, 1], "1": [1, 1]}]
