"""The port's launcher with its control-plane store, driving port workers
over gloo on the CPU — the counterpart of ``tests/test_launch_store.py``:
``--master_port=0`` negotiation through the native and the Python store, a
fixed port that still uses the store, ``--no_store``, ``--pass_local_rank``,
the liveness report and the pre-flight naming the missing ranks; then the
heartbeat watchdog, the SIGKILL that follows the SIGTERM a rank blocked in
a collective cannot act on, and the two packages' launchers and workers
crossed: the JAX launcher starts port workers over gloo, and the port's
launcher starts JAX workers on the CPU.  Every subprocess has a timeout of
its own."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from tpu_dist_torch.dist.store import TCPStore
from tpu_dist_torch.launch import cli as tcli

pytestmark = pytest.mark.multiprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# env:// on gloo, one all_reduce, a sub-group, the barriers, a clean
# teardown (the store's teardown barrier); argv: OUT_DIR [--local_rank=n]
PORT_WORKER = textwrap.dedent("""
    import importlib, json, os, sys, time
    import torch
    import tpu_dist_torch.dist as dist
    rdzv = importlib.import_module("tpu_dist_torch.dist.rendezvous")
    if os.environ.get("SLOW_RANK") == os.environ["RANK"]:
        time.sleep(float(os.environ["SLOW_SECONDS"]))
    pg = dist.init_process_group(init_method="env://", device="cpu")
    rank = dist.get_rank()
    t = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(t)
    dist.barrier()
    dist.monitored_barrier(timeout=60)
    out = {"rank": rank, "master_port": int(os.environ["MASTER_PORT"]),
           "store_connected": rdzv.get_store() is not None,
           "native": getattr(rdzv.get_store(), "native", None),
           "local_rank_argv": [a for a in sys.argv
                               if a.startswith("--local_rank")],
           "allreduce": t.item(), "backend": dist.get_backend()}
    with open(os.path.join(sys.argv[1], f"result{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _launch(tmp_path, args, env=None, pkg="tpu_dist_torch",
            worker=PORT_WORKER, nproc=2, timeout=180):
    script = tmp_path / "worker.py"
    script.write_text(worker)
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch", f"--nproc_per_node={nproc}",
         *args, str(script), str(tmp_path)],
        cwd=REPO, env=env or _env(), capture_output=True, text=True,
        timeout=timeout)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _results(tmp_path, nproc=2):
    out = {}
    for rank in range(nproc):
        with open(tmp_path / f"result{rank}.json") as f:
            out[rank] = json.load(f)
    return out


# rank 0 holds MASTER_PORT's port before it joins: the state of a port
# that another socket of the host took between the launcher's pick (or the
# user's) and rank 0's bind (seen as EADDRINUSE under load)
TAKEN_PORT_WORKER = textwrap.dedent("""
    import json, os, socket, sys
    import torch
    import tpu_dist_torch.dist as dist
    taken = None
    if os.environ["RANK"] == "0":
        taken = socket.socket()
        taken.bind(("", int(os.environ["MASTER_PORT"])))
        taken.listen()
    dist.init_process_group(init_method="env://", device="cpu")
    t = torch.tensor([1.0])
    torch.distributed.all_reduce(t)
    with open(os.path.join(sys.argv[1], f"result{dist.get_rank()}.json"),
              "w") as f:
        json.dump({"allreduce": t.item()}, f)
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("port,nproc", [("negotiated", 2), ("fixed", 2),
                                        ("negotiated", 1)],
                         ids=["negotiated", "fixed", "world1"])
def test_master_port_taken_before_the_bind(tmp_path, port, nproc):
    """A launch does not depend on its MASTER_PORT staying free until rank
    0 binds it, whether the launcher negotiated the port or the user fixed
    it: rank 0 binds torch's store on a port the OS picks and publishes it
    through the control-plane store (a world of one publishes nothing)."""
    master = 0 if port == "negotiated" else _free_port()
    r = _launch(tmp_path, [f"--master_port={master}"],
                worker=TAKEN_PORT_WORKER, nproc=nproc)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    res = _results(tmp_path, nproc)
    assert all(res[k] == {"allreduce": float(nproc)} for k in res), res


@pytest.mark.parametrize("pure_python", [False, True],
                         ids=["native-store", "python-store"])
def test_master_port_negotiation_through_store(tmp_path, pure_python):
    env = _env(TPU_DIST_PURE_PYTHON_STORE="1") if pure_python else None
    r = _launch(tmp_path, ["--master_port=0"], env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    res = _results(tmp_path)
    ports = {res[k]["master_port"] for k in res}
    assert len(ports) == 1 and ports.pop() > 0
    for k in res:
        assert res[k]["store_connected"] and res[k]["allreduce"] == 3.0
        assert res[k]["native"] is (not pure_python)
        assert res[k]["backend"] == "gloo"


def test_fixed_port_uses_store_and_passes_local_rank(tmp_path):
    port = _free_port()
    r = _launch(tmp_path, [f"--master_port={port}", "--pass_local_rank"])
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    res = _results(tmp_path)
    for rank in res:
        assert res[rank]["store_connected"]
        assert res[rank]["master_port"] == port
        assert res[rank]["local_rank_argv"] == [f"--local_rank={rank}"]


def test_no_store_opt_out(tmp_path):
    # monitored_barrier needs the store: this worker skips it
    worker = PORT_WORKER.replace("dist.monitored_barrier(timeout=60)", "")
    r = _launch(tmp_path, [f"--master_port={_free_port()}", "--no_store"],
                worker=worker)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    res = _results(tmp_path)
    assert not any(res[k]["store_connected"] for k in res)


def test_liveness_report_names_the_late_rank(tmp_path):
    # rank 0 may still be importing torch at the report on a loaded host,
    # so it may be named too; rank 1, asleep for 6 s, must be
    r = _launch(tmp_path, ["--master_port=0", "--liveness_warn=3"],
                _env(SLOW_RANK="1", SLOW_SECONDS="6"))
    assert r.returncode == 0, r.stderr
    assert re.search(r"after 3s ranks \[(0, )?1\] have not reached "
                     r"rendezvous", r.stderr), r.stderr


def test_preflight_names_missing_ranks(tmp_path):
    """WORLD_SIZE says 2 but only rank 0 exists: the pre-flight fails
    naming rank 1 instead of hanging in torch's rendezvous."""
    server = TCPStore(is_master=True, timeout=10)
    try:
        script = tmp_path / "worker.py"
        script.write_text(PORT_WORKER)
        r = subprocess.run(
            [sys.executable, str(script), str(tmp_path)], cwd=REPO,
            env=_env(RANK="0", LOCAL_RANK="0", WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1",
                     TPU_DIST_STORE_ADDR=f"127.0.0.1:{server.port}",
                     TPU_DIST_PREFLIGHT_TIMEOUT="3"),
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "missing ranks: [1]" in r.stderr
        assert server.check("tpu_dist/alive/0")
    finally:
        server.close()


def test_generation_fence_refuses_a_stale_rank(tmp_path):
    server = TCPStore(is_master=True, timeout=10)
    try:
        server.set("tpu_dist/generation", "2")
        script = tmp_path / "worker.py"
        script.write_text(PORT_WORKER)
        r = subprocess.run(
            [sys.executable, str(script), str(tmp_path)], cwd=REPO,
            env=_env(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1", TPU_DIST_RESTART_COUNT="1",
                     TPU_DIST_STORE_ADDR=f"127.0.0.1:{server.port}"),
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "fenced out" in r.stderr and "generation 2" in r.stderr
        assert not server.check("tpu_dist/alive/0")
    finally:
        server.close()


HUNG_WORKER = textwrap.dedent("""
    import os, sys, time
    from tpu_dist_torch.resilience import Heartbeat
    hb = Heartbeat().start()
    hb.set_step(1)
    if os.environ["TPU_DIST_RESTART_COUNT"] == "0":
        hb.stop(final=False)   # silent but alive: a wedged rank
        time.sleep(120)
    hb.stop()
""")


def test_heartbeat_watchdog_restarts_a_silent_rank(tmp_path):
    t0 = time.monotonic()
    # the startup grace (max of the timeout and --liveness_warn, 60 s)
    # covers a worker still importing torch on a loaded host; once beating,
    # 2 s of silence is a loss
    r = _launch(tmp_path, ["--heartbeat_timeout=2", "--max_restarts=1",
                           "--restart_backoff=0.1"],
                worker=HUNG_WORKER, nproc=1)
    assert r.returncode == 0, r.stderr
    assert "RankLostError: rank 0 lost: heartbeat silent" in r.stderr
    assert "restart 1/1" in r.stderr
    assert time.monotonic() - t0 < 60


BLOCKED_WORKER = textwrap.dedent("""
    import os, signal, sys, time
    import torch
    import tpu_dist_torch.dist as dist
    pg = dist.init_process_group(init_method="env://", device="cpu")
    pair = torch.distributed.new_group([0, 1])
    rank = dist.get_rank()
    if rank == 2:
        # the failure that tears the round down, once rank 0 is blocked
        marker = os.path.join(sys.argv[1], "blocked.pid")
        for _ in range(600):
            if os.path.exists(marker):
                break
            time.sleep(0.05)
        time.sleep(0.5)
        os._exit(5)
    if rank == 1:
        # alive, deaf to SIGTERM, and never joins rank 0's all_reduce
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        time.sleep(120)
    # a TERM handler that only sets a flag, as GracefulShutdown's does: it
    # cannot run while the all_reduce below blocks in C++
    signal.signal(signal.SIGTERM, lambda *_: None)
    with open(os.path.join(sys.argv[1], "blocked.pid"), "w") as f:
        f.write(str(os.getpid()))
    torch.distributed.all_reduce(torch.ones(1), group=pair)
""")


def test_teardown_escalates_to_sigkill(tmp_path, monkeypatch):
    """Rank 2 fails; rank 0 traps SIGTERM and blocks in a gloo all_reduce
    that rank 1 (alive, ignoring TERM) never joins.  The launcher's TERM
    reaches neither, so after the grace it SIGKILLs both and returns rank
    2's code."""
    monkeypatch.setattr(tcli, "_KILL_GRACE", 3.0)
    monkeypatch.setenv("PYTHONPATH",
                       REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = tmp_path / "worker.py"
    script.write_text(BLOCKED_WORKER)
    t0 = time.monotonic()
    rc = tcli.main(["--nproc_per_node=3", "--master_port=0", str(script),
                    str(tmp_path)])
    took = time.monotonic() - t0
    assert rc == 5
    assert 3.0 <= took < 60   # the TERM alone did not end the round
    with open(tmp_path / "blocked.pid") as f:
        pid = int(f.read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)   # killed and reaped


JAX_WORKER = textwrap.dedent("""
    import importlib, json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import tpu_dist.dist as dist
    from tpu_dist import collectives as C
    rdzv = importlib.import_module("tpu_dist.dist.rendezvous")
    pg = dist.init_process_group(backend="cpu", init_method="env://")
    rank = dist.get_rank()
    out = {"rank": rank, "master_port": int(os.environ["MASTER_PORT"]),
           "store_connected": rdzv._store is not None,
           "local_rank_argv": [],
           "allreduce": float(np.asarray(
               C.all_reduce_host(np.array([rank + 1.0]), group=pg))[0]),
           "backend": "gloo"}
    with open(os.path.join(sys.argv[1], f"result{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("launcher,worker", [("tpu_dist", PORT_WORKER),
                                             ("tpu_dist_torch", JAX_WORKER)],
                         ids=["jax-launcher-port-workers",
                              "port-launcher-jax-workers"])
def test_either_launcher_runs_the_other_packages_workers(tmp_path, launcher,
                                                         worker):
    env = _env(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    r = _launch(tmp_path, ["--master_port=0"], env, pkg=launcher,
                worker=worker)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    res = _results(tmp_path)
    assert len({res[k]["master_port"] for k in res}) == 1
    for k in res:
        assert res[k]["store_connected"] and res[k]["allreduce"] == 3.0


def test_launcher_sigint_is_130_and_stops_the_world(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("import os, sys, time\n"
                      "open(os.path.join(sys.argv[1], os.environ['RANK']),"
                      " 'w').close()\n"
                      "time.sleep(120)\n")
    p = subprocess.Popen([sys.executable, "-m", "tpu_dist_torch.launch",
                          "--nproc_per_node=2", str(script), str(tmp_path)],
                         cwd=REPO, env=_env(), stderr=subprocess.PIPE,
                         text=True)
    try:
        # Ctrl-C once both ranks run (the launcher is then watching them)
        deadline = time.monotonic() + 120
        while not ((tmp_path / "0").exists() and (tmp_path / "1").exists()):
            assert time.monotonic() < deadline and p.poll() is None
            time.sleep(0.1)
        p.send_signal(signal.SIGINT)
        assert p.wait(timeout=60) == 130
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


RESTART_WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    import tpu_dist_torch.dist as dist
    pg = dist.init_process_group(init_method="env://", device="cpu")
    rank, gen = dist.get_rank(), dist.generation()
    t = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(t)
    dist.monitored_barrier(timeout=30)
    dist.monitored_barrier(timeout=30)
    with open(os.path.join(sys.argv[1], f"g{gen}_r{rank}.json"), "w") as f:
        json.dump({"sum": t.item(), "port": os.environ["MASTER_PORT"]}, f)
    if gen == 0 and rank == 1:
        import time
        for _ in range(600):   # fail once rank 0 has written its record
            if os.path.exists(os.path.join(sys.argv[1], "g0_r0.json")):
                break
            time.sleep(0.05)
        sys.exit(3)
    dist.destroy_process_group()
""")


def test_restart_on_a_fixed_port_with_monitored_barriers(tmp_path):
    """A restart on a FIXED --master_port (rank 0 hosts torch's store on the
    same port again, so it must not meet EADDRINUSE) whose workers call
    monitored_barrier twice a round: the launcher sweeps the failed round's
    monitored_barrier keys, or rank 1 of round 1 would wait out a release
    that rank 0 deleted (ROADMAP C8)."""
    port = _free_port()
    r = _launch(tmp_path, [f"--master_port={port}", "--max_restarts=1",
                           "--restart_backoff=0.1"], worker=RESTART_WORKER)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restart 1/1" in r.stderr
    for gen in (0, 1):
        for rank in (0, 1):
            with open(tmp_path / f"g{gen}_r{rank}.json") as f:
                rec = json.load(f)
            assert rec == {"sum": 3.0, "port": str(port)}
