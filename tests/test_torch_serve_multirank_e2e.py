"""Multi-rank serving through the port's launcher on the CPU — the twin's
``--sharded`` and ``--disagg`` paths end to end (real processes, the
gateway role, a ``ServeClient``), and ``examples/serve_lm.py``'s named
refusals.

The tokens are held to JAX ``generate`` in this process on the twin's own
``--tiny`` weights carried into the JAX model through ``interop``
(``jax_params``).  Every subprocess and every wait has its own timeout."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch import interop, serve
from tpu_dist_torch.examples import serve_lm

pytestmark = [pytest.mark.serve, pytest.mark.multiprocess]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = serve_lm.TINY
TWIN = ["-m", "tpu_dist_torch.examples.serve_lm", "--tiny", "--device",
        "cpu", "--run-seconds", "300"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for var in ("TPU_DIST_CHAOS", "TPU_DIST_STORE_ADDR", "TPU_DIST_ROLES",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def ref():
    """JAX ``generate`` on the twin's ``--tiny`` weights."""
    args = serve_lm.build_parser().parse_args(["--tiny", "--device", "cpu"])
    for k, v in TINY.items():
        setattr(args, k.replace("-", "_"), v)
    twin = serve_lm.build_model(args, torch.device("cpu"))
    jm = JaxLM(vocab_size=TINY["vocab"], dim=TINY["dim"],
               depth=TINY["depth"], num_heads=TINY["heads"],
               max_seq_len=TINY["max_seq_len"])
    params = interop.jax_params(twin)

    def generate(prompt, n):
        out = jm.generate(params, np.asarray(prompt, np.int32)[None], n)
        return np.asarray(out)[0, len(prompt):].tolist()
    return generate


def _launch(flags, worker_flags, tmp_path, name):
    port = _free_port()
    log = open(tmp_path / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--max_restarts=0", "--serve", f"--serve_port={port}", *flags,
         *TWIN, *worker_flags],
        cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    return proc, port, log


def _stop(proc, log):
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass
    proc.wait(timeout=30)
    log.close()


def _prompts():
    shared = list(range(5, 41))
    return [shared + [60 + i] for i in range(3)] + [list(range(3, 10)),
                                                    list(range(2, 22))]


@pytest.mark.parametrize("shape", ["sharded", "disagg"])
def test_multirank_twin_under_the_launcher(ref, tmp_path, shape):
    """``--nproc_per_node=2 --sharded`` and ``--roles prefill:1,decode:1
    --disagg``: greedy requests through the gateway equal JAX ``generate``
    token for token; the backend's stats show the path's own counters (the
    disaggregated pool's transfers and prefix hits), and each disagg role
    keeps its kernel launch counts beside ``--pid-file``."""
    flags = (["--nproc_per_node=2"] if shape == "sharded"
             else ["--roles", "prefill:1,decode:1"])
    pid = tmp_path / "worker.pid"
    worker = [f"--{shape}"] + (["--pid-file", str(pid)]
                               if shape == "disagg" else [])
    proc, port, log = _launch(flags, worker, tmp_path, shape)
    try:
        with serve.ServeClient("127.0.0.1", port, connect_retry=120,
                               timeout=60) as cli:
            prompts = _prompts()
            outs = [cli.submit(p, max_new_tokens=6).wait_done(120.0)
                    for p in prompts]
            stats = cli.stats(timeout=30)
        assert outs == [ref(p, 6) for p in prompts]
        backend = stats["backends"]["default"]
        assert backend["completed"] == len(prompts)
        if shape == "disagg":
            assert backend["kv"]["transfers"] == len(prompts)
            assert backend["prefix_cache"]["hits"] >= 2
            t_served = time.time()
            for path in (f"{pid}.kernels", f"{pid}.r1.kernels"):
                rec = _fresh_counts(path, t_served)
                # every wrapper takes its plain version on the CPU
                assert rec["kernel_launches"]
                assert not any(rec["kernel_launches"].values()), rec
    finally:
        _stop(proc, log)


def _fresh_counts(path, since: float, timeout: float = 10.0) -> dict:
    """The launch-count record at ``path`` once it was written after
    ``since`` (the rank rewrites it every 0.25 s)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(path) as f:
                rec = json.load(f)
            if rec["t"] >= since:
                return rec
        except (OSError, ValueError):
            pass
        assert time.monotonic() < deadline, f"no fresh counts at {path}"
        time.sleep(0.1)


def _run_twin(argv, env, timeout=120):
    return subprocess.run([sys.executable, *TWIN, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("case", ["sharded_no_store", "disagg_no_launcher",
                                  "disagg_int8", "disagg_role_order"])
def test_named_refusals(tmp_path, case):
    """The JAX example's refusals, each exit 2 with its message before any
    traffic: ``--sharded`` without a store; ``--disagg`` outside the role
    launcher, with an int8 cache, or with the roles in the wrong order."""
    if case == "sharded_no_store":
        r = _run_twin(["--sharded"], _env(WORLD_SIZE="2", RANK="0"))
        assert r.returncode == 2 and "control-plane store" in r.stderr
    elif case == "disagg_no_launcher":
        r = _run_twin(["--disagg"], _env())
        assert r.returncode == 2 and "role-graph launcher" in r.stderr
    elif case == "disagg_int8":
        r = _run_twin(["--disagg", "--cache-dtype", "int8"], _env(
            TPU_DIST_ROLES="prefill:1,decode:1",
            TPU_DIST_STORE_ADDR="127.0.0.1:1"))
        assert r.returncode == 2 and "int8" in r.stderr
    else:
        r = _run_twin(["--disagg"], _env(
            TPU_DIST_ROLES="decode:1,prefill:1",
            TPU_DIST_STORE_ADDR="127.0.0.1:1"))
        assert r.returncode == 2 and "prefill first" in r.stderr
