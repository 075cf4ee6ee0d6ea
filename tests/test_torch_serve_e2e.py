"""Serving chaos end to end on the port — the counterpart of
``tests/test_serve_e2e.py``: real processes on the CPU, a serving worker
under the port's launcher with the gateway role (``--serve``), a SIGKILL
of the model rank under load, and the preemption drain.

Each case runs twice, with the worker of either package: the port's
``serve_lm`` twin (``--tiny --device cpu``) and the JAX package's
``examples/serve_lm.py --tiny``, the same faults and the same asserted
outcomes (a full drain then exit 117; every request in flight at the kill
done or ended ``BackendGoneError``/``BackendUnavailableError`` within a
bounded wait; after the supervised restart the SAME client connection gets
the same tokens).  The tokens are held to JAX ``generate`` in this
process: for the twin on its own weights carried into the JAX model (a
tree that ``load_jax_params`` maps back onto the twin's parameters bit for
bit), for the JAX worker on its ``init(jax.random.key(0))``.  Every
subprocess and every wait has its own timeout."""

import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch import interop, serve
from tpu_dist_torch.examples import serve_lm
from tpu_dist_torch.models import TransformerLM as TorchLM

pytestmark = [pytest.mark.serve, pytest.mark.chaos,
              pytest.mark.multiprocess]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = ("port", "jax")
TINY = serve_lm.TINY   # the JAX example's --tiny preset


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env["JAX_PLATFORMS"] = "cpu"   # the JAX worker
    env.pop("TPU_DIST_CHAOS", None)
    return env


def _worker_argv(worker: str) -> list:
    """The worker's argv after the launcher's flags (``-m`` module or a
    script), ``--tiny`` on the CPU."""
    if worker == "port":
        return ["-m", "tpu_dist_torch.examples.serve_lm", "--tiny",
                "--device", "cpu"]
    return [os.path.join(REPO, "examples", "serve_lm.py"), "--tiny"]


def _carried_tree(model: torch.nn.Module) -> dict:
    """``model``'s parameters as a JAX parameter tree
    ``{module_path: {leaf: array}}``, each leaf in the JAX layout."""
    layouts = interop._layouts(model)   # each a transpose: its own inverse
    tree: dict = {}
    for key, p in model.named_parameters():
        path, _, leaf = key.rpartition(".")
        a = p.detach().numpy()
        tree.setdefault(path, {})[leaf] = layouts[key](a) if key in layouts \
            else a
    return tree


@pytest.fixture(scope="module")
def refs():
    """``{worker: ref(prompt, n)}``: JAX ``generate`` on each worker's
    weights."""
    jm = JaxLM(vocab_size=TINY["vocab"], dim=TINY["dim"],
               depth=TINY["depth"], num_heads=TINY["heads"],
               max_seq_len=TINY["max_seq_len"])
    args = serve_lm.build_parser().parse_args(["--tiny", "--device", "cpu"])
    for k, v in TINY.items():
        setattr(args, k, v)
    twin = serve_lm.build_model(args, torch.device("cpu"))
    carried = _carried_tree(twin)
    # the tree is the twin's weights: it loads back onto them bit for bit
    back = interop.load_jax_params(
        TorchLM(TINY["vocab"], dim=TINY["dim"], depth=TINY["depth"],
                num_heads=TINY["heads"], max_seq_len=TINY["max_seq_len"],
                device="cpu"), carried)
    for (k, a), (_, b) in zip(twin.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), k
    params = {"port": carried, "jax": jm.init(jax.random.key(0))}

    def ref(worker):
        def generate(prompt, n):
            out = jm.generate(params[worker], np.asarray(prompt)[None], n)
            return np.asarray(out)[0, len(prompt):].tolist()
        return generate
    return {w: ref(w) for w in WORKERS}


@pytest.mark.parametrize("worker", WORKERS)
def test_exit_on_preempt_drains_then_117(worker, refs):
    """SIGTERM mid-decode: the worker stops admitting, FINISHES the
    in-flight request (its full token budget) and exits 117."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, *_worker_argv(worker), "--port", str(port),
         "--exit-on-preempt", "--run-seconds", "300"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        with serve.ServeClient("127.0.0.1", port, connect_retry=120.0) as c:
            prompt = list(range(1, 9))
            h = c.submit(prompt, max_new_tokens=120)
            first = next(iter(h.iter_tokens(timeout=120.0)))
            proc.send_signal(signal.SIGTERM)
            toks = h.wait_done(timeout=120.0)
            assert len(toks) == 120 and toks[0] == first
            assert toks == refs[worker](prompt, 120)
            assert proc.wait(timeout=60) == 117
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("worker", WORKERS)
def test_model_rank_sigkill_named_errors_then_resume(worker, tmp_path, refs):
    """The port's launcher + gateway + either package's worker: SIGKILL the
    model rank under load; every in-flight request ends done or with a
    named error; after the supervised restart the same connection serves
    the same tokens."""
    serve_port = _free_port()
    pid_file = str(tmp_path / "worker.pid")
    log = open(tmp_path / "launcher.log", "w")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--max_restarts", "2", "--restart_backoff", "0.2", "--serve",
         "--serve_port", str(serve_port), *_worker_argv(worker),
         "--pid-file", pid_file, "--run-seconds", "600"],
        env=_env(), cwd=REPO, stdout=log, stderr=log)
    cli = None
    try:
        cli = serve.ServeClient("127.0.0.1", serve_port, connect_retry=120.0)
        probe = list(range(3, 10))
        ref = cli.submit(probe, max_new_tokens=8).wait_done(240.0)
        assert ref == refs[worker](probe, 8)

        inflight = [cli.submit(list(range(2, 2 + 6 + i)),
                               max_new_tokens=150) for i in range(6)]
        next(iter(inflight[0].iter_tokens(timeout=120.0)))
        with open(pid_file) as f:
            worker_pid = int(f.read().strip())
        os.kill(worker_pid, signal.SIGKILL)

        outcomes = {"done": 0, "named": 0}
        for h in inflight:
            try:
                h.wait_done(timeout=120.0)   # bounded: no hangs allowed
                outcomes["done"] += 1
            except serve.RequestFailedError as e:
                assert e.error in ("BackendGoneError",
                                   "BackendUnavailableError"), e
                outcomes["named"] += 1
        assert outcomes["done"] + outcomes["named"] == len(inflight)
        assert outcomes["named"] >= 1, outcomes

        deadline = time.monotonic() + 180
        got = None
        while time.monotonic() < deadline:
            try:
                got = cli.submit(probe, max_new_tokens=8).wait_done(120.0)
                break
            except serve.RequestFailedError:
                time.sleep(0.5)   # backend still restarting: named, retry
        assert got == ref, f"post-restart output diverged: {got} vs {ref}"
        with open(pid_file) as f:
            assert int(f.read().strip()) != worker_pid
    finally:
        if cli is not None:
            cli.close()
        if launcher.poll() is None:
            launcher.send_signal(signal.SIGINT)   # the clean teardown
            try:
                launcher.wait(timeout=60)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait()
        log.close()
        try:
            with open(pid_file) as f:
                os.kill(int(f.read().strip()), signal.SIGKILL)
        except (OSError, ValueError):
            pass
    assert "restart 1/2" in (tmp_path / "launcher.log").read_text()
