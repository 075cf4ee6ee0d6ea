"""The example twins under the port's launcher at world 2 (gloo, the CPU):
``launch_dist`` (ConvNet/MNIST), ``example_launch`` (ResNet-18/CIFAR-10,
with ``--sync-bn`` and ``--local_rank`` from ``--pass_local_rank``) and
``train_lm`` (``--parallel dp``) take the env contract unchanged, and every
step's loss on every rank equals, bit for bit, the same twin's under
``spawn`` at world 2 — the world whose DDP step is held to the JAX package
in ``tests/test_torch_dist.py`` and ``tests/test_torch_vision_ddp.py``.
Synthetic data, a few steps each; every subprocess has its own timeout."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytestmark = pytest.mark.multiprocess

REPO = Path(__file__).resolve().parent.parent

# argv: launched|spawned MODULE OUT_DIR TWIN_ARGS...; each rank writes its
# losses to OUT_DIR/<mode>_<rank>.json
RUNNER = textwrap.dedent("""
    import importlib, json, os, sys

    def run(module, out, mode, argv):
        twin = importlib.import_module(f"tpu_dist_torch.examples.{module}")
        res = twin.train(twin.parse_args(argv))
        with open(os.path.join(out, f"{mode}_{os.environ['RANK']}.json"),
                  "w") as f:
            json.dump({"losses": [float(v) for v in res["losses"]],
                       "argv": argv}, f)

    def child(i, module, out, argv, port):
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          RANK=str(i), LOCAL_RANK=str(i), WORLD_SIZE="2")
        run(module, out, "spawned", argv)

    if __name__ == "__main__":
        mode, module, out, *argv = sys.argv[1:]
        if mode == "launched":
            run(module, out, mode, argv)
        else:
            from tpu_dist_torch.launch import spawn
            spawn(child, args=(module, out, argv, os.environ["PORT"]),
                  nprocs=2)
""")

TWINS = {
    "launch_dist": ["--device", "cpu", "--synthetic", "--max-steps", "3",
                    "--batch-size", "32"],
    "example_launch": ["--device", "cpu", "--synthetic", "--max-steps", "2",
                       "--batch-size", "16", "--sync-bn"],
    "train_lm": ["--device", "cpu", "--steps", "3", "--seq-len", "32",
                 "--dim", "32", "--depth", "2", "--heads", "4", "--vocab",
                 "64", "--batch-size", "4"],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argv, tmp_path, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", PORT=str(_free_port()),
               PYTHONPATH=str(tmp_path) + os.pathsep + str(REPO)
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_under_the_launcher_equals_spawn(tmp_path, twin):
    runner = tmp_path / "twin_runner.py"
    runner.write_text(RUNNER)
    extra = ["--pass_local_rank"] if twin == "example_launch" else []
    launched = _run(["-m", "tpu_dist_torch.launch", "--standalone",
                     "--nproc_per_node=2", *extra, str(runner), "launched",
                     twin, str(tmp_path), *TWINS[twin]], tmp_path)
    _run([str(runner), "spawned", twin, str(tmp_path), *TWINS[twin]],
         tmp_path)
    got = {}
    for mode in ("launched", "spawned"):
        for rank in (0, 1):
            with open(tmp_path / f"{mode}_{rank}.json") as f:
                got[mode, rank] = json.load(f)
    if extra:
        assert got["launched", 1]["argv"][-1] == "--local_rank=1"
    for rank in (0, 1):
        a = got["launched", rank]["losses"]
        b = got["spawned", rank]["losses"]
        assert a == b and len(a) >= 2, (rank, a, b)
    assert got["launched", 0]["losses"] == got["launched", 1]["losses"]
    assert "Training complete in:" in launched.stdout
