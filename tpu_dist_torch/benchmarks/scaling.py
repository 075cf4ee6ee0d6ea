"""Weak-scaling overhead of the DDP step — the port's twin of the JAX
package's ``benchmarks/scaling.py``.

The ConvNet DDP step (SGD 1e-4, batch ``per_device_batch`` a rank, held
constant) at each world size, one process a rank:

- ``device="cpu"``: gloo ranks on the host's cores, the JAX row's setting
  (its virtual CPU devices) and its metric,
  ``ddp_weak_scaling_overhead_virtual_cpu_mesh``.  When the ranks
  outnumber the cores their compute serializes, so the ideal is ``t_N =
  N·t_1``, and ``serialized_efficiency(N) = N·t_1 / t_N`` is 1.0 when the
  all-reduce and the step's machinery add nothing; with a core a rank the
  compute runs at once and the figure can exceed 1 (``host_cores`` is in
  the row).
- ``device="cuda"``: a card a rank over NCCL, up to the machine's card
  count (``ddp_weak_scaling_overhead_nccl``), where the ideal is ``t_N =
  t_1`` and ``efficiency(N) = t_1 / t_N`` is given beside the JAX figure.

Each world is a fresh set of processes that meet at ``MASTER_ADDR``/
``MASTER_PORT``; rank 0 times ``steps`` steps of ``train_repeat`` on the
host clock, the card synchronized at both ends (the loss read back), the
best of ``reps``, after a warm-up, and prints its result.

    python -m tpu_dist_torch.benchmarks.scaling [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_WORLD_SIZES = (1, 2, 4, 8, 16, 32)
METRICS = {"cpu": "ddp_weak_scaling_overhead_virtual_cpu_mesh",
           "cuda": "ddp_weak_scaling_overhead_nccl"}

__all__ = ["run", "DEFAULT_WORLD_SIZES", "METRICS"]


def _worker(per_device_batch: int, steps: int, reps: int) -> int:
    """One rank: the ConvNet DDP step timed over ``steps`` steps, the best
    of ``reps``; rank 0 prints ``BENCH_JSON {"step_s": ...}``."""
    import numpy as np
    import torch

    from .. import dist, nn, optim
    from ..models import ConvNet
    from ..parallel import DistributedDataParallel

    device = os.environ["SCALING_DEVICE"]
    pg = dist.init_process_group(init_method="env://",
                                 device=None if device == "cuda" else device)
    try:
        dev = pg.device
        ddp = DistributedDataParallel(
            ConvNet(device=dev), optimizer=optim.SGD(lr=1e-4),
            loss_fn=nn.CrossEntropyLoss(), group=pg)
        rng = np.random.default_rng(0)
        n = pg.size()
        x = rng.normal(size=(per_device_batch * n, 1, 28, 28)).astype(
            np.float32)
        y = rng.integers(0, 10, per_device_batch * n)
        rows = slice(pg.rank * per_device_batch,
                     (pg.rank + 1) * per_device_batch)
        x = torch.from_numpy(x[rows]).to(dev)
        y = torch.from_numpy(y[rows]).to(dev)
        state = ddp.init(seed=0)
        state, _ = ddp.train_repeat(state, x, y, 2)   # warm
        best = float("inf")
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = ddp.train_repeat(state, x, y, steps)
            float(m["loss"][-1])                     # the card finishes
            best = min(best, (time.perf_counter() - t0) / steps)
        if pg.rank == 0:
            print("BENCH_JSON " + json.dumps({"step_s": best}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(n: int, device: str, per_device_batch: int, steps: int,
           reps: int, timeout: float) -> float:
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               SCALING_DEVICE=device,
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    args = [sys.executable, "-m", "tpu_dist_torch.benchmarks.scaling",
            "--worker", "--per-device-batch", str(per_device_batch),
            "--steps", str(steps), "--reps", str(reps)]
    procs = [subprocess.Popen(args, cwd=_REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    try:
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(1, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"scaling world {n} failed: "
                           f"{[p.returncode for p in procs]}\n"
                           f"{outs[0][1][-3000:]}")
    for line in outs[0][0].splitlines():
        if line.startswith("BENCH_JSON "):
            return json.loads(line[len("BENCH_JSON "):])["step_s"]
    raise RuntimeError(f"no BENCH_JSON line from world {n}:\n"
                       f"{outs[0][0][-2000:]}")


def run(per_device_batch: int = 32, steps: int = 6, reps: int = 3,
        world_sizes=None, device: str = "cuda",
        timeout: float = 1800) -> dict:
    """The row: each world's step ms and its serialized efficiency
    ``N·t_1 / t_N`` (the JAX figure); on cards also ``t_1 / t_N``.
    ``world_sizes``: the JAX ladder on the CPU, the powers of two up to the
    card count on cards."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu'")
        cards = torch.cuda.device_count()
        world_sizes = world_sizes or tuple(
            n for n in DEFAULT_WORLD_SIZES if n <= cards)
        if max(world_sizes) > cards:
            raise ValueError(f"{max(world_sizes)} ranks need as many cards; "
                             f"this machine has {cards}")
    world_sizes = tuple(world_sizes or DEFAULT_WORLD_SIZES)
    if world_sizes[0] != 1:
        raise ValueError("world_sizes must start at 1")
    times = {n: _world(n, device, per_device_batch, steps, reps, timeout)
             for n in world_sizes}
    t1 = times[1]
    row = {
        "metric": METRICS[device],
        "step_ms": {str(n): t * 1e3 for n, t in times.items()},
        "serialized_efficiency": {str(n): n * t1 / t
                                  for n, t in times.items()},
        "per_device_batch": per_device_batch,
        "host_cores": os.cpu_count() or 1,
        "device": device,
        "note": "one process a rank; on the CPU gloo with one thread a "
                "rank (ideal t_N = N*t_1 once ranks outnumber cores), on "
                "cards NCCL (ideal t_N = t_1)",
    }
    if device == "cuda":
        from ._card import device_stamp
        row["efficiency"] = {str(n): t1 / t for n, t in times.items()}
        row.update(device_stamp("cuda"))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--per-device-batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--world-sizes", default="",
                    help="comma-separated, starting at 1")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.per_device_batch, args.steps, args.reps)
    sizes = tuple(int(v) for v in args.world_sizes.split(",") if v) or None
    print(json.dumps(run(args.per_device_batch, args.steps, args.reps,
                         sizes, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
