"""ZeRO's sharded optimizer step against the replicated update — the port's
twin of ``benchmarks/bench_zero.py``.

Both disciplines over the JAX benchmark's 64-leaf mixed-size float32 tree
(``_leaf_sizes``, copied from ``benchmarks/bench_overlap.py``), on the
group's backend (NCCL on the card, gloo with ``--device cpu``):

- **replicated**: the bucketed async all-reduce (issue, stage the next
  input, ``wait_all``) and a replicated ``Adam(1e-3)`` over the whole tree on
  every rank;
- **zero**: :class:`~tpu_dist_torch.parallel.ZeroOptimizer` — the bucketed
  reduce-scatter, Adam on this rank's flat shard only, and the parameter
  all-gather waited after the next input is staged.

Each step stages the same host input (64 Ki seeded normals, the loader's
stand-in).  Every row carries ``opt_state_bytes_per_rank``, measured off the
live optimizer state::

    {"metric": "zero_step", "mode": "zero", "world": 4, "leaves": 64,
     "value": ..., "unit": "steps/s", "opt_state_bytes_per_rank": ...,
     "device": "NVIDIA H100 80GB HBM3"}

``--smoke`` runs world 2 on the 16-leaf tree and checks the ZeRO parameters
against the replicated update's, bit for bit.  Worlds above 1 start one
process per rank (one card each on the card).

    python -m tpu_dist_torch.benchmarks.bench_zero [--worlds 1 2 4]
    python -m tpu_dist_torch.benchmarks.bench_zero --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["bench", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODES = ("replicated", "zero")


def _leaf_sizes(smoke: bool):
    """The 64-leaf mixed-size tree (element counts): mostly small-to-medium
    leaves plus a few large ones — the shape bucketing exists for."""
    if smoke:
        return [257, 1024, 4099, 16384] * 4            # 16 leaves, ~350 KB
    sizes = [1024, 4099, 16384, 65537] * 15            # 60 leaves
    sizes += [262144] * 4                              # 4 big kernels
    return sizes                                       # 64 leaves, ~9.6 MB


def _tensor_bytes(tree) -> int:
    from ..collectives import _tree
    return int(sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                   else np.asarray(v).nbytes
                   for v in _tree.flatten(tree)[0]))


def bench(group, sizes, iters: int, check: bool = False) -> list:
    """Both modes over ``group`` (an initialized port ProcessGroup): rows of
    steps/s and optimizer-state bytes; with ``check`` the ZeRO parameters
    after two steps must equal the replicated update's bit for bit
    (``AssertionError`` otherwise)."""
    from .. import collectives as C
    from .. import optim
    from ..parallel import ZeroOptimizer

    dev, rank, world = group.device, group.rank, group.size()
    params0 = {f"leaf{i:03d}": torch.from_numpy(
        np.random.default_rng(77 + i).standard_normal(n).astype(np.float32)
    ).to(dev) for i, n in enumerate(sizes)}          # identical on all ranks
    grads = {k: torch.from_numpy(
        np.random.default_rng(1000 * (rank + 1) + i).standard_normal(
            v.numel()).astype(np.float32) * np.float32(0.01)).to(dev)
        for i, (k, v) in enumerate(params0.items())}
    nbytes = sum(v.numel() * 4 for v in params0.values())
    stage_rng = np.random.default_rng(rank)

    def stage():
        # the input staging a DeviceLoader prefetch does while the async
        # collective is in flight
        return stage_rng.standard_normal(64 * 1024).astype(np.float32)

    def run_replicated(steps):
        params = {k: v.clone() for k, v in params0.items()}
        opt = optim.Adam(1e-3)
        opt_state = opt.init(params)
        bucketer = C.Bucketer()
        for _ in range(steps):
            work = bucketer.all_reduce(grads, op="avg", group=group)
            stage()
            gsync = work.wait_all(timeout=600)
            params, opt_state = opt.update(gsync, opt_state, params)
        return params, _tensor_bytes(opt_state)

    def run_zero(steps):
        params = {k: v.clone() for k, v in params0.items()}
        zopt = ZeroOptimizer(optim.Adam(1e-3), group=group)
        zstate = zopt.init(params)
        handle = None
        for _ in range(steps):
            stage()
            if handle is not None:
                params = handle.wait(timeout=600)   # lazily waited gather
            rs = zopt.reduce_scatter(grads, group=group)
            handle, zstate = zopt.update(rs, zstate, group=group)
        params = handle.wait(timeout=600)
        return params, _tensor_bytes(zstate["opt"])

    runners = {"replicated": run_replicated, "zero": run_zero}
    if check:
        ref, _ = run_replicated(2)
        got, _ = run_zero(2)
        for k in ref:
            assert torch.equal(ref[k].view(torch.int32),
                               got[k].reshape(ref[k].shape).view(
                                   torch.int32)), \
                f"zero != replicated for {k}"
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    rows = []
    for mode in _MODES:
        runners[mode](1)   # warm-up: communicators, caches
        sync()
        if world > 1:
            torch.distributed.barrier(
                **({"device_ids": [dev.index]} if dev.type == "cuda"
                   else {}))
        t0 = time.perf_counter()
        _, state_bytes = runners[mode](iters)
        sync()
        dt = time.perf_counter() - t0
        rows.append({"metric": "zero_step", "mode": mode, "world": world,
                     "leaves": len(sizes), "bytes": nbytes, "iters": iters,
                     "value": iters / dt, "unit": "steps/s",
                     "opt_state_bytes_per_rank": state_bytes,
                     "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")})
    return rows


def _worker() -> int:
    from .. import dist
    spec = json.loads(os.environ["BENCH_SPEC"])
    pg = dist.init_process_group(init_method="env://",
                                 device=spec["device"] or None)
    try:
        rows = bench(pg, spec["sizes"], spec["iters"], spec["check"])
        if pg.rank == 0:
            with open(os.environ["BENCH_OUT"], "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(world: int, smoke: bool, iters: int, device: str) -> list:
    with tempfile.NamedTemporaryFile(mode="w", suffix=".json",
                                     delete=False) as tmp:
        out_path = tmp.name
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
               BENCH_OUT=out_path,
               BENCH_SPEC=json.dumps({"sizes": _leaf_sizes(smoke),
                                      "iters": iters, "check": smoke,
                                      "device": device}))
    for k in ("TPU_DIST_STORE_ADDR", "TPU_DIST_RESTART_COUNT"):
        env.pop(k, None)
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_zero",
             "--worker"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            cwd=_REPO) for r in range(world)]
        deadline = time.monotonic() + 600
        rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
               for p in procs]
        if any(rcs):
            raise RuntimeError(f"bench workers failed: rcs={rcs}")
        with open(out_path) as f:
            return json.load(f)
    finally:
        for p in procs:  # a hung or failed world must not leak workers
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="world 2, 16-leaf tree, bitwise zero-vs-replicated "
                         "check")
    ap.add_argument("--worlds", type=int, nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=0,
                    help="iterations a mode (0: 2 with --smoke, else 4)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.worker:
        return _worker()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_zero: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.device == "cpu" else ""
    cards = torch.cuda.device_count() if args.device == "cuda" else 4
    worlds = args.worlds or ([2] if args.smoke else
                             [w for w in (1, 2, 3, 4) if w <= cards])
    iters = args.iters or (2 if args.smoke else 4)
    rows = []
    for world in worlds:
        for row in _run_world(world, args.smoke, iters, device):
            if args.smoke:
                row["smoke"] = True
            print(json.dumps(row), flush=True)
            rows.append(row)
    by_key = {(r["mode"], r["world"]): r for r in rows}
    zero, repl = by_key.get(("zero", 4)), by_key.get(("replicated", 4))
    if zero and repl:
        print(json.dumps({"metric": "zero_vs_replicated_w4",
                          "value": zero["value"] / repl["value"],
                          "unit": "x"}))
        print(json.dumps({
            "metric": "zero_opt_state_fraction_w4",
            "value": zero["opt_state_bytes_per_rank"]
            / repl["opt_state_bytes_per_rank"],
            "unit": "of replicated", "expected": 0.25}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
