"""Bucketed async gradient sync against per-leaf sync over the host ring —
the port's twin of ``benchmarks/bench_overlap.py``.

Throughput of a many-tensor all-reduce (the 64-leaf mixed-size float32
"gradient tree") in four issue disciplines over the same host data plane
(every leaf rides the ring: ``TPU_DIST_DP_THRESHOLD=0``):

- **per_leaf_sync**: one blocking ``all_reduce_host`` a leaf;
- **per_leaf_async**: one ``async_op=True`` handle a leaf, waited together;
- **tree_sync**: one blocking tree call;
- **bucketed_async**: :class:`~tpu_dist_torch.collectives.Bucketer`, the
  leaves in 25 MiB chunk-major buckets, each one async ring all-reduce.

MB/s is input payload bytes (the leaves' bytes) per second of wall time
for the whole tree.  Leaves are tensors on ``--device`` (each rank's own
card with ``cuda``, staged through host memory).  Workers are wired as
``bench_host_collectives`` wires them (a store and a rank shim).  One JSON
line a measurement and the ``bucketed_async_vs_per_leaf_sync_w4`` summary;
``--smoke`` runs world 2 on a 16-leaf tree and checks the bucketed result
against the per-leaf ring bit for bit.

    python -m tpu_dist_torch.benchmarks.bench_overlap [--worlds 2 4]
    python -m tpu_dist_torch.benchmarks.bench_overlap --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .bench_host_collectives import _Group, attach_store, worker_device
from .bench_zero import _leaf_sizes

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODES = ("per_leaf_sync", "per_leaf_async", "tree_sync", "bucketed_async")


def _worker() -> int:
    import torch

    from .. import collectives as C
    from ..collectives import transport as T

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    spec = json.loads(os.environ["BENCH_SPEC"])
    store = attach_store(os.environ["TPU_DIST_STORE_ADDR"])
    dev = worker_device(spec["device"], rank)
    g = _Group(rank, world)
    os.environ["TPU_DIST_DP_THRESHOLD"] = "0"
    tree = {f"leaf{i:03d}": torch.from_numpy(
        np.random.default_rng(1000 * (rank + 1) + i).standard_normal(n)
        .astype(np.float32)).to(dev) for i, n in enumerate(spec["sizes"])}
    leaves = list(tree.values())
    nbytes = sum(v.numel() * 4 for v in leaves)
    bucketer = C.Bucketer()

    def run_mode(mode):
        if mode == "per_leaf_sync":
            return [C.all_reduce_host(a, group=g, op="avg") for a in leaves]
        if mode == "per_leaf_async":
            works = [C.all_reduce_host(a, group=g, op="avg", async_op=True)
                     for a in leaves]
            return C.wait_all(works, timeout=600)
        if mode == "tree_sync":
            return C.all_reduce_host(tree, group=g, op="avg")
        return bucketer.all_reduce(tree, op="avg",
                                   group=g).wait_all(timeout=600)

    if spec.get("check"):
        ref = run_mode("per_leaf_sync")
        got = run_mode("bucketed_async")
        for a, (k, b) in zip(ref, sorted(got.items())):
            b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
                f"bucketed != per-leaf for {k}"

    rows = []
    for mode in _MODES:
        run_mode(mode)  # warm-up: peer connections, engine thread
        store.barrier(world, tag=f"bench-{mode}")
        t0 = time.perf_counter()
        for _ in range(spec["iters"]):
            run_mode(mode)
        dt = time.perf_counter() - t0
        rows.append({"metric": "grad_sync", "mode": mode, "world": world,
                     "leaves": len(leaves), "bytes": nbytes,
                     "iters": spec["iters"],
                     "value": nbytes * spec["iters"] / dt / 1e6,
                     "unit": "MB/s", "device": str(dev)})
    if rank == 0:
        with open(os.environ["BENCH_OUT"], "w") as f:
            json.dump(rows, f)
    store.barrier(world, tag="bench-exit")
    T.close_data_plane()
    store.close()
    return 0


def _run_world(world: int, smoke: bool, iters: int, device: str) -> list:
    from ..dist.store import TCPStore
    with tempfile.NamedTemporaryFile(mode="w", suffix=".json",
                                     delete=False) as tmp:
        out_path = tmp.name
    store = TCPStore(is_master=True)
    procs = []
    try:
        env = dict(os.environ,
                   TPU_DIST_STORE_ADDR=f"127.0.0.1:{store.port}",
                   WORLD_SIZE=str(world),
                   PYTHONPATH=_REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""),
                   BENCH_OUT=out_path,
                   BENCH_SPEC=json.dumps({"sizes": _leaf_sizes(smoke),
                                          "iters": iters, "check": smoke,
                                          "device": device}))
        for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_DP_THRESHOLD",
                  "TPU_DIST_HOST_TRANSPORT"):
            env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_overlap",
             "--worker"], env=dict(env, RANK=str(r)), cwd=_REPO)
            for r in range(world)]
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
        store.close()
        os.unlink(out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="world 2, 16-leaf tree, bitwise bucketed-vs-"
                         "per-leaf check")
    ap.add_argument("--worlds", type=int, nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=0,
                    help="per-mode iterations (0: 2 with --smoke, else 4)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.worker:
        return _worker()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_overlap: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    worlds = args.worlds or ([2] if args.smoke else [2, 4])
    iters = args.iters or (2 if args.smoke else 4)
    rows = []
    for world in worlds:
        for row in _run_world(world, args.smoke, iters, args.device):
            if args.smoke:
                row["smoke"] = True
            print(json.dumps(row), flush=True)
            rows.append(row)
    by_key = {(r["mode"], r["world"]): r["value"] for r in rows}
    bucketed = by_key.get(("bucketed_async", 4))
    per_leaf = by_key.get(("per_leaf_sync", 4))
    if bucketed and per_leaf:
        print(json.dumps({"metric": "bucketed_async_vs_per_leaf_sync_w4",
                          "value": bucketed / per_leaf, "unit": "x",
                          "threshold": 1.5}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
