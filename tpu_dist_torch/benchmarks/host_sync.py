"""The dense cell's gradient sync at world n, three ways: the group's
backend (the Bucketer's chunk-major reduce-scatter and all-gather on NCCL),
the host ring on the float32 wire, and the host ring on ``int8_block256``
with error feedback.

Each rank takes one card, computes the dense GPT-2-small cell's gradients
(vocab 32768, dim 768, depth 12, 12 heads, T = 2048, bf16 compute over
float32 masters, fused loss; a seeded batch of 2 rows a rank: 136,993,280
float32 values, 548 MB), then times ``Bucketer().all_reduce(grads,
op="avg")`` in each mode (``TPU_DIST_HOST_TRANSPORT`` unset for the
backend, ``dataplane`` for the ring; ``TPU_DIST_COMM_DTYPE=int8_block256``
and an ErrorFeedback for the compressed ring), the card synchronized
before and after each sync.  It measures only: every call is the port's
own (the Bucketer, the eager routing, the ring).  One JSON line a mode::

    {"metric": "grad_sync_ms", "mode": "ring_int8_ef", "world": 4,
     "value": ..., "unit": "ms", "bytes": 547973120, ...}

    python -m tpu_dist_torch.benchmarks.host_sync [--world 4] [--iters 5]

With ``TPU_DIST_OBS=1`` (and ``TPU_DIST_OBS_DIR``) or ``TPU_DIST_SANITIZE=1``
in its environment the workers run with the flight recorder or the
sanitizer armed; each row says which (``obs``, ``sanitize``) and counts the
recorder's collective spans so far by path (``spans_by_path``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("backend", "ring_f32", "ring_int8_ef")


def dense_cell(group=None, device=None, batch: int = 2):
    """The dense cell's DDP and its seeded initial state."""
    from .transformer_lm import build
    ddp, _, _ = build(batch=batch, group=group, device=device)
    return ddp, ddp.init(seed=0)


def ring_subset(grads: dict, blocks: int = 4,
                skip=("tok.weight", "head.weight")) -> dict:
    """The leaves of ``grads`` of blocks ``0 .. blocks-1`` and every leaf
    outside the blocks but ``skip`` (the two 100 MB vocabulary tables): 120
    MB of the dense cell's 548, every kind of leaf (matrices, biases,
    norms, the 32768-long head bias), for syncs that must fit a time
    budget."""
    def kept(name):
        if name in skip:
            return False
        return (not name.startswith("block")
                or int(name[5:].split(".")[0]) < blocks)
    return {k: v for k, v in grads.items() if kept(k)}


def rank_grads(ddp, state, rank: int, batch: int = 2) -> dict:
    """The dense cell's float32 gradients on rank ``rank``'s seeded batch:
    one forward and backward through the port's DDP machinery (K1f/K1b
    once, K2f/K2b 12 times), no collective."""
    rng = np.random.default_rng(100 + rank)
    x, y = (torch.from_numpy(rng.integers(0, 32768, (batch, 2048))).to(
        ddp.device) for _ in range(2))
    grads, _, _ = ddp._micro_grads(state, x, y, 0)
    return dict(zip(state.params, grads))


def _worker() -> int:
    from .. import collectives as C
    from .. import dist
    from ..analysis import sanitizer
    from ..collectives.quant import ErrorFeedback
    from ..obs import recorder

    spec = json.loads(os.environ["BENCH_SPEC"])
    pg = dist.init_process_group(init_method="env://")
    try:
        grads = rank_grads(*dense_cell(pg, pg.device), pg.rank)
        nbytes = sum(v.numel() * v.element_size() for v in grads.values())
        rows = []
        for mode in MODES:
            os.environ.pop("TPU_DIST_COMM_DTYPE", None)
            if mode == "backend":
                os.environ.pop("TPU_DIST_HOST_TRANSPORT", None)
            else:
                os.environ["TPU_DIST_HOST_TRANSPORT"] = "dataplane"
            if mode == "ring_int8_ef":
                os.environ["TPU_DIST_COMM_DTYPE"] = "int8_block256"
            ef = ErrorFeedback() if mode == "ring_int8_ef" else None
            bucketer = C.Bucketer()
            times = []
            for i in range(spec["iters"] + 1):     # the first warms up
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                out = bucketer.all_reduce(grads, op="avg", group=pg,
                                          error_feedback=ef).wait_all(600)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            del out
            rows.append({"metric": "grad_sync_ms", "mode": mode,
                         "obs": recorder.enabled(),
                         "sanitize": sanitizer.enabled(),
                         "spans_by_path": _spans_by_path(),
                         "world": pg.size(), "value": statistics.median(
                             times), "unit": "ms", "samples_ms": times,
                         "bytes": nbytes, "leaves": len(grads),
                         "effective_mb_s": nbytes / statistics.median(
                             times) / 1e3,
                         "staging_s": (dict(bucketer.staging)
                                       if mode != "backend" else None),
                         "device": torch.cuda.get_device_name(pg.device)})
        if pg.rank == 0:
            with open(os.environ["BENCH_OUT"], "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()
    return 0


def _spans_by_path() -> dict:
    """The armed recorder's collective spans so far, counted by transport
    path (empty when disarmed)."""
    from ..obs import recorder
    rec = recorder.get_recorder()
    out: dict = {}
    for e in rec.snapshot() if rec is not None else ():
        if e["kind"] == "collective":
            key = str(e.get("path"))
            out[key] = out.get(key, 0) + 1
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, iters: int) -> list:
    from ..dist.store import TCPStore
    store = TCPStore(is_master=True)
    with tempfile.NamedTemporaryFile(mode="w", suffix=".json",
                                     delete=False) as tmp:
        out_path = tmp.name
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               TPU_DIST_STORE_ADDR=f"127.0.0.1:{store.port}",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
               BENCH_OUT=out_path, BENCH_SPEC=json.dumps({"iters": iters}))
    for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_HOST_TRANSPORT",
              "TPU_DIST_COMM_DTYPE"):
        env.pop(k, None)
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.benchmarks.host_sync",
             "--worker"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            cwd=_REPO) for r in range(world)]
        deadline = time.monotonic() + 1200
        rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
               for p in procs]
        if any(rcs):
            raise RuntimeError(f"host_sync workers failed: rcs={rcs}")
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
    ap.add_argument("--world", type=int, default=0,
                    help="ranks, one card each (default: every card)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker()
    if not torch.cuda.is_available():
        print("host_sync: no CUDA device", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    if world > torch.cuda.device_count():
        print(f"host_sync: world {world} needs {world} cards (NCCL takes "
              f"one rank a card)", file=sys.stderr)
        return 2
    for row in run_world(world, args.iters):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
