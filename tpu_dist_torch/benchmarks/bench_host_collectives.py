"""Host-collective throughput, the store against the host data plane — the
port's twin of ``benchmarks/bench_host_collectives.py``.

MB/s of the eager host collectives (``all_reduce_host``, ``all_gather_host``,
``broadcast_host``) per payload size and world size, over both transports
of the JAX routing:

- **store**: pickled payloads through the control-plane TCPStore
  (``TPU_DIST_DP_THRESHOLD`` forced huge);
- **dataplane**: the rank-to-rank sockets running the chunk-pipelined ring
  and tree collectives (threshold 0).

The dataplane all-reduce also runs the **wire** variants (``comm``: f32,
``bfloat16``, ``int8_block256``; ``compression`` is the wire-byte ratio off
the transport counters) and the **topology** variants (``algo``: ``flat``,
the flat TCP ring with shared-memory lanes off; ``flat_shm``, the same ring
over the lanes; ``hier``, the two-level ring).  Workers get simulated host
fingerprints (``TPU_DIST_HOST_ID``): world >= 4 splits into two "hosts",
smaller worlds share one.  Rows carry ``shm_active`` (whether a lane to the
next rank was up), so a ``flat_shm``/``hier`` row that ran on TCP says so.
A paired CRC row times checksums on and off back to back, both arms paced
to one emulated wire rate (150 MB/s) by a ``slow-drip`` fault of the
network chaos layer, as the JAX benchmark paces them: on a wire-bound link
the checksum overlaps the transfer, where an unpaced loopback measures
memory-bus contention.  The overhead is reported, not gated.

MB/s is algorithmic: input payload bytes per second of collective wall
time.  Payloads are tensors on ``--device`` (``cuda``: each rank's own card
where there are enough, staged through host memory by the eager
collectives, as a port user's would be).  Workers are plain processes
wired as the JAX benchmark wires them: a store client handed to the
rendezvous module and a rank shim, no ``torch.distributed`` group.  One JSON
line a measurement, then the JAX benchmark's summary lines
(``ring_vs_store_speedup_8MiB_w4``, ``quant_vs_f32_speedup_8MiB_w{n}``,
``hier_vs_flat_speedup_8MiB_w{n}``, ``crc_overhead_8MiB_w{n}``).
``--smoke`` runs world 2 at 1 MiB, checks the numerics against the store
path, hier and SHM bit for bit against the flat ring, and the compressed
results byte-identical across ranks.

    python -m tpu_dist_torch.benchmarks.bench_host_collectives [--worlds 2 4]
    python -m tpu_dist_torch.benchmarks.bench_host_collectives \
        --device cpu --smoke
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_SMOKE_SIZES = [1 << 20]
_FULL_SIZES = [64 << 10, 1 << 20, 8 << 20]
_OPS = ("all_reduce", "all_gather", "broadcast")


class _Group:
    """The rank shim: the store and data-plane paths need only rank and
    num_processes (no backend, so nothing routes to one)."""

    def __init__(self, rank: int, num_processes: int):
        self.rank, self.num_processes = rank, num_processes


def attach_store(addr: str):
    """Connect to the control-plane store at ``host:port`` and hand it to
    the rendezvous module, where the eager collectives look for it."""
    import importlib

    from ..dist.store import TCPStore
    host, _, port = addr.rpartition(":")
    store = TCPStore(host, int(port))
    importlib.import_module("tpu_dist_torch.dist.rendezvous")._store = store
    return store


def worker_device(device: str, rank: int):
    """This worker's device: its own card where there are enough."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _worker() -> int:
    import torch

    from .. import collectives as C
    from ..collectives import eager as E
    from ..collectives import transport as T
    from ..resilience import netchaos

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    spec = json.loads(os.environ["BENCH_SPEC"])
    store = attach_store(os.environ["TPU_DIST_STORE_ADDR"])
    dev = worker_device(spec["device"], rank)
    g = _Group(rank, world)

    def run_op(op, x):
        if op == "all_reduce":
            return C.all_reduce_host(x, group=g, op="sum")
        if op == "all_gather":
            return C.all_gather_host(x, group=g)
        return C.broadcast_host(x, group=g, src=0)

    def apply_case_env(case):
        os.environ["TPU_DIST_DP_THRESHOLD"] = (
            "0" if case["path"] == "dataplane" else str(1 << 60))
        if case.get("comm"):
            os.environ["TPU_DIST_COMM_DTYPE"] = case["comm"]
        else:
            os.environ.pop("TPU_DIST_COMM_DTYPE", None)
        if case.get("crc") is not None:
            os.environ["TPU_DIST_FRAME_CRC"] = case["crc"]
        else:
            os.environ.pop("TPU_DIST_FRAME_CRC", None)
        # the CRC rows' wire emulation: both arms paced to one rate
        rate = case.get("wire_rate")
        if rate:
            netchaos.install(f"slow-drip:surface=tcp,rate={int(rate)}")
        else:
            netchaos.uninstall()
        algo = case.get("algo", "flat")
        os.environ["TPU_DIST_ALGO"] = "hier" if algo == "hier" else "flat"
        os.environ["TPU_DIST_SHM"] = (
            "auto" if algo in ("hier", "flat_shm") else "0")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for ci, case in enumerate(spec["cases"]):
        nbytes, op, path, iters = (case["bytes"], case["op"], case["path"],
                                   case["iters"])
        comm = case.get("comm")
        algo = case.get("algo", "flat")
        x = torch.from_numpy(np.random.default_rng(1000 + rank)
                             .standard_normal(nbytes // 4)
                             .astype(np.float32)).to(dev)
        if case.get("crc_paired"):
            reps = max(1, int(case.get("reps", 1)))
            apply_case_env(dict(case, crc="1"))
            run_op(op, x)  # warm-up: opens peer connections
            arm_t = {"1": [], "0": []}
            for rep in range(reps):
                order = ("1", "0") if rep % 2 == 0 else ("0", "1")
                for crc in order:
                    apply_case_env(dict(case, crc=crc))
                    store.barrier(world, tag=f"crcp/{ci}/{rep}/{crc}")
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        run_op(op, x)
                    arm_t[crc].append(time.perf_counter() - t0)
            pair_pcts = sorted((on - off) / off * 100.0
                               for on, off in zip(arm_t["1"], arm_t["0"]))
            mid = len(pair_pcts) // 2
            med = (pair_pcts[mid] if len(pair_pcts) % 2
                   else (pair_pcts[mid - 1] + pair_pcts[mid]) / 2)
            rows.append({
                "metric": "crc_paired", "op": op, "world": world,
                "bytes": nbytes, "iters": iters, "pairs": reps,
                "wire_mb_s": case.get("wire_rate", 0) // 1_000_000,
                "value": max(0.0, med), "unit": "%",
                "pair_pcts": pair_pcts, "crc": T.crc_impl(),
                "on_mb_s": nbytes * iters / min(arm_t["1"]) / 1e6,
                "off_mb_s": nbytes * iters / min(arm_t["0"]) / 1e6})
            continue
        apply_case_env(case)
        out = run_op(op, x)  # warm-up: opens peer connections
        if spec.get("check") and op == "all_reduce" \
                and case.get("crc") is None:
            # every rank takes the same branch: the reference collectives
            # stay rank-aligned
            if algo in ("hier", "flat_shm"):
                apply_case_env({"path": "dataplane"})
                flat = run_op(op, x)
                assert np.array_equal(out, flat), \
                    f"{algo} result != flat ring bitwise"
            else:
                os.environ.pop("TPU_DIST_COMM_DTYPE", None)
                os.environ["TPU_DIST_DP_THRESHOLD"] = str(1 << 60)
                ref = run_op(op, x)  # the store path's reference
                if comm:
                    err = float(np.max(np.abs(out - ref)))
                    bound = float(np.max(np.abs(ref))) * (
                        0.1 if comm.startswith("int8") else 0.02)
                    assert err <= bound, (comm, err, bound)
                else:
                    np.testing.assert_allclose(out, ref, rtol=2e-6,
                                               atol=1e-5)
            if comm or algo in ("hier", "flat_shm"):
                dig = hashlib.sha256(np.ascontiguousarray(out).tobytes()) \
                    .hexdigest().encode()
                store.set(f"bench/qdig/{ci}/{rank}", dig)
                store.barrier(world, tag=f"qdig{ci}")
                digs = {store.get(f"bench/qdig/{ci}/{r}")
                        for r in range(world)}
                assert len(digs) == 1, "rank-divergent collective result"
            apply_case_env(case)
        reps = max(1, int(case.get("reps", 1)))
        tag = f"{op}/{path}/{comm}/{algo}/{nbytes}"
        best, counters = None, None
        for rep in range(reps):
            store.barrier(world, tag=f"{tag}/r{rep}")
            E.reset_transport_counters()
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                run_op(op, x)
            dt = time.perf_counter() - t0
            c = E.transport_counters(reset=True).get(f"{op}/{path}")
            v = nbytes * iters / dt / 1e6
            if best is None or v > best:
                best, counters = v, c
        row = {"metric": "host_collective", "op": op, "path": path,
               "world": world, "bytes": nbytes, "iters": iters,
               "reps": reps, "comm": comm or "f32", "algo": algo,
               "value": best, "unit": "MB/s", "device": str(dev)}
        if counters:
            row["compression"] = counters["compression"]
        if path == "dataplane":
            dp = T.get_data_plane(store, rank, world)
            row["shm_active"] = bool(dp is not None
                                     and dp.shm_active((rank + 1) % world))
        rows.append(row)
    for key in ("TPU_DIST_COMM_DTYPE", "TPU_DIST_ALGO", "TPU_DIST_SHM",
                "TPU_DIST_FRAME_CRC"):
        os.environ.pop(key, None)
    netchaos.uninstall()
    if rank == 0:
        with open(os.environ["BENCH_OUT"], "w") as f:
            json.dump(rows, f)
    store.barrier(world, tag="bench-exit")
    T.close_data_plane()
    store.close()
    return 0


def _iters_for(nbytes: int, path: str) -> int:
    if path == "store":
        return 3 if nbytes >= (1 << 20) else 6
    return 6 if nbytes >= (1 << 20) else 12


def _reps_for(path: str, smoke: bool) -> int:
    if smoke or path == "store":
        return 1
    return 3


def cases_for(sizes, iters_override: int, smoke: bool):
    cases = [{"op": op, "path": path, "bytes": nbytes, "comm": None,
              "reps": _reps_for(path, smoke),
              "iters": iters_override or _iters_for(nbytes, path)}
             for op in _OPS for nbytes in sizes
             for path in ("store", "dataplane")]
    cases += [{"op": "all_reduce", "path": "dataplane", "bytes": nbytes,
               "comm": comm, "reps": _reps_for("dataplane", smoke),
               "iters": iters_override or _iters_for(nbytes, "dataplane")}
              for nbytes in sizes for comm in ("bfloat16", "int8_block256")]
    cases += [{"op": "all_reduce", "path": "dataplane", "bytes": nbytes,
               "comm": None, "algo": algo,
               "reps": _reps_for("dataplane", smoke),
               "iters": iters_override or _iters_for(nbytes, "dataplane")}
              for nbytes in sizes for algo in ("flat_shm", "hier")]
    cases += [{"op": "all_reduce", "path": "dataplane", "bytes": 8 << 20,
               "comm": None, "crc_paired": True, "reps": 3 if smoke else 7,
               "wire_rate": 150_000_000,
               "iters": iters_override or (1 if smoke else 2)}]
    return cases


def run_world(world: int, sizes, iters_override: int, check: bool,
              device: str) -> list:
    """Spawn one world of workers against a store this process hosts;
    returns rank 0's rows."""
    from ..dist.store import TCPStore

    nhosts = 2 if world >= 4 else 1
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
                   BENCH_SPEC=json.dumps({
                       "cases": cases_for(sizes, iters_override, check),
                       "check": check, "device": device}))
        for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_HOST_TRANSPORT"):
            env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "tpu_dist_torch.benchmarks.bench_host_collectives", "--worker"],
            env=dict(env, RANK=str(r),
                     TPU_DIST_HOST_ID=f"h{r * nhosts // world}"),
            cwd=_REPO) for r in range(world)]
        deadline = time.monotonic() + (600 if check else 1800)
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


def summaries(rows, worlds) -> list:
    """The JAX benchmark's summary lines, where their rows were measured."""
    out = []
    by_key = {(r["op"], r["path"], r.get("comm", "f32"),
               r.get("algo", "flat"), r["world"], r["bytes"]): r["value"]
              for r in rows if r.get("metric") == "host_collective"}
    crc_rows = {r["world"]: r for r in rows
                if r.get("metric") == "crc_paired"
                and r["bytes"] == 8 << 20}
    for world in worlds:
        r = crc_rows.get(world)
        if r:
            out.append({"metric": f"crc_overhead_8MiB_w{world}",
                        "value": r["value"], "unit": "%",
                        "threshold": 5.0, "pairs": r["pairs"],
                        "estimator": "paired-median, paced",
                        "wire_mb_s": r["wire_mb_s"],
                        "crc": r["crc"]})
    ring = by_key.get(("all_reduce", "dataplane", "f32", "flat", 4,
                       8 << 20))
    store_v = by_key.get(("all_reduce", "store", "f32", "flat", 4,
                          8 << 20))
    if ring and store_v:
        out.append({"metric": "ring_vs_store_speedup_8MiB_w4",
                    "value": ring / store_v, "unit": "x",
                    "threshold": 3.0})
    for world in worlds:
        ring_w = by_key.get(("all_reduce", "dataplane", "f32", "flat",
                             world, 8 << 20))
        quant_w = by_key.get(("all_reduce", "dataplane", "int8_block256",
                              "flat", world, 8 << 20))
        hier_w = by_key.get(("all_reduce", "dataplane", "f32", "hier",
                             world, 8 << 20))
        if ring_w and quant_w:
            out.append({"metric": f"quant_vs_f32_speedup_8MiB_w{world}",
                        "value": quant_w / ring_w, "unit": "x",
                        "threshold": 2.0})
        if ring_w and hier_w:
            out.append({"metric": f"hier_vs_flat_speedup_8MiB_w{world}",
                        "value": hier_w / ring_w, "unit": "x",
                        "threshold": 1.5})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="world 2, one 1 MiB payload, numeric and "
                         "byte-identity checks")
    ap.add_argument("--worlds", type=int, nargs="*", default=None)
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="payload bytes (default 64KiB/1MiB/8MiB)")
    ap.add_argument("--iters", type=int, default=0,
                    help="per-case iterations (0 = auto)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.worker:
        return _worker()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_host_collectives: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    worlds = args.worlds or ([2] if args.smoke else [2, 4])
    sizes = args.sizes or (_SMOKE_SIZES if args.smoke else _FULL_SIZES)
    all_rows = []
    for world in worlds:
        for row in run_world(world, sizes, args.iters, args.smoke,
                             args.device):
            if args.smoke:
                row["smoke"] = True
            print(json.dumps(row), flush=True)
            all_rows.append(row)
    for line in summaries(all_rows, worlds):
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
