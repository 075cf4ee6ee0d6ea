"""Role-graph channel throughput and the actor→learner step rate — the
port's twin of ``benchmarks/bench_roles.py``.

- **Channel throughput** (MB/s by path, payload and depth): a
  single-producer/single-consumer queue channel moving float32 payloads
  through an in-process rig — the ``store`` path (sealed pickled payloads
  through the control-plane server) and the ``dataplane`` path (raw CRC'd
  frames over rank-to-rank sockets, the envelope on the store).  Depth 1
  serializes producer and consumer, depth 8 pipelines them.  Payloads are
  tensors on ``--device`` (``cuda``: the producer's ``put`` copies each to
  the host, as a port user's would be; ``get`` hands back CPU tensors).
- **Actor→learner step rate**: the port's
  :mod:`~tpu_dist_torch.examples.actor_learner` graph spawned through the
  role launcher (the learner on ``--device``), reporting the learner's
  steady-state steps/s.

One JSON line a cell::

    {"metric": "roles_channel_mb_s", "path": "dataplane",
     "payload_bytes": 8388608, "depth": 8, "value": 312.4, "unit": "MB/s"}

``--smoke`` runs one depth per (path, payload) of the small ladder with a
payload-equality check and no spawned graph; exit code 1 when a payload
came back different.

    python -m tpu_dist_torch.benchmarks.bench_roles [--no-e2e]
    python -m tpu_dist_torch.benchmarks.bench_roles --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_SMOKE_SIZES = (64 * 1024, 1 << 20)
_FULL_SIZES = (64 * 1024, 1 << 20, 8 << 20)
_DEPTHS = (1, 8)


def _channel_pair(store, name, depth, dps=None):
    from ..roles import Channel, ChannelSpec
    spec = ChannelSpec(name, src="prod", dst="cons", depth=depth)
    # dp=False pins the store path: an in-process rig's lazy singleton
    # belongs to one rank only
    prod = Channel(spec, store, rank=0, role="prod", src_span=[0],
                   dst_span=[1], generation=0, graph_world=2,
                   dp=dps[0] if dps else False)
    cons = Channel(spec, store, rank=1, role="cons", src_span=[0],
                   dst_span=[1], generation=0, graph_world=2,
                   dp=dps[1] if dps else False)
    return prod, cons


def _throughput_cell(store, path, size, depth, n_msgs, check, dps, dev):
    import torch
    name = f"bench-{path}-{size}-{depth}"
    prod, cons = _channel_pair(store, name, depth,
                               dps if path == "dataplane" else None)
    payload = torch.randn(max(1, size // 4), generator=torch.Generator()
                          .manual_seed(7)).to(dev)
    errs = []

    def producer():
        try:
            for _ in range(n_msgs):
                prod.put(payload, timeout=120)
        except Exception as e:  # surfaced below: a hang here is the bug
            errs.append(e)

    t = threading.Thread(target=producer)
    t0 = time.perf_counter()
    t.start()
    got = [cons.get(timeout=120) for _ in range(n_msgs)]
    dt = time.perf_counter() - t0
    t.join(timeout=30)
    if errs:
        raise errs[0]
    row = {"metric": "roles_channel_mb_s", "path": path,
           "payload_bytes": size, "depth": depth, "msgs": n_msgs,
           "device": str(dev),
           "value": payload.numel() * 4 * n_msgs / dt / 1e6, "unit": "MB/s",
           "dp_msgs": cons.stats["dp_msgs"]}
    if check:
        want = payload.cpu()
        row["payload_equal"] = all(torch.equal(g, want) for g in got)
        if path == "dataplane" and size >= 64 * 1024:
            row["payload_equal"] &= cons.stats["dp_msgs"] == n_msgs
    return row


def bench_channels(smoke: bool, device: str, check=None):
    """The channel cells, one row each, plus the best dataplane MB/s at
    the largest payload; ``check`` (default: ``smoke``) adds each cell's
    payload-equality verdict."""
    import torch

    from ..collectives.transport import DataPlane
    from ..dist.store import TCPStore

    prev_thr = os.environ.get("TPU_DIST_DP_THRESHOLD")
    os.environ["TPU_DIST_DP_THRESHOLD"] = str(16 * 1024)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    sizes = _SMOKE_SIZES if smoke else _FULL_SIZES
    n_msgs = 8 if smoke else 24
    check = smoke if check is None else check
    rows = []
    store = TCPStore(is_master=True)
    dps = [DataPlane(store, 0, 2), DataPlane(store, 1, 2)]
    try:
        for path in ("store", "dataplane"):
            for size in sizes:
                for depth in _DEPTHS:
                    if smoke and depth != _DEPTHS[-1]:
                        continue  # smoke: one depth per (path, size)
                    rows.append(_throughput_cell(store, path, size, depth,
                                                 n_msgs, check, dps, dev))
                    print(json.dumps(rows[-1]), flush=True)
    finally:
        for dp in dps:
            dp.close()
        store.close()
        if prev_thr is None:
            os.environ.pop("TPU_DIST_DP_THRESHOLD", None)
        else:
            os.environ["TPU_DIST_DP_THRESHOLD"] = prev_thr
    best = max((r["value"] for r in rows
                if r["path"] == "dataplane"
                and r["payload_bytes"] == sizes[-1]), default=0.0)
    rows.append({"metric": "roles_channel_dp_best_mb_s",
                 "payload_bytes": sizes[-1], "value": best, "unit": "MB/s"})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def bench_e2e(actors: int, steps: int, device: str) -> dict:
    """Spawn the actor/learner twin through the role launcher and read
    the learner's steady-state step rate."""
    out = tempfile.mkdtemp(prefix="bench_roles_")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--roles", f"learner:1,actor:{actors}:solo",
         "-m", "tpu_dist_torch.examples.actor_learner",
         "--actors", str(actors), "--max-steps", str(steps),
         "--device", device, "--out", out],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        return {"metric": "roles_actor_learner_steps_per_sec",
                "error": (r.stderr or r.stdout)[-500:]}
    with open(os.path.join(out, "learner.json")) as f:
        learner = json.load(f)
    return {"metric": "roles_actor_learner_steps_per_sec",
            "actors": actors, "steps": learner["steps"],
            "device": learner["device"],
            "value": learner["steps_per_sec"], "unit": "steps/s",
            "dp_msgs": learner["traj_stats"]["dp_msgs"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small cells and the payload-equality check, no "
                         "spawned graph")
    ap.add_argument("--actors", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_roles: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    rows = bench_channels(args.smoke, args.device)
    if not args.smoke and not args.no_e2e:
        rows.append(bench_e2e(args.actors, args.steps, args.device))
        print(json.dumps(rows[-1]), flush=True)
    if args.smoke and not all(r.get("payload_equal", True) for r in rows):
        print("bench_roles: a payload came back different",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
