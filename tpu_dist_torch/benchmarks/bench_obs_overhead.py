"""The armed flight recorder's overhead on the host-collective benchmark —
the port's twin of ``benchmarks/bench_obs_overhead.py``.

Runs the :mod:`~tpu_dist_torch.benchmarks.bench_host_collectives` twin
(worker processes wired as a port user's eager collectives are) with the
recorder disarmed and armed (``TPU_DIST_OBS=1``), and reports the MB/s
drop per case (op, path, wire, algorithm, world, bytes) and its median,
the headline: robust to one noisy case.  Each attempt folds into a
per-case best of N (the largest MB/s of each arm: noise only ever lowers a
measurement), the arm order alternating by attempt.

``--smoke``: world 2, 1 MiB, all-reduce and all-gather, and the JAX
benchmark's bound: exit 1 when the median overhead stays at 5% or more on
every attempt (a timing gate, so it is run on the card, not in the
tier-1 tests).  One JSON line an attempt::

    {"metric": "obs_overhead_pct", "value": 1.7, "unit": "%",
     "threshold": 5.0, "attempt": 0, "per_case": {...}}

    python -m tpu_dist_torch.benchmarks.bench_obs_overhead [--worlds 2 4]
    python -m tpu_dist_torch.benchmarks.bench_obs_overhead --device cpu \\
        --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

_SMOKE_SIZES = [1 << 20]


def _measure(armed: bool, worlds, sizes, iters: int, device: str,
             ops=None) -> dict:
    """One benchmark pass; returns ``{case key: MB/s}``.  The arm is
    exported through the environment the workers inherit."""
    from . import bench_host_collectives as B

    saved = {k: os.environ.pop(k, None)
             for k in ("TPU_DIST_OBS", "TPU_DIST_OBS_DIR")}
    saved_ops = B._OPS
    if ops:
        B._OPS = tuple(ops)
    obs_dir = None
    if armed:
        obs_dir = tempfile.mkdtemp(prefix="tpu_dist_obs_bench_")
        os.environ["TPU_DIST_OBS"] = "1"
        os.environ["TPU_DIST_OBS_DIR"] = obs_dir
    try:
        rows = []
        for world in worlds:
            rows.extend(B.run_world(world, list(sizes), iters, False,
                                    device))
        return {(r["op"], r["path"], r.get("comm") or "f32",
                 r.get("algo", "flat"), r["world"], r["bytes"]): r["value"]
                for r in rows if r.get("metric") == "host_collective"}
    finally:
        B._OPS = saved_ops
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if obs_dir is not None:
            shutil.rmtree(obs_dir, ignore_errors=True)  # the workers' dumps


def _merge_best(best: dict, fresh: dict) -> None:
    for key, value in fresh.items():
        if value and value > best.get(key, 0.0):
            best[key] = value


def overhead(best_base: dict, best_armed: dict):
    """``(median %, {case: %})``: the armed arm's MB/s drop per case."""
    per_case, pcts = {}, []
    for key, disarmed in sorted(best_base.items()):
        armed = best_armed.get(key)
        if not armed or not disarmed:
            continue
        pct = (disarmed - armed) / disarmed * 100.0
        per_case["/".join(str(p) for p in key)] = pct
        pcts.append(pct)
    return (statistics.median(pcts) if pcts else 0.0), per_case


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="world 2, 1 MiB, the median overhead under 5%%")
    ap.add_argument("--worlds", type=int, nargs="*", default=None)
    ap.add_argument("--sizes", type=int, nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=0,
                    help="per-case iterations (0 = 40 for smoke, the "
                         "benchmark's own otherwise)")
    ap.add_argument("--attempts", type=int, default=4,
                    help="smoke attempts before the bound counts as missed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_obs_overhead: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    worlds = args.worlds or [2]
    sizes = args.sizes or (_SMOKE_SIZES if args.smoke
                           else [64 << 10, 1 << 20])
    # a 1 MiB collective takes milliseconds: 40 iterations keep one
    # scheduler hiccup from swinging a case by half
    iters = args.iters or (40 if args.smoke else 0)
    ops = ("all_reduce", "all_gather") if args.smoke else None
    attempts = args.attempts if args.smoke else 1
    best_base: dict = {}
    best_armed: dict = {}
    med = None
    for attempt in range(attempts):
        arms = (False, True) if attempt % 2 == 0 else (True, False)
        for armed in arms:
            _merge_best(best_armed if armed else best_base,
                        _measure(armed, worlds, sizes, iters, args.device,
                                 ops))
        med, per_case = overhead(best_base, best_armed)
        print(json.dumps({"metric": "obs_overhead_pct", "value": med,
                          "unit": "%", "threshold": 5.0, "attempt": attempt,
                          "smoke": args.smoke, "worlds": worlds,
                          "device": args.device, "per_case": per_case}),
              flush=True)
        if not args.smoke or med < 5.0:
            break
    if args.smoke and (med is None or med >= 5.0):
        print(json.dumps({"metric": "obs_overhead_pct", "verdict": "FAIL",
                          "value": med, "threshold": 5.0}))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
