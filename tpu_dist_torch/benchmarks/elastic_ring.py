"""The ``elastic_train`` twin on the host ring at world n, under the port's
launcher: a kill and resume, a shrink, and the collective watchdog.

Every run has ``TPU_DIST_HOST_TRANSPORT=dataplane`` and
``TPU_DIST_COMM_DTYPE=int8_block256``, so the gradient reduce-scatter and
the parameter gather ride the host data plane's quantized ring
(``--zero``; ``python -m tpu_dist_torch.launch --standalone
--nproc_per_node=n``, one card a rank with ``cuda``):

- **resume**: a save every 10 steps, ``kill:rank=0,step=20`` with
  ``--max_restarts=1``, beside an uninterrupted run: the resumed steps'
  losses and the final parameters' sha256 must equal the uninterrupted
  run's on every rank; and a run on the group's backend
  (``TPU_DIST_HOST_TRANSPORT`` unset) must end elsewhere (the int8 wire is
  lossy), which shows the ring carried the sync;
- **shrink**: ``--elastic_world=n-1:n`` with ``shrink:rank=n-1,step=20``:
  the world goes n -> n-1 and resumes from the step-20 save through
  ``TrainState``'s reshard (every rank of one node sees the shared
  checkpoint root, so the fragments come from disk);
- **watchdog**: ``--coll_timeout=10`` with ``stall:rank=1,step=3`` (rank 1
  sleeps 60 s): another rank must raise ``CollectiveTimeoutError`` naming
  the stalled hop, within the budget and well before the stall ends.

One JSON line a scenario::

    python -m tpu_dist_torch.benchmarks.elastic_ring [--world 4]
    python -m tpu_dist_torch.benchmarks.elastic_ring --world 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT = 600


def _launch(out: str, name: str, world: int, device: str, extra_launch=(),
            extra=(), chaos=None, ring: bool = True, max_steps: int = 40):
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PYTHONWARNINGS="ignore")
    for var in ("TPU_DIST_CHAOS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "TPU_DIST_STORE_ADDR",
                "TPU_DIST_HOST_TRANSPORT", "TPU_DIST_COMM_DTYPE"):
        env.pop(var, None)
    if ring:
        env.update(TPU_DIST_HOST_TRANSPORT="dataplane",
                   TPU_DIST_COMM_DTYPE="int8_block256")
    if chaos:
        env["TPU_DIST_CHAOS"] = chaos
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         f"--nproc_per_node={world}", "--restart_backoff=0", *extra_launch,
         "-m", "tpu_dist_torch.examples.elastic_train", "--synthetic",
         "--zero", "--max-steps", str(max_steps), "--save-every", "10",
         "--batch-size", "100", "--device", device,
         "--ckpt-root", os.path.join(out, f"ck_{name}"),
         "--record", os.path.join(out, f"{name}.jsonl"), *extra],
        cwd=out, env=env, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, t0


def _finish(proc, t0):
    try:
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, err, time.time() - t0


def _records(out: str, name: str) -> list:
    try:
        with open(os.path.join(out, f"{name}.jsonl")) as f:
            return [json.loads(line) for line in f]
    except OSError:
        return []


def run(world: int, device: str) -> list:
    out = tempfile.mkdtemp(prefix="elastic_ring_",
                           dir=os.environ.get("TMPDIR"))
    last = world - 1
    runs = {
        "plain": dict(extra_launch=["--max_restarts=1"]),
        "killed": dict(extra_launch=["--max_restarts=1"],
                       chaos="kill:rank=0,step=20"),
        "backend": dict(extra_launch=["--max_restarts=1"], ring=False),
        "shrink": dict(extra_launch=[f"--elastic_world={world - 1}:{world}",
                                     "--max_restarts=0"],
                       chaos=f"shrink:rank={last},step=20"),
    }
    started = {n: _launch(out, n, world, device, **kw)
               for n, kw in runs.items()}
    done = {n: _finish(*p) for n, p in started.items()}
    rec = {n: _records(out, n) for n in runs}
    rows = []

    want = {(r["rank"], r["step"]): r["loss"] for r in rec["plain"]
            if "step" in r}
    g1 = [r for r in rec["killed"] if "step" in r and r["gen"] == 1]
    finals = {n: {r["final"] for r in rec[n] if "final" in r} for n in runs}
    resumed = sorted({r["step"] for r in g1})
    rows.append({
        "metric": "elastic_ring_resume", "world": world, "device": device,
        "rc": {n: done[n][0] for n in ("plain", "killed", "backend")},
        "resumed_steps": resumed[:1] + resumed[-1:],
        "losses_bitwise": bool(g1) and all(
            want.get((r["rank"], r["step"])) == r["loss"] for r in g1),
        "final_sha256_equal": len(finals["plain"] | finals["killed"]) == 1,
        "ring_differs_from_backend": bool(finals["backend"])
        and finals["backend"] != finals["plain"],
        "restarted_once": "restart 1/1" in done["killed"][1],
        "wall_s": {n: done[n][2] for n in ("plain", "killed", "backend")}})
    rc, err, wall = done["shrink"]
    ranks_by_gen: dict = {}
    for r in rec["shrink"]:
        if "step" in r:
            ranks_by_gen.setdefault(r["gen"], set()).add(r["rank"])
    rows.append({
        "metric": "elastic_ring_shrink", "world": world, "device": device,
        "rc": rc, "world_change": f"elastic world change: {world} -> "
        f"{world - 1}" in err, "reshard_plan": "reshard plan" in err,
        "resumed_at_smaller_world": any(
            r.get("gen", 0) > 0 for r in rec["shrink"] if "step" in r),
        "finals": len(finals["shrink"]),
        "ranks_by_generation": {g: sorted(v) for g, v in
                                sorted(ranks_by_gen.items())},
        "wall_s": wall,
        "stderr_tail": None if rc == 0 else err[-2000:]})

    # the watchdog: rank 1 stalls for 60 s at step 3
    proc, t0 = _launch(out, "stall", world, device,
                       extra_launch=["--coll_timeout=10", "--max_restarts=0"],
                       chaos="stall:rank=1,step=3,delay=60", max_steps=10)
    rc, err, wall = _finish(proc, t0)
    stall = [r for r in _records(out, "stall") if r.get("step") == 3]
    named = "CollectiveTimeoutError" in err and "stalled hop" in err
    line = next((ln for ln in err.splitlines() if "stalled hop" in ln), "")
    rows.append({
        "metric": "elastic_ring_watchdog", "world": world, "device": device,
        "rc": rc, "named_error": named, "error_line": line[:400],
        "seconds_from_step3_to_exit": (t0 + wall - min(r["t"] for r in stall)
                                       if stall else None),
        "wall_s": wall})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.world:
            print(f"elastic_ring: world {args.world} needs as many cards "
                  f"(use --device cpu)", file=sys.stderr)
            return 2
    for row in run(args.world, args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
