"""The training steps of two checkouts of the repo on one card, in turns.

Runs the dense (:mod:`.transformer_lm`) and MoE (:mod:`.moe_lm`) benchmarks
of this checkout ("change") and of ``OTHER`` ("parent": for example the
parent commit unpacked with ``git archive`` into a git-ignored directory),
each run in its own process, in turns (parent, change, change, parent) for
each round, so that both trees meet the same card and host.  Prints one JSON
line per run, then the step times per tree with their medians and the
card's name and power limit.  Two versions are compared only inside one
such call.

    python -m tpu_dist_torch.benchmarks.compare_trees OTHER [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

_BENCHES = ("transformer_lm", "moe_lm")
_HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file


def _run(tree: Path, bench: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", f"tpu_dist_torch.benchmarks.{bench}"],
        cwd=tree, capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{bench} in {tree} failed (rc {proc.returncode}):"
                           f"\n{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def compare(other, rounds: int = 2) -> dict:
    trees = {"parent": Path(other).resolve(), "change": _HERE}
    steps = {b: {t: [] for t in trees} for b in _BENCHES}
    for _ in range(rounds):
        for bench in _BENCHES:
            for label in ("parent", "change", "change", "parent"):
                res = _run(trees[label], bench)
                steps[bench][label].append(res["step_ms"])
                print(json.dumps({"tree": label, "bench": bench,
                                  "step_ms": res["step_ms"],
                                  "tokens_per_s_per_gpu": res["value"],
                                  "peak_mem_bytes": res["peak_mem_bytes"]}),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"step_ms": steps,
           "median_step_ms": {b: {t: statistics.median(v)
                                  for t, v in s.items()}
                              for b, s in steps.items()},
           "nvidia_smi": smi.splitlines()[0] if smi else None}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout (the parent)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    compare(args.other, args.rounds)


if __name__ == "__main__":
    main()
