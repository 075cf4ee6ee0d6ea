"""The training steps of two checkouts of the repo on one card, in turns.

Runs the dense (``transformer_lm``) and MoE (``moe_lm``) benchmarks — or
those named by ``--benches``, among them ``resnet18``: the ResNet-18 step
of :mod:`.profile_step` (batch 1024, bf16; its unprofiled step time and
its kernel launches a step) — of this checkout ("change") and of ``OTHER``
("parent": for example the parent commit unpacked with ``git archive`` into
a git-ignored directory), each run in its own process, in turns (parent,
change, change, parent) for each round, so that both trees meet the same
card and host.  Prints one JSON line per run, then the step times per tree
with their medians and the card's name and power limit.  Two versions are
compared only inside one such call.

    python -m tpu_dist_torch.benchmarks.compare_trees OTHER [--rounds 2] \\
        [--benches transformer_lm,moe_lm,resnet18]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# bench → (module and arguments, the result's step-time key)
_BENCHES = {
    "transformer_lm": (["tpu_dist_torch.benchmarks.transformer_lm"],
                       "step_ms"),
    # the dropless step (a checkout whose twin has no --dispatch ignores
    # the flag and runs it too)
    "moe_lm": (["tpu_dist_torch.benchmarks.moe_lm", "--dispatch",
                "dropless"], "step_ms"),
    "resnet18": (["tpu_dist_torch.benchmarks.profile_step", "--model",
                  "resnet18", "--steps", "5"], "unprofiled_ms_per_step"),
}
_HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file


def _run(tree: Path, bench: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", *_BENCHES[bench][0]],
        cwd=tree, capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{bench} in {tree} failed (rc {proc.returncode}):"
                           f"\n{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def compare(other, rounds: int = 2,
            benches=("transformer_lm", "moe_lm")) -> dict:
    trees = {"parent": Path(other).resolve(), "change": _HERE}
    steps = {b: {t: [] for t in trees} for b in benches}
    for _ in range(rounds):
        for bench in benches:
            for label in ("parent", "change", "change", "parent"):
                res = _run(trees[label], bench)
                step_ms = res[_BENCHES[bench][1]]
                steps[bench][label].append(step_ms)
                print(json.dumps({
                    "tree": label, "bench": bench, "step_ms": step_ms,
                    **{k: res[k] for k in ("value", "peak_mem_bytes",
                                           "kernel_launches_per_step",
                                           "kernel_ms_per_step",
                                           "idle_share") if k in res}}),
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
    ap.add_argument("--benches", default="transformer_lm,moe_lm",
                    help=f"comma-separated, of {sorted(_BENCHES)}")
    args = ap.parse_args()
    benches = args.benches.split(",")
    unknown = set(benches) - set(_BENCHES)
    if unknown:
        ap.error(f"unknown benches {sorted(unknown)}")
    compare(args.other, args.rounds, benches)


if __name__ == "__main__":
    main()
