"""Sequence-parallel GPT-2-small training over a host's cards, against one.

Runs ``examples/train_lm.py --parallel sp`` on ``--nproc`` ranks of this
host (one card each, NCCL; a (data 2 × seq nproc/2) mesh for an even
``nproc``), once a mode (ring, Ulysses), and the same global batch at world
1 without ``sequence_axis`` (``--parallel dp``), all from the same seed and
data stream: GPT-2-small (vocab 32768, dim 768, depth 12, heads 12), global
batch 2 × 8192 tokens, bf16 over float32 masters.  Prints one JSON line a
run (losses, the first step's seconds, then ms a step and tokens/s over
the later steps) and a last line with each mode's
largest relative loss difference against world 1, and the card's name and
power limit.  Every step of the three runs trains on the same global batch
with the same gradient, so their losses agree to bf16 round-off.

    python -m tpu_dist_torch.benchmarks.sp_lm [--nproc 4] [--steps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import tempfile

from ..launch import spawn

__all__ = ["run", "ARGV"]

ARGV = ["--seq-len", "8192", "--batch-size", "2", "--dim", "768",
        "--depth", "12", "--heads", "12", "--vocab", "32768",
        "--compute-dtype", "bfloat16", "--lr", "2.0", "--log-every", "1000"]


def _summary(r: dict) -> dict:
    """Losses and the steady state: the steps after the first (whose
    one-time set-up, NCCL's communicators among it, is reported apart)."""
    steps = len(r["losses"]) - 1
    return {"losses": r["losses"],
            "first_step_seconds": r["first_step_seconds"],
            "step_ms": r["loop_seconds"] / steps * 1e3,
            "tokens_per_s": r["batch"] * r["seq_len"] * steps
            / r["loop_seconds"], "batch": r["batch"], "seq_len": r["seq_len"]}


def _rank(rank: int, nproc: int, port: int, argv, out: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nproc), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    from ..examples import train_lm
    r = train_lm.train(train_lm.parse_args(argv))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(_summary(r), f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(nproc: int = 4, steps: int = 10, device: str = "cuda",
        argv=ARGV) -> dict:
    """The three runs; returns ``{"world1": ..., "ring": ..., "ulysses":
    ..., "max_loss_rel_diff": {mode: x}}``."""
    if steps < 2:
        raise ValueError(f"steps={steps}: the steady state needs 2 or more")
    from ..examples import train_lm
    if device == "cuda":  # the kernels' build stays out of the timed loops
        from ..ops import _build
        _build.build_all()
    common = list(argv) + ["--device", device, "--steps", str(steps)]
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(var, None)
    res = {"world1": _summary(train_lm.train(train_lm.parse_args(
        common + ["--parallel", "dp"])))}
    print(json.dumps({"run": "world1", **res["world1"]}), flush=True)
    for mode in ("ring", "ulysses"):
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "rank0.json")
            spawn(_rank, args=(nproc, _free_port(),
                               common + ["--parallel", "sp", "--sp-mode",
                                         mode], out), nprocs=nproc)
            with open(out) as f:
                res[mode] = json.load(f)
        print(json.dumps({"run": mode, "nproc": nproc, **res[mode]}),
              flush=True)
    ref = res["world1"]["losses"]
    res["max_loss_rel_diff"] = {
        mode: max(abs(a - b) / abs(b) for a, b in zip(res[mode]["losses"],
                                                     ref))
        for mode in ("ring", "ulysses")}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    res = run(args.nproc, args.steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"max_loss_rel_diff": res["max_loss_rel_diff"],
                      "nvidia_smi": smi[0] if smi else None}), flush=True)


if __name__ == "__main__":
    main()
