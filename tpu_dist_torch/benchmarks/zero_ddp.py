"""The dense GPT-2-small cell under the DDP at world N: replicated against
ZeRO-1 (``shard_optimizer=True``), one process a card over NCCL.

Each mode builds the ``transformer_lm`` cell (vocab 32768, dim 768, depth
12, 12 heads, T = 2048, bf16 over float32 masters, fused loss) with
``AdamW(lr=1e-4)``, takes ``--batch`` rows a rank of the same global batch
(``--batch 2`` at world 4 is world 1's batch of 8), runs 3 steps and times
5 more (host clock, ending in a synchronize).  Rank 0 prints one row a
mode: step ms, peak
memory, the optimizer state's bytes on a card, and the sha256 of the
parameters after the 3 steps — equal between the modes when ZeRO-1's
parameters are the replicated ones bit for bit::

    python -m tpu_dist_torch.benchmarks.zero_ddp --world 4 --batch 2
    python -m tpu_dist_torch.benchmarks.zero_ddp --device cpu --tiny

``--tiny`` shrinks the model (for a CPU rehearsal over gloo).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

__all__ = ["run_mode", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_TINY = dict(seq_len=16, dim=32, depth=2, heads=2, vocab=64)
_KEPT, _TIMED = 3, 5


def _digest(params) -> str:
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_mode(pg, batch: int, tiny: bool = False, **ddp_kw) -> dict:
    """One mode over ``pg``: the kept steps' losses, parameters (``params``,
    host copies; ``params0`` before the first step) and their digest, the
    timed steps' ms (host clock, ending in a synchronize), peak memory and
    optimizer-state bytes."""
    from .. import optim
    from .transformer_lm import build
    cuda = pg.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(pg.device)
    ddp, x, y = build(batch=batch, group=pg, device=pg.device,
                      optimizer=optim.AdamW(lr=1e-4),
                      **(_TINY if tiny else {}), **ddp_kw)
    state = ddp.init(seed=0)
    # host copies: the card's peak is the mode's own
    params0 = {k: v.detach().cpu() for k, v in state.params.items()}
    losses = []
    for _ in range(_KEPT):
        state, m = ddp.train_step(state, x, y)
        losses.append(float(m["loss"]))
    kept = {k: v.detach().cpu() for k, v in state.params.items()}
    digest = _digest(kept)
    if cuda:
        torch.cuda.synchronize(pg.device)
    t0 = time.perf_counter()
    for _ in range(_TIMED):
        state, m = ddp.train_step(state, x, y)
    float(m["loss"])
    if cuda:
        torch.cuda.synchronize(pg.device)
    step_ms = (time.perf_counter() - t0) / _TIMED * 1e3
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in _leaves(state.opt_state))
    return {"step_ms": step_ms, "losses": losses, "params_sha256": digest,
            "params0": params0, "params": kept,
            "opt_state_bytes_per_card": opt_bytes,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(pg.device)
                               if cuda else None)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _worker() -> int:
    from .. import dist
    spec = json.loads(os.environ["ZERO_DDP_SPEC"])
    pg = dist.init_process_group(init_method="env://",
                                 device=spec["device"] or None)
    rows = []
    try:
        for mode, kw in (("replicated", {}),
                         ("zero1", {"shard_optimizer": True})):
            row = run_mode(pg, spec["batch"], spec["tiny"], **kw)
            del row["params0"], row["params"]
            row.update(mode=mode, world=pg.size(), batch_per_rank=spec[
                "batch"], device=(torch.cuda.get_device_name(pg.device)
                                  if pg.device.type == "cuda" else "cpu"))
            rows.append(row)
        if pg.rank == 0:
            with open(os.environ["ZERO_DDP_OUT"], "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2,
                    help="rows a rank (2 at world 4: world 1's batch)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return _worker()
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"zero_ddp: world {args.world} needs as many CUDA devices "
              f"(use --device cpu)", file=sys.stderr)
        return 2
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as tmp:
        out = tmp.name
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(args.world),
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
               ZERO_DDP_OUT=out, ZERO_DDP_SPEC=json.dumps({
                   "batch": args.batch, "tiny": args.tiny,
                   "device": "cpu" if args.device == "cpu" else ""}))
    for k in ("TPU_DIST_STORE_ADDR", "TPU_DIST_RESTART_COUNT"):
        env.pop(k, None)
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.benchmarks.zero_ddp",
             "--worker"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            cwd=_REPO) for r in range(args.world)]
        deadline = time.monotonic() + 900
        rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
               for p in procs]
        if any(rcs):
            print(f"zero_ddp: workers failed: rcs={rcs}", file=sys.stderr)
            return 1
        with open(out) as f:
            rows = json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(out)
    for row in rows:
        print(json.dumps(row), flush=True)
    same = rows[0]["params_sha256"] == rows[1]["params_sha256"]
    print(json.dumps({"metric": "zero1_equals_replicated_bitwise",
                      "value": same, "world": args.world}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
