"""A hung rank on the group's backend, as the flight recorder sees it.

``python -m tpu_dist_torch.launch --nproc_per_node=WORLD --flight-recorder
--heartbeat_timeout=5`` on a worker of this module: every rank joins the
default group (``env://``: NCCL on the card, a rank a card; gloo on the
CPU), and a step is one model's gradients (on the card the dense
GPT-2-small cell, one seeded row a rank; on the CPU the MNIST ConvNet at
batch 64) averaged by ``Bucketer().all_reduce`` on the group's backend,
inside ``resilience.TrainState``.  ``TPU_DIST_CHAOS`` stalls rank 1 at
step 3.  A rank blocked inside an NCCL call runs no Python signal handler
until the call returns, so its SIGUSR1 dump may never land: the launcher's
positions table, from the store tails the heartbeat posts, is then the
record of where it was.

Prints one JSON line: the launcher's exit code and wall time, its
``RankLostError`` line and positions table, which ranks left a dump and
why, each dump's last collective, and ``diagnose``'s verdict.  It records;
it gates nothing.

    python -m tpu_dist_torch.benchmarks.obs_stall --world 4
    python -m tpu_dist_torch.benchmarks.obs_stall --world 2 --device cpu
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
STALL = "stall:rank=1,step=3"
STEPS = 10


def _worker(device: str) -> int:
    import numpy as np
    import torch

    from .. import dist, resilience
    from ..collectives import Bucketer

    pg = dist.init_process_group(init_method="env://",
                                 device="cpu" if device == "cpu" else None)
    try:
        if device != "cpu":
            from .host_sync import dense_cell, rank_grads
            ddp, state = dense_cell(pg, pg.device, batch=1)

            def grads_of(step):
                return rank_grads(ddp, state, pg.rank, batch=1)
        else:
            from ..data import synthetic_mnist_arrays
            from ..models import ConvNet
            from ..nn import functional as F
            from ..nn.module import reset_parameters
            net = ConvNet(device=pg.device)
            reset_parameters(net, torch.Generator(device=pg.device)
                             .manual_seed(0))
            params = dict(net.named_parameters())
            images, labels = synthetic_mnist_arrays(train=True, n=512)
            x = torch.from_numpy((images[:64].reshape(-1, 1, 28, 28) / 255.0)
                                 .astype(np.float32)).to(pg.device)
            y = torch.from_numpy(labels[:64].astype(np.int64)).to(pg.device)

            def grads_of(step):
                loss = F.cross_entropy(torch.func.functional_call(
                    net, params, (x,)), y)
                return dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))

        bucketer = Bucketer()
        with resilience.TrainState(os.environ["STALL_CKPT"] + str(pg.rank),
                                   save_every=0, heartbeat_interval=0.2,
                                   monitor=False) as ts:
            st, start = ts.resume({"x": np.zeros(1)})
            for step in range(start, STEPS):
                g = grads_of(step)
                bucketer.all_reduce(g, op="avg", group=pg).wait_all(600)
                if pg.device.type == "cuda":
                    torch.cuda.synchronize()
                ts.end_step(st, step)
    finally:
        dist.destroy_process_group()
    return 0


def run(world: int, device: str, hb_timeout: float = 5.0) -> dict:
    """Launch the stalled world; returns what the launcher, the dumps and
    ``diagnose`` show."""
    from .. import obs
    out = tempfile.mkdtemp(prefix="obs_stall_")
    obs_dir = os.path.join(out, "obs")
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TPU_DIST_CHAOS=STALL,
               TPU_DIST_OBS_DIR=obs_dir, OMP_NUM_THREADS="1",
               STALL_CKPT=os.path.join(out, "ck"))
    for k in ("TPU_DIST_OBS", "TPU_DIST_HOST_TRANSPORT", "RANK",
              "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "TPU_DIST_STORE_ADDR"):
        env.pop(k, None)
    if device == "cpu":
        # keep gloo on its backend, as NCCL keeps a card's group
        env["TPU_DIST_HOST_TRANSPORT"] = "mesh"
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch",
         f"--nproc_per_node={world}", "--master_port=0",
         f"--heartbeat_timeout={hb_timeout}", "--flight-recorder",
         "-m", "tpu_dist_torch.benchmarks.obs_stall", "--worker",
         "--device", device],
        cwd=out, env=env, capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    dumps = obs.read_dumps(obs_dir)
    lines = r.stderr.splitlines()
    table = []
    for i, line in enumerate(lines):
        if "last known positions" in line:
            table = [ln.strip() for ln in lines[i + 1:i + 1 + world]]
    lost = [ln for ln in lines if "RankLostError" in ln]

    def last_coll(d):
        cs = [e for e in d["events"] if e.get("kind") == "collective"]
        return ({k: cs[-1].get(k) for k in ("coll", "op", "outcome",
                                             "path", "site")}
                if cs else None)

    diag = obs.diagnose(dumps) if dumps else {"verdict": "no-dumps"}
    return {"metric": "obs_stall", "world": world, "device": device,
            "model": "dense" if device != "cpu" else "convnet",
            "chaos": STALL, "launcher_rc": r.returncode,
            "launcher_wall_s": wall, "rank_lost": lost[:1],
            "positions_table": table,
            "dumps": {d["rank"]: {"reason": d["reason"],
                                  "events": len(d["events"]),
                                  "last_collective": last_coll(d)}
                      for d in dumps},
            "diagnosis": {k: diag.get(k) for k in (
                "verdict", "straggler", "straggler_last_coll",
                "stuck_coll", "stuck_op", "stuck_site", "waiting_ranks",
                "missing_ranks")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.device)
    import torch
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < args.world):
        print(f"obs_stall: world {args.world} needs {args.world} CUDA "
              f"devices (use --device cpu)", file=sys.stderr)
        return 2
    print(json.dumps(run(args.world, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
