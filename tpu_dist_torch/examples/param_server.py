"""Parameter-server training over a role graph — the port's twin of
``examples/param_server.py``.

1 **server** + N **workers** (default 4), round-synchronous: each round,
every worker pulls the freshest parameters off the versioned ``latest``
register (blocking for a strictly newer version: one gradient per worker
per version), computes a gradient on its own seeded batch and pushes it
over ONE bounded MPMC ``grads`` queue (N producers, one consumer; gradient
trees above ``TPU_DIST_DP_THRESHOLD`` ride the host data plane as CRC'd
frames, envelopes the sealed store path).  The server averages a round's
gradients, applies Adam and republishes: the version register is the round
barrier, so every applied gradient is exact-point::

    python -m tpu_dist_torch.launch --roles server:1,worker:4:solo \\
        --max_restarts=1 -m tpu_dist_torch.examples.param_server \\
        --out ./ps_out

Workers carry the ``solo`` restart policy: SIGKILL one mid-run
(``TPU_DIST_CHAOS="kill:rank=2,step=3"``) and the supervisor respawns that
rank alone in the same generation; the server's round waits for the
respawned worker's gradient and training resumes.  A dead server fails the
gang round instead.

The server and the workers compute on ``cuda:0`` unless given ``--device
cpu``: every process of the graph holds a context on the node's first
card, and none makes an NCCL communicator.  Gradients travel as host
arrays (a CUDA tensor is copied to the host at ``put``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

__all__ = ["build_graph", "main"]

GET_TIMEOUT = 120.0   # server's per-gradient budget
PUT_TIMEOUT = 60.0    # worker's backpressure budget


def build_graph(n_workers: int):
    # absolute: the launcher's --verify_graph pre-flight loads this file
    # by path
    from tpu_dist_torch.roles import ChannelSpec, Role, RoleGraph
    return RoleGraph(
        roles=[Role("server", 1),
               Role("worker", n_workers, restart="solo")],
        channels=[ChannelSpec("grads", src="worker", dst="server",
                              depth=16),
                  ChannelSpec("params", src="server", dst="worker",
                              kind="latest")])


def _device(args):
    from ..ops._build import resolve_device
    return resolve_device("cpu" if args.device == "cpu" else None)


def _model(dev):
    import torch

    from ..models import ConvNet
    from ..nn.module import reset_parameters
    model = ConvNet(device=dev)
    reset_parameters(model, torch.Generator(device=dev).manual_seed(0))
    return model


def run_server(ctx, args):
    import torch

    from .. import optim, resilience
    from ..ops import KERNELS
    from ..roles import ChannelTimeoutError

    dev = _device(args)
    params = {k: p.detach().clone()
              for k, p in _model(dev).named_parameters()}
    opt = optim.Adam(lr=args.lr)
    opt_state = opt.init(params)

    grads_ch = ctx.channel("grads")
    params_ch = ctx.channel("params")
    params_ch.put_latest({"params": params, "version": 0, "stop": False})

    losses = []
    seen = {}   # worker role_rank -> incarnations whose gradients landed
    version = 0
    t0 = None
    with resilience.Heartbeat(rank=ctx.rank) as hb:
        for step in range(args.max_steps):
            # one round: one gradient per worker, all at the current
            # version (the register is the barrier); a killed worker's
            # gradient arrives after its solo respawn
            round_grads, round_losses = [], []
            while len(round_grads) < args.workers:
                try:
                    msg = grads_ch.get(timeout=GET_TIMEOUT)
                except ChannelTimeoutError:
                    # a skipped hole (worker killed mid-put) or a quiet
                    # queue: a retry claims the next gradient
                    continue
                if int(msg["version"]) != version:
                    continue   # a pre-kill duplicate from an old round
                round_grads.append(msg["grads"])
                round_losses.append(float(msg["loss"]))
                seen.setdefault(str(msg["worker"]), set()).add(
                    int(msg["incarnation"]))
            if t0 is None:
                t0 = time.monotonic()
            g = {k: torch.stack([rg[k] for rg in round_grads]).to(dev)
                 .mean(0) for k in params}
            params, opt_state = opt.update(g, opt_state, params)
            version += 1
            losses.append(sum(round_losses) / len(round_losses))
            hb.set_step(step)
            params_ch.put_latest({"params": params, "version": version,
                                  "stop": False})
    dt = max(time.monotonic() - (t0 or time.monotonic()), 1e-9)
    # stop protocol: a terminal register version, then close the consumer
    # endpoint — a worker blocked in put() gets ChannelClosedError, one
    # polling the register sees stop=True; both exit 0
    params_ch.put_latest({"params": params, "version": version,
                          "stop": True})
    grads_ch.close()
    out = {"role": ctx.role, "pid": os.getpid(), "device": str(dev),
           "generation": ctx.generation, "steps": len(losses),
           "losses": losses,
           "steps_per_sec": (len(losses) - 1) / dt if len(losses) > 1
           else 0,
           "seen_incarnations": {k: sorted(v) for k, v in seen.items()},
           # the server's device work: no hand-written kernel, no NCCL
           "kernel_launches": {k.__name__: k.launches for k in KERNELS},
           "torch_distributed": torch.distributed.is_initialized(),
           "grads_stats": dict(grads_ch.stats)}
    with open(os.path.join(args.out, "server.json"), "w") as f:
        json.dump(out, f)
    print(f"[param_server] server done on {dev}: {len(losses)} rounds, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)


def run_worker(ctx, args):
    import numpy as np
    import torch

    from .. import resilience
    from ..data import synthetic_mnist_arrays
    from ..nn import functional as F
    from ..resilience import chaos as chaos_mod
    from ..roles import ChannelClosedError, ChannelTimeoutError

    incarnation = int(os.environ.get("TPU_DIST_ROLE_INCARNATION", "0") or 0)
    images, labels = synthetic_mnist_arrays(train=True, n=2048)
    images = (images.reshape(-1, 1, 28, 28).astype(np.float32) / 255.0)
    labels = labels.astype(np.int64)
    dev = _device(args)
    model = _model(dev)

    def fwd_bwd(p, x, y):
        ps = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        loss = F.cross_entropy(torch.func.functional_call(model, ps, (x,)),
                               y)
        grads = torch.autograd.grad(loss, list(ps.values()))
        return loss.detach(), dict(zip(ps, grads))

    grads_ch = ctx.channel("grads")
    params_ch = ctx.channel("params")
    out_path = os.path.join(
        args.out, f"worker{ctx.role_rank}_i{incarnation}.json")

    def write_out(pushed):
        with open(out_path, "w") as f:
            json.dump({"role": f"{ctx.role}[{ctx.role_rank}]",
                       "rank": ctx.rank, "pid": os.getpid(),
                       "incarnation": incarnation,
                       "generation": ctx.generation,
                       "pushed": pushed}, f)

    chaos = chaos_mod.active()
    # the first pull blocks for the server's first publication, each later
    # one for a strictly newer version: one gradient per (worker,
    # version).  A respawned incarnation reads the latest version and
    # joins the round in progress
    version = 0
    pushed, counter = 0, 0
    with resilience.Heartbeat(rank=ctx.rank) as hb:
        while True:
            try:
                snap, version = params_ch.get_latest(
                    version, timeout=GET_TIMEOUT)
            except ChannelTimeoutError:
                continue   # a quiet server (waiting on a respawn)
            if snap.get("stop"):
                break
            rng = np.random.default_rng(
                50_000 * (ctx.role_rank + 1) + counter)
            idx = rng.integers(0, len(images), size=args.batch_size)
            x = torch.from_numpy(images[idx]).to(dev)
            y = torch.from_numpy(labels[idx]).to(dev)
            loss, g = fwd_bwd(snap["params"], x, y)
            try:
                grads_ch.put({"grads": g, "loss": float(loss),
                              "version": int(snap.get("version", 0)),
                              "worker": ctx.role_rank, "counter": counter,
                              "incarnation": incarnation},
                             timeout=PUT_TIMEOUT)
            except ChannelClosedError:
                break   # the server finished and closed its side
            pushed += 1
            counter += 1
            hb.set_step(counter)
            if pushed == 1 or pushed % 16 == 0:
                write_out(pushed)
            # the first incarnation's fault only (chaos counts per process)
            if chaos is not None and incarnation == 0:
                chaos.on_step(counter)
            if args.worker_throttle > 0:
                time.sleep(args.worker_throttle)
    write_out(pushed)
    print(f"[param_server] worker[{ctx.role_rank}] i{incarnation} done: "
          f"{pushed} gradients", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4,
                    help="worker count — must match the --roles spec")
    ap.add_argument("--max-steps", type=int, default=100,
                    help="server-side update count")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--worker-throttle", type=float, default=0.0,
                    help="seconds a worker sleeps between gradients")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="every rank's device (cuda:0 unless cpu)")
    ap.add_argument("--out", type=str, default="./param_server_out")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from ..roles import init_role_graph
    with init_role_graph(build_graph(args.workers)) as ctx:
        print(f"[param_server] rank {ctx.rank} = {ctx.role}"
              f"[{ctx.role_rank}] (generation {ctx.generation})",
              flush=True)
        if ctx.role == "server":
            run_server(ctx, args)
        else:
            run_worker(ctx, args)


if __name__ == "__main__":
    main()
