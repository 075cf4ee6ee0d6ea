"""Actor/learner training over a role graph — the port's twin of
``examples/actor_learner.py``.

N **actor** ranks generate batches ("trajectories") on the host and push
them over a bounded channel; ONE **learner** rank consumes them, trains the
MNIST ConvNet with bucketed gradient averaging over its role's group, and
republishes its parameters every ``--publish-every`` steps over a "latest"
register the actors poll.  Run it under the role-graph launcher::

    python -m tpu_dist_torch.launch --roles learner:1,actor:4:solo \\
        --max_restarts=1 -m tpu_dist_torch.examples.actor_learner \\
        --out ./al_out

The actors carry the ``solo`` restart policy: kill one mid-run
(``TPU_DIST_CHAOS="kill:rank=2,step=3"``) and the supervisor respawns
exactly that rank in the same generation — the learner never stops, and
the restarted actor's next ``put`` lands on the same named channel,
because the queue cursor lives in the store.  A dead learner fails the
gang round instead.

The learner runs on ``cuda:0`` unless given ``--device cpu`` (every rank
of the graph shares the node's first card; no NCCL communicator is made).
The trajectory channel has one consumer, so image batches above
``TPU_DIST_DP_THRESHOLD`` ride the host data plane as CRC'd frames while
the envelope rides the sealed store path.  Batches are NCHW float32, the
port's layout (the JAX example's are NHWC).
"""

from __future__ import annotations

import argparse
import json
import os
import time

__all__ = ["build_graph", "main"]

GET_TIMEOUT = 120.0   # learner's per-batch budget
PUT_TIMEOUT = 60.0    # actor's backpressure budget


def build_graph(n_actors: int):
    # absolute: the launcher's --verify_graph pre-flight loads this file
    # by path
    from tpu_dist_torch.roles import ChannelSpec, Role, RoleGraph
    return RoleGraph(
        roles=[Role("learner", 1),
               Role("actor", n_actors, restart="solo")],
        channels=[ChannelSpec("traj", src="actor", dst="learner", depth=16),
                  ChannelSpec("params", src="learner", dst="actor",
                              kind="latest")])


def _learner_device(args):
    from ..ops._build import resolve_device
    return resolve_device("cpu" if args.device == "cpu" else None)


def run_learner(ctx, args):
    import torch

    from .. import collectives as C
    from .. import optim, resilience
    from ..models import ConvNet
    from ..nn import functional as F
    from ..nn.module import reset_parameters
    from ..ops import KERNELS
    from ..roles import ChannelTimeoutError

    dev = _learner_device(args)
    model = ConvNet(device=dev)
    reset_parameters(model, torch.Generator(device=dev).manual_seed(0))
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = optim.Adam(lr=args.lr)
    opt_state = opt.init(params)
    bucketer = C.Bucketer()   # bucketed gradient averaging (25 MiB buckets)

    def fwd_bwd(p, x, y):
        ps = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = F.cross_entropy(torch.func.functional_call(model, ps, (x,)),
                               y)
        grads = torch.autograd.grad(loss, list(ps.values()))
        return loss.detach(), dict(zip(ps, grads))

    traj_ch = ctx.channel("traj")
    params_ch = ctx.channel("params")
    params_ch.put_latest({"params": params, "step": 0, "stop": False})

    losses = []
    seen = {}   # actor role_rank -> incarnations whose batches arrived
    t0 = None
    with resilience.Heartbeat(rank=ctx.rank) as hb:
        for step in range(args.max_steps):
            while True:
                try:
                    msg = traj_ch.get(timeout=GET_TIMEOUT)
                    break
                except ChannelTimeoutError:
                    # a skipped hole (actor killed mid-put) or a quiet
                    # queue: a retry claims the next message.  Actors dead
                    # for good raise ChannelPeerGoneError out of the loop
                    continue
            if t0 is None:
                t0 = time.monotonic()  # steady-state rate: skip warm-up
            x = msg["x"].to(dev, non_blocking=True)
            y = msg["y"].to(dev, non_blocking=True).long()
            loss, g = fwd_bwd(params, x, y)
            # the bucketed average over the learner's intra-role group
            # (world 1 here; the same line serves a multi-rank learner)
            work = bucketer.all_reduce(g, op="avg", group=ctx.group)
            loss_now = float(loss)       # read back under the sync
            g = work.wait_all(timeout=300)
            params, opt_state = opt.update(g, opt_state, params)
            losses.append(loss_now)
            seen.setdefault(str(msg["actor"]), set()).add(
                int(msg["incarnation"]))
            hb.set_step(step)
            if (step + 1) % args.publish_every == 0:
                params_ch.put_latest({"params": params, "step": step + 1,
                                      "stop": False})
    dt = max(time.monotonic() - (t0 or time.monotonic()), 1e-9)
    # stop protocol: a terminal register version, then close the consumer
    # endpoint — an actor blocked in put() gets ChannelClosedError, one
    # polling the register sees stop=True; both exit 0
    params_ch.put_latest({"params": params, "step": args.max_steps,
                          "stop": True})
    traj_ch.close()
    out = {"role": ctx.role, "pid": os.getpid(), "device": str(dev),
           "generation": ctx.generation, "steps": len(losses),
           "losses": losses,
           "steps_per_sec": (len(losses) - 1) / dt if len(losses) > 1 else 0,
           "seen_incarnations": {k: sorted(v) for k, v in seen.items()},
           # the learner's device work: no hand-written kernel, no NCCL
           "kernel_launches": {k.__name__: k.launches for k in KERNELS},
           "torch_distributed": torch.distributed.is_initialized(),
           "traj_stats": dict(traj_ch.stats)}
    with open(os.path.join(args.out, "learner.json"), "w") as f:
        json.dump(out, f)
    print(f"[actor_learner] learner done on {dev}: {len(losses)} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)


def run_actor(ctx, args):
    import numpy as np

    from .. import resilience
    from ..data import synthetic_mnist_arrays
    from ..resilience import chaos as chaos_mod
    from ..roles import ChannelClosedError

    incarnation = int(os.environ.get("TPU_DIST_ROLE_INCARNATION", "0") or 0)
    images, labels = synthetic_mnist_arrays(train=True, n=2048)
    images = (images.reshape(-1, 1, 28, 28).astype(np.float32) / 255.0)
    labels = labels.astype(np.int32)

    traj_ch = ctx.channel("traj")
    params_ch = ctx.channel("params")
    out_path = os.path.join(
        args.out, f"actor{ctx.role_rank}_i{incarnation}.json")

    def write_out(produced):
        with open(out_path, "w") as f:
            json.dump({"role": f"{ctx.role}[{ctx.role_rank}]",
                       "rank": ctx.rank, "pid": os.getpid(),
                       "incarnation": incarnation,
                       "generation": ctx.generation,
                       "produced": produced}, f)

    chaos = chaos_mod.active()
    version, produced, counter = 0, 0, 0
    with resilience.Heartbeat(rank=ctx.rank) as hb:
        while True:
            got = params_ch.poll_latest(version)
            if got is not None:
                snap, version = got
                if snap.get("stop"):
                    break
            # a "trajectory": one seeded batch of the shared synthetic set
            # (deterministic per (actor, counter), so reruns replay)
            rng = np.random.default_rng(
                10_000 * (ctx.role_rank + 1) + counter)
            idx = rng.integers(0, len(images), size=args.batch_size)
            try:
                traj_ch.put({"x": images[idx], "y": labels[idx],
                             "actor": ctx.role_rank, "counter": counter,
                             "incarnation": incarnation},
                            timeout=PUT_TIMEOUT)
            except ChannelClosedError:
                break   # the learner finished and closed its side
            produced += 1
            counter += 1
            hb.set_step(counter)
            if produced == 1 or produced % 16 == 0:
                # early and often: a respawned incarnation proves "the
                # channel resumed by name" with its first accepted put
                write_out(produced)
            # the fault is the first incarnation's only: chaos counts per
            # process, and a respawn replaying the kill would burn the
            # solo budget in a loop
            if chaos is not None and incarnation == 0:
                chaos.on_step(counter)
            if args.actor_throttle > 0:
                time.sleep(args.actor_throttle)
    write_out(produced)
    print(f"[actor_learner] actor[{ctx.role_rank}] i{incarnation} done: "
          f"{produced} batches", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--actors", type=int, default=4,
                    help="actor count — must match the --roles spec")
    ap.add_argument("--max-steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--publish-every", type=int, default=8,
                    help="learner steps between parameter publications")
    ap.add_argument("--actor-throttle", type=float, default=0.0,
                    help="seconds an actor sleeps between batches")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the learner's device (cuda:0 unless cpu)")
    ap.add_argument("--out", type=str, default="./actor_learner_out")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from ..roles import init_role_graph
    with init_role_graph(build_graph(args.actors)) as ctx:
        print(f"[actor_learner] rank {ctx.rank} = {ctx.role}"
              f"[{ctx.role_rank}] (generation {ctx.generation})",
              flush=True)
        if ctx.role == "learner":
            run_learner(ctx, args)
        else:
            run_actor(ctx, args)


if __name__ == "__main__":
    main()
