"""Serving worker — the port's twin of ``examples/serve_lm.py``, the
model-rank half of ``python -m tpu_dist_torch.launch --serve``.

Builds a :class:`~tpu_dist_torch.models.TransformerLM` with weights from a
seeded generator (``--seed``: every incarnation serves the same model, so a
resubmitted greedy request reproduces its tokens), wraps it in the
continuous-batching :class:`~tpu_dist_torch.serve.SlotEngine` and
:class:`~tpu_dist_torch.serve.Scheduler`, and listens with a
:class:`~tpu_dist_torch.serve.Frontend` registered in the control-plane
store's backend registry, so the launcher's gateway finds it — across
supervised restarts too: SIGKILL this process under load, the launcher
starts it again, the fresh address lands under the same backend name, and
the gateway's next submit reaches the new incarnation::

    python -m tpu_dist_torch.launch --standalone --max_restarts=3 --serve \\
        -m tpu_dist_torch.examples.serve_lm --tiny --device cpu

The JAX example's flags, with ``--device cuda|cpu`` (default ``cuda``) in
place of ``--backend``; ``--tiny`` is its test preset (vocab 503, dim 64,
depth 2, heads 2, ``max_seq_len`` 192).  The worker publishes heartbeats
(:class:`~tpu_dist_torch.resilience.Heartbeat`, the scheduler's decode-step
count as progress), so the launcher's ``--heartbeat_timeout`` turns a
wedged decode loop into a named ``RankLostError`` and a restart.

``--exit-on-preempt`` is the serving half of the preemption protocol: on
SIGTERM the worker stops admitting, finishes every in-flight decode, and
exits ``PREEMPTED_EXIT_CODE`` (117).  ``--sharded``, ``--disagg``,
``--kv-wire``, ``--comm-dtype`` and the prefix-cache flags raise and name
ROADMAP A9.3 (multi-rank serving).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["build_parser", "build_model", "main", "TINY"]

# the JAX example's --tiny preset
TINY = dict(dim=64, depth=2, heads=2, vocab=503, max_seq_len=192)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=32768)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights' generator")
    p.add_argument("--slots", type=int, default=8,
                   help="KV-cache slots = max concurrent decodes")
    p.add_argument("--cache-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"])
    p.add_argument("--port", type=int, default=0,
                   help="frontend port (0 = ephemeral; the address is "
                        "published to the store either way)")
    p.add_argument("--batch-window", type=float, default=0.004,
                   help="admission coalescing deadline, seconds")
    p.add_argument("--tiny", action="store_true",
                   help="toy model preset for tests (vocab 503, dim 64, "
                        "depth 2, heads 2, max_seq_len 192)")
    p.add_argument("--sharded", action="store_true",
                   help="tensor-parallel decode (ROADMAP A9.3: raises)")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode (ROADMAP A9.3: "
                        "raises)")
    p.add_argument("--kv-wire", default=None,
                   help="disagg KV-transfer compression (ROADMAP A9.3: "
                        "raises)")
    p.add_argument("--prefix-block", type=int, default=16,
                   help="prefix-cache granularity (ROADMAP A9.3: raises "
                        "unless left at 16)")
    p.add_argument("--prefix-cache-mb", type=int, default=64,
                   help="prefix-cache cap (ROADMAP A9.3: raises unless "
                        "left at 64)")
    p.add_argument("--prefix-spill", default=None,
                   help="prefix-cache spill directory (ROADMAP A9.3: "
                        "raises)")
    p.add_argument("--comm-dtype", default=None,
                   help="sharded partial-sum compression (ROADMAP A9.3: "
                        "raises)")
    p.add_argument("--backend-name", default="default",
                   help="this backend's name in the gateway's registry "
                        "(replicas register distinct names; a restarted "
                        "incarnation re-registers the same one)")
    p.add_argument("--exit-on-preempt", action="store_true",
                   help="on SIGTERM: drain (finish in-flight, admit "
                        "nothing new) and exit PREEMPTED_EXIT_CODE (117)")
    p.add_argument("--run-seconds", type=float, default=0.0,
                   help="exit cleanly after N seconds (0 = run until "
                        "signalled; tests use it as a safety bound)")
    p.add_argument("--emulate-step-ms", type=float, default=0.0,
                   help="floor each decode iteration to N ms (a benchmark "
                        "and test knob)")
    p.add_argument("--pid-file", default=None,
                   help="write this process's pid here once serving (rank "
                        "r > 0 appends '.r{r}')")
    return p


def _refuse_multirank(args) -> None:
    for flag, on in (("--sharded", args.sharded), ("--disagg", args.disagg),
                     ("--kv-wire", args.kv_wire is not None),
                     ("--comm-dtype", args.comm_dtype is not None),
                     ("--prefix-block", args.prefix_block != 16),
                     ("--prefix-cache-mb", args.prefix_cache_mb != 64),
                     ("--prefix-spill", args.prefix_spill is not None)):
        if on:
            raise NotImplementedError(
                f"{flag}: multi-rank serving (sharded, disaggregated, the "
                f"prefix cache) comes with ROADMAP A9.3")


def build_model(args, device):
    """The served model: ``TransformerLM`` at the flags' (or ``--tiny``'s)
    shape, its weights drawn from a generator seeded with ``--seed``."""
    import torch

    from ..models import TransformerLM
    from ..nn.module import reset_parameters

    model = TransformerLM(args.vocab, dim=args.dim, depth=args.depth,
                          num_heads=args.heads, max_seq_len=args.max_seq_len,
                          device=device)
    reset_parameters(model,
                     torch.Generator(device=device).manual_seed(args.seed))
    return model


def _write_pid(args, rank: int) -> None:
    if args.pid_file:
        path = args.pid_file if rank == 0 else f"{args.pid_file}.r{rank}"
        with open(path, "w") as f:
            f.write(str(os.getpid()))


def _step_hook(args, hb):
    """Heartbeat progress, and the optional emulated per-iteration floor."""
    if args.emulate_step_ms <= 0:
        return hb.set_step

    def hook(step):
        hb.set_step(step)
        time.sleep(args.emulate_step_ms / 1e3)
    return hook


def _serve_loop(args, sched, frontend, hb, stop) -> int:
    """Rank 0's supervision loop: a clean exit at the deadline, the
    preemption drain, and the watch for a fatal engine error (exit nonzero
    for a supervised restart)."""
    from ..resilience import PREEMPTED_EXIT_CODE

    deadline = (time.monotonic() + args.run_seconds
                if args.run_seconds > 0 else None)
    while deadline is None or time.monotonic() < deadline:
        if sched.fatal is not None:
            print(f"[serve_lm] decode loop died: "
                  f"{type(sched.fatal).__name__}: {sched.fatal} — "
                  f"exiting for a supervised restart", flush=True)
            frontend.close()
            hb.stop()
            return 1
        if stop is not None and stop.requested:
            # stop admitting, finish the decodes in flight, then the
            # preemption exit code; os._exit skips a teardown that could
            # wait on peers
            drained = sched.drain(timeout=60.0)
            print(f"[serve_lm] preempted: drained={drained}; exiting "
                  f"{PREEMPTED_EXIT_CODE}", flush=True)
            hb.stop()
            sys.stdout.flush()
            os._exit(PREEMPTED_EXIT_CODE)
        time.sleep(0.25)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_multirank(args)
    if args.tiny:
        args.dim, args.depth, args.heads = (TINY["dim"], TINY["depth"],
                                            TINY["heads"])
        args.vocab, args.max_seq_len = TINY["vocab"], TINY["max_seq_len"]

    import torch

    from .. import checkpoint, dist, resilience, serve
    from ..ops._build import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    # world 1 (the common serving shape) skips the process group: the store
    # the frontend registers in is all it needs
    has_dist = world > 1 and "MASTER_ADDR" in os.environ
    device = "cpu" if args.device == "cpu" else None
    if has_dist:
        pg = dist.init_process_group(init_method="env://", device=device)
        rank, device = dist.get_rank(), pg.device
    else:
        rank = 0
        device = resolve_device(device)
        if device.type == "cuda":
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", 0))
                % torch.cuda.device_count())
            torch.cuda.set_device(device)
    store = serve.store_from_env()

    hb = resilience.Heartbeat(rank=rank)
    hb.start()
    stop = checkpoint.GracefulShutdown().__enter__() \
        if args.exit_on_preempt else None   # entered for the process life

    if rank != 0:
        # a model rank that does not serve: stay alive, beat, obey signals
        deadline = (time.monotonic() + args.run_seconds
                    if args.run_seconds > 0 else None)
        while deadline is None or time.monotonic() < deadline:
            if stop is not None and stop.requested:
                hb.stop()
                os._exit(resilience.PREEMPTED_EXIT_CODE)
            time.sleep(0.25)
        hb.stop()
        dist.destroy_process_group()
        return 0

    cache_dtype = getattr(torch, args.cache_dtype)
    model = build_model(args, device)
    engine = serve.SlotEngine(model, num_slots=args.slots,
                              max_len=args.max_seq_len,
                              cache_dtype=cache_dtype, device=device)
    sched = serve.Scheduler(engine, batch_window=args.batch_window,
                            step_hook=_step_hook(args, hb))
    frontend = serve.Frontend(sched, port=args.port, store=store,
                              backend_name=args.backend_name)
    print(f"[serve_lm] rank {rank} serving on {frontend.addr} "
          f"({args.slots} slots, max_seq_len {args.max_seq_len}, "
          f"{device})", flush=True)
    _write_pid(args, rank)
    try:
        rc = _serve_loop(args, sched, frontend, hb, stop)
    except KeyboardInterrupt:
        rc = 0
    finally:
        frontend.close()
        sched.close()
        hb.stop()
        if store is not None:
            store.close()
        if has_dist:
            dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
