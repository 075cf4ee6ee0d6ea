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
exits ``PREEMPTED_EXIT_CODE`` (117).

Two multi-rank shapes, as in the JAX example:

- ``--sharded`` — **tensor-parallel decode**: every rank the launcher
  spawned is one shard of a ``model-shard`` group
  (:mod:`tpu_dist_torch.serve.sharded`); rank 0 leads (engine, frontend,
  tokens to the gateway), ranks 1..W-1 run the
  :class:`~tpu_dist_torch.serve.ShardFollower` loop.  The combines ride the
  p2p data plane (``--comm-dtype int8_block256`` compresses them); no
  process group is created.  A dead shard fails the gang round, so the
  launcher's world restart IS the gang restart::

      python -m tpu_dist_torch.launch --standalone --nproc_per_node=2 \
          --max_restarts=3 --serve -m tpu_dist_torch.examples.serve_lm \
          --tiny --sharded

- ``--disagg`` — **disaggregated prefill/decode**
  (:mod:`tpu_dist_torch.serve.disagg`) under ``--roles prefill:P,decode:D``
  (prefill first): prefill ranks claim prompts off the shared channel,
  prefill them (through the prefix cache: ``--prefix-block``,
  ``--prefix-cache-mb``, ``--prefix-spill``) and ship the KV rows to the
  owning decode rank over the data plane (``--kv-wire int8_blockN``
  compresses them); decode ranks serve the gateway, one backend each::

      python -m tpu_dist_torch.launch --standalone --max_restarts=3 \
          --serve --roles prefill:1,decode:1 \
          -m tpu_dist_torch.examples.serve_lm --tiny --disagg

A rank runs on card ``LOCAL_RANK`` (role workers: ``RANK``) modulo the
card count.
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
                   help="tensor-parallel decode across the launcher's "
                        "whole world: rank 0 leads and serves, the others "
                        "follow; needs the control-plane store and "
                        "num_heads %% world == 0")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode under python -m "
                        "tpu_dist_torch.launch --serve --roles "
                        "prefill:P,decode:D")
    p.add_argument("--kv-wire", default=None,
                   help="disagg KV-transfer wire compression opt-in (e.g. "
                        "int8_block256) — lossy; default exact")
    p.add_argument("--prefix-block", type=int, default=16,
                   help="prefix-cache chain granularity in tokens")
    p.add_argument("--prefix-cache-mb", type=int, default=64,
                   help="prefix-cache resident byte cap, MiB (0 disables "
                        "the cache)")
    p.add_argument("--prefix-spill", default=None,
                   help="page cold prefix entries to this directory "
                        "instead of evicting them (the index persists "
                        "across restarts)")
    p.add_argument("--comm-dtype", default=None,
                   help="sharded partial-sum wire compression opt-in (e.g. "
                        "int8_block256); default exact float32")
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
                        "r > 0 appends '.r{r}'); --disagg ranks also keep "
                        "their kernel launch counts beside it ('.kernels')")
    return p


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


def _pid_path(args, rank: int) -> str:
    return args.pid_file if rank == 0 else f"{args.pid_file}.r{rank}"


def _write_pid(args, rank: int) -> None:
    if args.pid_file:
        with open(_pid_path(args, rank), "w") as f:
            f.write(str(os.getpid()))


def _publish_launch_counts(args, rank: int) -> None:
    """With ``--pid-file``: zero every kernel's launch count, then keep
    ``{"t": wall-clock time, "kernel_launches": {name: count}}`` in the pid
    file's path plus ``.kernels``, rewritten every 0.25 s by a daemon
    thread — so a caller reads the launches this rank made up to any
    moment it served, even after the rank is killed."""
    if not args.pid_file:
        return
    import json
    import threading

    from ..ops import KERNELS

    for k in KERNELS:
        k.launches = 0
    path = _pid_path(args, rank) + ".kernels"

    def loop():
        while True:
            rec = {"t": time.time(), "kernel_launches": {
                k.__name__: k.launches for k in KERNELS}}
            with open(path + ".tmp", "w") as f:
                json.dump(rec, f)
            os.replace(path + ".tmp", path)
            time.sleep(0.25)
    threading.Thread(target=loop, daemon=True,
                     name="tpu_dist_torch-launch-counts").start()


def _step_hook(args, hb):
    """Heartbeat progress, and the optional emulated per-iteration floor."""
    if args.emulate_step_ms <= 0:
        return hb.set_step

    def hook(step):
        hb.set_step(step)
        time.sleep(args.emulate_step_ms / 1e3)
    return hook


def _serve_loop(args, sched, frontend, hb, stop, engine=None) -> int:
    """Rank 0's supervision loop: a clean exit at the deadline, the
    preemption drain, and the watch for a fatal engine error (a shard
    peer's death surfaces as the scheduler's fatal PeerGoneError; exit
    nonzero for a supervised restart)."""
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
            if engine is not None:
                # a sharded leader releases its followers with the close
                # plan BEFORE exiting, so they turn their own SIGTERM into
                # 117 instead of dying on PeerGoneError
                engine.close()
            print(f"[serve_lm] preempted: drained={drained}; exiting "
                  f"{PREEMPTED_EXIT_CODE}", flush=True)
            hb.stop()
            sys.stdout.flush()
            os._exit(PREEMPTED_EXIT_CODE)
        time.sleep(0.25)
    return 0


def _card(device_arg: str, index: int):
    """This rank's device: the CPU when asked, else card ``index`` modulo
    the card count (set as the current one)."""
    import torch

    from ..ops._build import resolve_device

    if device_arg == "cpu":
        return torch.device("cpu")
    resolve_device(None)            # raises by name without a card
    device = torch.device("cuda", index % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _run_sharded(args, store, rank: int, world: int, cache_dtype,
                 device) -> int:
    """The tensor-parallel worker body: shard this rank's slice, join the
    shard group's data plane, and play leader (rank 0) or follower."""
    import importlib

    from .. import checkpoint, resilience, serve
    from ..collectives.transport import DataPlane, PeerGoneError
    from ..interop import jax_params
    from ..obs.recorder import get_recorder
    from ..roles.graph import Role, RoleGraph, map_key, set_current

    # the module, not the same-named function the package re-exports
    rendezvous = importlib.import_module("tpu_dist_torch.dist.rendezvous")

    if store is None:
        print("[serve_lm] --sharded needs the control-plane store (launch "
              "via python -m tpu_dist_torch.launch, or set "
              "TPU_DIST_STORE_ADDR)", file=sys.stderr, flush=True)
        return 2
    gen = rendezvous.generation()
    # role identity for diagnostics: obs dumps and the launcher's positions
    # table read "model-shard[r]" instead of a bare flat rank
    graph = RoleGraph([Role(serve.ROLE_MODEL_SHARD, world)])
    set_current(graph, serve.ROLE_MODEL_SHARD, rank)
    rec = get_recorder()
    if rec is not None:
        rec.rank, rec.world = rank, world
        rec.role, rec.role_rank = serve.ROLE_MODEL_SHARD, rank
    if rank == 0:
        try:
            store.set(map_key(gen), graph.to_json())
        except Exception:
            pass

    model = build_model(args, device)
    params = serve.shard_params(model, jax_params(model), rank, world)
    dp = DataPlane(store, rank, world, generation=gen)
    decoder = serve.ShardedDecoder(model, params, dp, rank, world,
                                   comm_dtype=args.comm_dtype)
    heads = model.block0.attn.num_heads
    del model, params           # the shard holds its own weights

    hb = resilience.Heartbeat(rank=rank)
    hb.start()
    stop = checkpoint.GracefulShutdown().__enter__() \
        if args.exit_on_preempt else None
    _write_pid(args, rank)
    try:
        if rank != 0:
            follower = serve.ShardFollower(decoder, num_slots=args.slots,
                                           max_len=args.max_seq_len,
                                           cache_dtype=cache_dtype)
            hb.set_step(0)
            budget = args.run_seconds if args.run_seconds > 0 else None
            try:
                cause = follower.run(deadline=budget, plan_timeout=20.0)
            except PeerGoneError as e:
                from ..utils.logging import log_event
                log_event("serve-shard-leader-gone", rank=rank,
                          error=repr(e))
                print(f"[serve_lm] shard follower {rank}: leader gone ({e})"
                      f" — exiting for a gang restart", flush=True)
                return 1
            print(f"[serve_lm] shard follower {rank} done ({cause}, "
                  f"{follower.decode_steps} decode steps)", flush=True)
            if stop is not None and stop.requested:
                # the group closed under a preemption notice: report the
                # preemption protocol's exit code, as the leader does
                hb.stop()
                sys.stdout.flush()
                os._exit(resilience.PREEMPTED_EXIT_CODE)
            return 0

        engine = serve.ShardedSlotEngine(decoder, num_slots=args.slots,
                                         max_len=args.max_seq_len,
                                         cache_dtype=cache_dtype)
        sched = serve.Scheduler(engine, batch_window=args.batch_window,
                                step_hook=_step_hook(args, hb))
        frontend = serve.Frontend(sched, port=args.port, store=store,
                                  backend_name=args.backend_name)
        print(f"[serve_lm] shard leader serving on {frontend.addr} (world "
              f"{world}, {args.slots} slots, heads/shard {heads // world}, "
              f"{device})", flush=True)
        try:
            return _serve_loop(args, sched, frontend, hb, stop,
                               engine=engine)
        finally:
            frontend.close()
            sched.close()
            engine.close()
    finally:
        hb.stop()
        dp.close()


def _run_disagg(args, cache_dtype, device) -> int:
    """The disaggregated worker body, run by every rank of ``--roles
    prefill:P,decode:D``: prefill ranks claim descriptors off ``prefill-q``,
    prefill (through the prefix cache when it hits) and ship KV rows and the
    first token to the owning decode rank; decode ranks run the
    :class:`~tpu_dist_torch.serve.DisaggSlotEngine` pool and serve the
    gateway, each under its own backend name."""
    import threading

    import torch

    from .. import checkpoint, resilience, serve
    from ..collectives.transport import DataPlane
    from ..roles.graph import parse_roles_spec
    from ..roles.runtime import init_role_graph

    if args.cache_dtype == "int8":
        print("[serve_lm] --disagg does not support --cache-dtype int8 (as "
              "in the JAX example); use --kv-wire int8_blockN to compress "
              "the WIRE instead", file=sys.stderr, flush=True)
        return 2
    spec = os.environ.get("TPU_DIST_ROLES")
    if not spec or not os.environ.get("TPU_DIST_STORE_ADDR"):
        print("[serve_lm] --disagg needs the role-graph launcher: python -m "
              "tpu_dist_torch.launch --standalone --serve --roles "
              "prefill:P,decode:D -m tpu_dist_torch.examples.serve_lm "
              "--disagg", file=sys.stderr, flush=True)
        return 2
    parsed = parse_roles_spec(spec)
    if [r.name for r in parsed.roles] != [serve.ROLE_PREFILL,
                                          serve.ROLE_DECODE]:
        print(f"[serve_lm] --disagg expects --roles prefill:P,decode:D "
              f"(prefill first, the canonical disagg_graph order), got "
              f"{spec!r}", file=sys.stderr, flush=True)
        return 2
    n_prefill, n_decode = (r.world for r in parsed.roles)
    graph = serve.disagg_graph(n_prefill, n_decode)
    ctx = init_role_graph(graph)          # checked against the published map
    rr = ctx.role_rank
    model = build_model(args, device)
    dp = DataPlane(ctx.store, ctx.rank, ctx.world, generation=ctx.generation)
    # both endpoints derive the shape contract from their OWN model, so a
    # drifted geometry is a named KVTransferError, not a silent reshape
    with torch.inference_mode():
        template = serve.kv_template(
            model.init_slot_cache(1, args.max_seq_len, dtype=cache_dtype))
    kv = serve.KVTransfer(dp, template, wire=args.kv_wire)
    if ctx.role == serve.ROLE_PREFILL:
        prefix = None
        if args.prefix_cache_mb > 0:
            prefix = serve.PrefixCache(
                block_tokens=args.prefix_block,
                capacity_bytes=args.prefix_cache_mb << 20,
                spill_dir=args.prefix_spill, device=device)
        worker = serve.PrefillWorker(
            model, kv, claim_ch=ctx.channel(serve.PREFILL_QUEUE, dp=False),
            env_chans={d: ctx.channel(serve.kv_channel(d), dp=False)
                       for d in range(n_decode)},
            rank=ctx.rank, max_len=args.max_seq_len, dtype=cache_dtype,
            prefix=prefix)
        # before the launch counts are zeroed and the pid file is written:
        # a caller that waits for the pid file sends no request whose
        # transfer deadline pays the first forward
        worker.warm()

    hb = resilience.Heartbeat(rank=ctx.rank)
    hb.start()
    stop = checkpoint.GracefulShutdown().__enter__() \
        if args.exit_on_preempt else None
    _publish_launch_counts(args, ctx.rank)
    _write_pid(args, ctx.rank)
    try:
        if ctx.role == serve.ROLE_PREFILL:
            cache_mb = ("off" if prefix is None
                        else f"{args.prefix_cache_mb}MiB")
            print(f"[serve_lm] prefill[{rr}] up (rank {ctx.rank}, prefix "
                  f"cache {cache_mb}, {device})", flush=True)
            wstop = threading.Event()
            t = threading.Thread(target=worker.run, args=(wstop,),
                                 daemon=True,
                                 name="tpu_dist_torch-prefill-worker")
            t.start()
            deadline = (time.monotonic() + args.run_seconds
                        if args.run_seconds > 0 else None)
            while deadline is None or time.monotonic() < deadline:
                if stop is not None and stop.requested:
                    # finish the claim in hand, then the preemption exit
                    # code — unclaimed descriptors stay on the queue
                    wstop.set()
                    t.join(30.0)
                    if prefix is not None:
                        prefix.close()
                    hb.stop()
                    sys.stdout.flush()
                    os._exit(resilience.PREEMPTED_EXIT_CODE)
                if not t.is_alive():
                    break               # the decode side closed the queue
                hb.set_step(worker.claims)
                time.sleep(0.25)
            wstop.set()
            t.join(10.0)
            if prefix is not None:
                prefix.close()
            print(f"[serve_lm] prefill[{rr}] done: {worker.stats()}",
                  flush=True)
            return 0

        # decode rank: owns requests end to end, serves the gateway
        backend = (args.backend_name if rr == 0
                   else f"{args.backend_name}-d{rr}")
        engine = serve.DisaggSlotEngine(
            model, kv,
            dispatch_ch=ctx.channel(serve.PREFILL_QUEUE, dp=False),
            arrive_ch=ctx.channel(serve.kv_channel(rr), dp=False),
            num_slots=args.slots, max_len=args.max_seq_len,
            cache_dtype=cache_dtype, rank=ctx.rank, role_rank=rr,
            device=device)
        sched = serve.DisaggScheduler(engine, batch_window=args.batch_window,
                                      step_hook=_step_hook(args, hb))
        frontend = serve.Frontend(sched, port=args.port, store=ctx.store,
                                  backend_name=backend)
        print(f"[serve_lm] decode[{rr}] serving on {frontend.addr} as "
              f"{backend!r} ({args.slots} slots, prefill pool {n_prefill}, "
              f"{device})", flush=True)
        try:
            return _serve_loop(args, sched, frontend, hb, stop)
        finally:
            frontend.close()
            sched.close()
            engine.close()
    finally:
        hb.stop()
        try:
            dp.close()
        except Exception:
            pass
        ctx.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tiny:
        args.dim, args.depth, args.heads = (TINY["dim"], TINY["depth"],
                                            TINY["heads"])
        args.vocab, args.max_seq_len = TINY["vocab"], TINY["max_seq_len"]

    import torch

    from .. import checkpoint, dist, resilience, serve

    cache_dtype = getattr(torch, args.cache_dtype)
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    rank = int(os.environ.get("RANK", "0") or 0)
    local = int(os.environ.get("LOCAL_RANK", rank) or 0)

    if args.disagg:
        # init_role_graph arms the chaos and obs hooks and connects the
        # store itself (role workers never rendezvous)
        return _run_disagg(args, cache_dtype, _card(args.device, local))
    if args.sharded:
        # a shard group creates no process group: its combines ride the
        # host data plane.  Arm the obs dump hooks (rendezvous would)
        from ..obs.hooks import install_from_env
        install_from_env()
        return _run_sharded(args, serve.store_from_env(), rank, world,
                            cache_dtype, _card(args.device, local))

    # world 1 (the common serving shape) skips the process group: the store
    # the frontend registers in is all it needs
    has_dist = world > 1 and "MASTER_ADDR" in os.environ
    device = "cpu" if args.device == "cpu" else None
    if has_dist:
        pg = dist.init_process_group(init_method="env://", device=device)
        rank, device = dist.get_rank(), pg.device
    else:
        rank = 0
        device = _card(args.device, local)
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
