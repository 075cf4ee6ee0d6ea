"""Benchmark: host-path pipeline parallelism — bubble fraction and rate (the
port's twin of ``benchmarks/bench_pipeline.py``).

Runs the :mod:`tpu_dist_torch.pipeline` stage runtime in an in-process rig
(one thread a stage, its own model instance, real store-backed channels,
each stage with a data plane of its own so that activations ride its p2p
frames: the JAX bench pins the store path, whose one server thread cannot
carry a full-width cell's activations in a smoke run's time) and measures,
per (schedule, microbatch count) cell:

- **tokens/s** over the steady-state steps (step 0 warms up and is
  excluded);
- **bubble fraction**, both the schedule's closed form ``(S-1)/(M+S-1)``
  and the *measured* idle share ``1 - busy/(S * wall)``, where ``busy``
  sums the stages' forward/backward compute time (the card synchronized
  around each) — channel claims, waits and Python overhead all land in the
  measured bubble;
- **stash watermarks** per stage: GPipe stashes all M microbatch inputs on
  every stage, 1F1B caps stage *i* at ``min(S-i, M)``.

Output: one JSON row per cell to stdout::

    {"metric": "pipeline_host_tokens_per_sec", "schedule": "1f1b",
     "stages": 2, "microbatches": 8, "value": 1234.5, "unit": "tokens/s",
     "bubble_theoretical": 0.111, "bubble_measured": 0.31, ...}

``--smoke`` is the parity gate: one small cell per schedule plus the serial
oracle, asserting GPipe == 1F1B == serial loss bit for bit AND 1F1B's
stage-0 stash peak strictly below GPipe's.  Nothing is written to disk.
Runs on the card unless given ``--device cpu``::

    python -m tpu_dist_torch.benchmarks.bench_pipeline --smoke
    python -m tpu_dist_torch.benchmarks.bench_pipeline --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

__all__ = ["run_cell", "serial_run", "smoke", "main"]

SMALL = dict(vocab=31, dim=16, depth=4, heads=2, seq=12)


def _batch(step: int, batch: int, dims: dict):
    import numpy as np
    rng = np.random.default_rng(1_000_003 * step + 1)
    x = rng.integers(0, dims["vocab"], size=(batch, dims["seq"]),
                     dtype=np.int32)
    y = rng.integers(0, dims["vocab"], size=(batch, dims["seq"]),
                     dtype=np.int32)
    return x, y


def _model(dims: dict, device):
    from ..models import TransformerLM
    return TransformerLM(vocab_size=dims["vocab"], dim=dims["dim"],
                         depth=dims["depth"], num_heads=dims["heads"],
                         max_seq_len=dims["seq"], device=device)


def _timed(fn, busy, stage, device):
    """``fn`` with its compute time (the card caught up) added to
    ``busy[stage]`` — the numerator of the measured busy fraction."""
    if fn is None:
        return None
    import torch

    def f(*a):
        t0 = time.perf_counter()
        r = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        busy[stage] += time.perf_counter() - t0
        return r
    return f


def run_cell(schedule: str, num_stages: int, num_microbatches: int,
             steps: int, batch: int, compress=None, dims=None,
             device=None, loss_fn=None) -> dict:
    """One threaded pipeline run: ``{"losses", "row", "params"}`` (each
    step's mean loss, the rate/bubble row, every stage's final
    parameters)."""
    import torch

    from .. import nn, optim
    from ..collectives.transport import DataPlane
    from ..dist.store import TCPStore
    from ..ops._build import resolve_device
    from ..pipeline import (PipelineStage, act_channel, bubble_fraction,
                            build_pipeline_graph, build_stage_fns,
                            grad_channel, partition_model,
                            split_microbatches, stage_role)
    from ..pipeline.partition import flat_params
    from ..pipeline.train import _mean_loss, _seeded_tree
    from ..roles.channel import Channel

    dims = dict(SMALL, **(dims or {}))
    device = resolve_device(device)
    S, M = num_stages, num_microbatches
    graph = build_pipeline_graph(S, num_microbatches=M, schedule=schedule)
    specs = {c.name: c for c in graph.channels}
    store = TCPStore(is_master=True)
    planes = [DataPlane(store, i, S) for i in range(S)]
    busy = [0.0] * S
    stash_bytes = [0] * S
    stash_count = [0] * S
    losses: list = []
    final: list = [None] * S
    errs: list = []
    state = {"round": 0, "t0": time.perf_counter()}

    def _round():
        # runs while every party is parked in wait(): the busy reset and
        # the clock start cannot race the next step's compute
        state["round"] += 1
        if state["round"] == 1:  # step 0 was the warm-up step
            for j in range(S):
                busy[j] = 0.0
            state["t0"] = time.perf_counter()

    barrier = threading.Barrier(S + 1, action=_round)

    def stage_main(i: int):
        try:
            # a model instance a thread: functional_call binds tensors
            # into the module it runs
            model = _model(dims, device)
            part = partition_model(model, S)
            fns = build_stage_fns(part, i, loss_fn or nn.CrossEntropyLoss())
            fns.fwd = _timed(fns.fwd, busy, i, device)
            fns.fwd_loss = _timed(fns.fwd_loss, busy, i, device)
            fns.bwd = _timed(fns.bwd, busy, i, device)
            fns.bwd_loss = _timed(fns.bwd_loss, busy, i, device)
            params = part.stage_params(_seeded_tree(model, 0), i)
            opt = optim.SGD(lr=1e-2)
            opt_state = opt.init(flat_params(params))

            def chan(name):
                spec = specs[name]
                s = int(spec.src[len("stage"):])
                d = int(spec.dst[len("stage"):])
                return Channel(spec, store, rank=i, role=stage_role(i),
                               src_span=[s], dst_span=[d], generation=0,
                               graph_world=S, dp=planes[i])

            stage = PipelineStage(
                fns, i, S, M, schedule=schedule,
                in_act=chan(act_channel(i - 1)) if i > 0 else None,
                out_act=chan(act_channel(i)) if i < S - 1 else None,
                in_grad=chan(grad_channel(i)) if i < S - 1 else None,
                out_grad=chan(grad_channel(i - 1)) if i > 0 else None,
                compress=compress, device=device)
            for step in range(steps):
                x, y = _batch(step, batch, dims)
                res = stage.run_step(
                    params,
                    x_mb=split_microbatches(torch.from_numpy(x).to(device),
                                            M) if i == 0 else None,
                    y_mb=split_microbatches(torch.from_numpy(y).to(device),
                                            M) if i == S - 1 else None)
                opt.update(flat_params(res.grads), opt_state,
                           flat_params(params))
                stash_bytes[i] = max(stash_bytes[i], res.stash_peak_bytes)
                stash_count[i] = max(stash_count[i], res.stash_peak_count)
                if i == S - 1:
                    losses.append(_mean_loss(res.losses))
                # barrier a step: step 0 warms up, the timed window starts
                # at the first barrier after it
                barrier.wait()
            stage.close()
            final[i] = params
        except Exception as e:
            errs.append(e)
            try:
                barrier.abort()
            except Exception:
                pass

    threads = [threading.Thread(target=stage_main, args=(i,),
                                name=f"bench-stage{i}")
               for i in range(S)]
    for t in threads:
        t.start()
    try:
        for _ in range(steps):
            barrier.wait()
    except threading.BrokenBarrierError:
        pass
    wall = time.perf_counter() - state["t0"]
    for t in threads:
        t.join(timeout=600)
    for plane in planes:
        plane.close()
    store.close()
    if errs:
        raise errs[0]
    timed_steps = steps - 1
    tokens = batch * dims["seq"] * timed_steps
    row = {"metric": "pipeline_host_tokens_per_sec",
           "schedule": schedule, "stages": S, "microbatches": M,
           "value": tokens / wall, "unit": "tokens/s",
           "device": str(device),
           "bubble_theoretical": bubble_fraction(S, M),
           "bubble_measured": 1.0 - sum(busy) / (S * wall),
           "stash_peak_bytes": stash_bytes,
           "stash_peak_count": stash_count}
    if compress:
        row["compress"] = compress
    return {"losses": losses, "row": row, "params": final}


def serial_run(num_stages: int, num_microbatches: int, steps: int,
               batch: int, dims=None, device=None, loss_fn=None) -> dict:
    """The serial oracle's ``{"losses", "params"}`` on the same batches."""
    import torch

    from .. import nn, optim
    from ..ops._build import resolve_device
    from ..pipeline import SerialPipelineRunner

    dims = dict(SMALL, **(dims or {}))
    device = resolve_device(device)
    runner = SerialPipelineRunner(_model(dims, device), optim.SGD(lr=1e-2),
                                  loss_fn or nn.CrossEntropyLoss(),
                                  num_stages, num_microbatches)
    out = []
    for step in range(steps):
        x, y = _batch(step, batch, dims)
        out.append(runner.step(torch.from_numpy(x), torch.from_numpy(y)))
    return {"losses": out, "params": runner.params}


def smoke(device=None) -> int:
    """The parity gate: GPipe == 1F1B == serial oracle bit for bit, and the
    1F1B stash watermark strictly below GPipe's on stage 0."""
    S, M, steps, batch = 2, 4, 3, 8
    serial = serial_run(S, M, steps, batch, device=device)["losses"]
    gp = run_cell("gpipe", S, M, steps, batch, device=device)
    f1 = run_cell("1f1b", S, M, steps, batch, device=device)
    print(json.dumps(gp["row"]), flush=True)
    print(json.dumps(f1["row"]), flush=True)
    assert gp["losses"] == serial, (gp["losses"], serial)
    assert f1["losses"] == serial, (f1["losses"], serial)
    f1_peak, gp_peak = (f1["row"]["stash_peak_bytes"][0],
                        gp["row"]["stash_peak_bytes"][0])
    assert f1_peak < gp_peak, (f"1F1B stage-0 stash {f1_peak} not below "
                               f"GPipe's {gp_peak}")
    assert gp["row"]["stash_peak_count"][0] == M
    assert f1["row"]["stash_peak_count"][0] == min(S, M)
    print(json.dumps({"metric": "pipeline_smoke", "parity": "bitwise",
                      "losses": serial}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small parity + stash-bound gate")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    if args.smoke:
        return smoke(device)
    for schedule in ("gpipe", "1f1b"):
        for m in (2, 4, 8, 16):
            cell = run_cell(schedule, 2, m, args.steps, args.batch,
                            device=device)
            print(json.dumps(cell["row"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
