"""The unified sharding-rule plane, dp×tp against pure dp at world 4 — the
port's twin of ``benchmarks/bench_mesh_rules.py``.

Two :class:`~tpu_dist_torch.parallel.TPTrainer` worlds over real socket
data planes (4 endpoints on threads of this process), the same model,
optimizer and batches, differing only in the tp factor the rule table is
bound with:

- ``dp4``: pure data parallelism (tp=1): every rank holds the whole
  parameters and sums the whole gradient tree a step;
- ``dp2tp2``: the rule table's dp×tp split: each tp gang splits heads, the
  MLP width and the vocab over ``model``, so a rank's gradient tree (and
  the dp ring that sums it) halves, at the cost of per-layer activation
  combines inside the gang.

A cell reports steady-state steps/s (step 0 excluded) and wire bytes a
step a rank: the tp combiner's measured ``bytes_sent`` plus the dp ring's
``2·G·(dp−1)/dp`` over ``G`` gradient bytes.  One JSON line a cell, then
the headline (the wire reduction).  Nothing is written to the repo.

``--smoke`` checks, with no timing:

1. ``TRANSFORMER_TP_RULES`` equals the hand-written literals the JAX
   package's rule table replaced, leaf for leaf;
2. the all-None table degrades tp=2 to replication: the same losses and
   parameters as tp=1, bit for bit;
3. the world-4 dp2×tp2 ``TPTrainer`` over socket planes equals the
   threaded ``SerialTPRunner`` bit for bit (losses and every shard), two
   steps;
4. the host engine's tp=2 logits equal the GSPMD tp step's forward
   (``TransformerLM(model_axis="model")`` on two gloo rank processes)
   within float32 tolerance (rtol 1e-5, atol 1e-5), not bit for bit: the
   two sum the row-parallel partials in other programs, and the JAX
   package's own tp=2 is not bitwise its tp=1 on a CPU either.

Exit code 1 when a check fails::

    python -m tpu_dist_torch.benchmarks.bench_mesh_rules [--device cpu]
    python -m tpu_dist_torch.benchmarks.bench_mesh_rules --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

# sized so pure dp is wire-bound: ≈ 14.5 MB of float32 gradients a rank
# against ≈ 32 KB activation combines a layer (the JAX benchmark's)
VOCAB, DIM, DEPTH, HEADS, SEQ, BATCH = 4096, 256, 2, 8, 16, 4
WORLD = 4
TARGET = 1.3
SMOKE_DIMS = dict(vocab_size=64, dim=32, depth=2, num_heads=4,
                  max_seq_len=8)
FWD_RTOL = FWD_ATOL = 1e-5


def _model(device, dims=None):
    import torch

    from ..models import TransformerLM
    dims = dims or dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH,
                        num_heads=HEADS, max_seq_len=SEQ)
    torch.manual_seed(0)
    return TransformerLM(**dims, device=device)


def _loss_fn(vocab):
    from .. import nn
    ce = nn.CrossEntropyLoss()
    return lambda logits, y: ce(logits.reshape(-1, vocab), y.reshape(-1))


def _batch(step: int, vocab: int, batch: int, seq: int):
    import numpy as np
    rng = np.random.default_rng(1_000_003 * step + 7)
    return (rng.integers(0, vocab, size=(batch, seq)),
            rng.integers(0, vocab, size=(batch, seq)))


def _threads(fn, n, timeout=300):
    errs: list = []

    def run(r):
        try:
            fn(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ths = [threading.Thread(target=run, args=(r,), daemon=True)
           for r in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout)
    if errs:
        raise errs[0]


def _world(tp: int, device, dims=None, seed=0):
    """A threaded world-4 ``TPTrainer`` rig over socket data planes:
    ``(trainers, close)``."""
    from .. import optim
    from ..collectives.topology import SubGroup
    from ..collectives.transport import DataPlane
    from ..dist.store import TCPStore
    from ..parallel import TPTrainer

    dims = dims or dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH,
                        num_heads=HEADS, max_seq_len=SEQ)
    dp_n = WORLD // tp
    store = TCPStore(is_master=True)
    planes = [DataPlane(store, r, WORLD) for r in range(WORLD)]
    trainers = [None] * WORLD
    models = [_model(device, dims) for _ in range(WORLD)]

    def build(r):
        d, t = divmod(r, tp)
        # threads share new_group's process-wide creation counters: pin
        # the gang ids by hand
        trainers[r] = TPTrainer(
            models[r], optim.SGD(lr=0.1), _loss_fn(dims["vocab_size"]),
            dp=planes[r], tp=tp, seed=seed,
            tp_group=SubGroup(tuple(d * tp + i for i in range(tp)), r,
                              WORLD, instance=0),
            dp_group=SubGroup(tuple(i * tp + t for i in range(dp_n)), r,
                              WORLD, instance=0))

    try:
        _threads(build, WORLD)
    except BaseException:
        for p in planes:
            p.close()
        store.close()
        raise

    def close():
        for p in planes:
            p.close()
        store.close()
    return trainers, close


def _step_world(trainers, tp, x, y):
    import numpy as np
    dp_n = WORLD // tp
    xs, ys = np.split(x, dp_n), np.split(y, dp_n)
    got = [None] * WORLD

    def run(r):
        got[r] = trainers[r].step(xs[r // tp], ys[r // tp])

    _threads(run, WORLD)
    return got


def _grad_nbytes(params) -> int:
    return int(sum(a.numel() * a.element_size() for d in params.values()
                   for a in d.values()))


def run_cell(tp: int, device, steps: int = 5) -> dict:
    """One threaded world-4 run; its row."""
    trainers, close = _world(tp, device)
    dp_n = WORLD // tp
    try:
        g_bytes = _grad_nbytes(trainers[0].params)
        dp_wire = 2 * g_bytes * (dp_n - 1) // dp_n
        t_steady, tp_wire0 = None, 0
        for step in range(steps):
            _step_world(trainers, tp, *_batch(step, VOCAB, BATCH, SEQ))
            if step == 0:
                t_steady = time.perf_counter()
                tp_wire0 = trainers[0].tp_bytes_sent
        wall = time.perf_counter() - t_steady
        tp_wire = (trainers[0].tp_bytes_sent - tp_wire0) // (steps - 1)
    finally:
        close()
    return {"cell": f"dp{dp_n}tp{tp}" if tp > 1 else f"dp{dp_n}",
            "world": WORLD, "dp": dp_n, "tp": tp,
            "steps_per_sec": (steps - 1) / wall,
            "grad_bytes_per_rank": g_bytes,
            "dp_ring_bytes_per_step": dp_wire,
            "tp_bytes_per_step": int(tp_wire),
            "wire_bytes_per_step": int(dp_wire + tp_wire)}


def run(device, steps: int = 5) -> dict:
    pure = run_cell(1, device, steps)
    mesh = run_cell(2, device, steps)
    return {"metric": "mesh_rules_dp_tp_wire_reduction_world4",
            "value": pure["wire_bytes_per_step"]
            / max(1, mesh["wire_bytes_per_step"]),
            "unit": "x (pure-dp wire bytes / dp2tp2 wire bytes, per step)",
            "target": TARGET,
            "steps_per_sec_ratio": mesh["steps_per_sec"]
            / pure["steps_per_sec"],
            "cells": [pure, mesh]}


# ---------------------------------------------------------------------------
# --smoke
# ---------------------------------------------------------------------------

def _literal_rules():
    """``TRANSFORMER_TP_RULES`` as hand-written before the rule table
    existed (the JAX package's ``_legacy_literal_rules``)."""
    from ..parallel.gspmd import PartitionRules
    return PartitionRules([
        (r"qkv_weight", (None, "model")),
        (r"qkv_bias", ("model",)),
        (r"out_weight", ("model", None)),
        (r"mlp\.0'\]\['weight", (None, "model")),
        (r"mlp\.0'\]\['bias", ("model",)),
        (r"mlp\.2'\]\['weight", ("model", None)),
        (r"\['head'\].*weight", (None, "model")),
        (r"\['head'\].*bias", ("model",)),
        (r"\['tok'\].*weight", ("model", None)),
    ])


def smoke_literals(device) -> int:
    from ..interop import jax_params
    from ..parallel import TRANSFORMER_TP_RULES
    tree = jax_params(_model(device, SMOKE_DIMS))
    got = TRANSFORMER_TP_RULES.tree_specs(tree)
    want = _literal_rules().tree_specs(tree)

    def norm(spec):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec

    n = 0
    for path, leaves in want.items():
        for leaf, spec in leaves.items():
            assert norm(got[path][leaf]) == norm(spec), (path, leaf)
            n += 1
    return n


def smoke_all_none(device) -> None:
    import torch

    from .. import optim
    from ..parallel import DEFAULT_RULES, SerialTPRunner
    none_rules = {a: None for a in DEFAULT_RULES}
    loss_fn = _loss_fn(SMOKE_DIMS["vocab_size"])
    one = SerialTPRunner(_model(device, SMOKE_DIMS), optim.SGD(lr=0.1),
                         loss_fn, tp=1)
    two = SerialTPRunner(_model(device, SMOKE_DIMS), optim.SGD(lr=0.1),
                         loss_fn, tp=2, rules=none_rules)
    for step in range(2):
        x, y = _batch(step, SMOKE_DIMS["vocab_size"], 4, 8)
        assert one.step(x, y)[0] == two.step(x, y)[0], step
    for path, leaves in two.params[0].items():
        for name, t in leaves.items():
            assert torch.equal(t, two.params[1][path][name]), (path, name)
            assert torch.equal(t, one.params[0][path][name]), (path, name)


def smoke_plane(device) -> None:
    import torch

    from .. import optim
    from ..parallel import SerialTPRunner
    tp, dims = 2, SMOKE_DIMS
    oracle = SerialTPRunner(_model(device, dims), optim.SGD(lr=0.1),
                            _loss_fn(dims["vocab_size"]), tp=tp,
                            dp=WORLD // tp)
    trainers, close = _world(tp, device, dims)
    try:
        for step in range(2):
            x, y = _batch(step, dims["vocab_size"], 4, 8)
            want = oracle.step(x, y)
            got = _step_world(trainers, tp, x, y)
            assert got == [want[r // tp] for r in range(WORLD)], (got, want)
        for r, tr in enumerate(trainers):
            for path, leaves in tr.params.items():
                for name, t in leaves.items():
                    assert torch.equal(t, oracle.params[r % tp][path][name]),\
                        (r, path, name)
            assert tr.tp_bytes_sent > 0
    finally:
        close()


def _gspmd_rank(rank, port, device, x, out):
    import torch

    from .. import dist
    from ..models import TransformerLM
    torch.set_num_threads(1)
    pg = dist.init_process_group(
        init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
        device=device, axis_names=("data", "model"), mesh_shape=(1, 2))
    try:
        torch.manual_seed(0)
        model = TransformerLM(**SMOKE_DIMS, device=pg.device,
                              model_axis="model")
        with torch.no_grad():
            logits = model(torch.from_numpy(x).to(pg.device)).gather()
        if rank == 0:
            out.put(logits.cpu().numpy())
    finally:
        dist.destroy_process_group()


def smoke_host_vs_gspmd(device) -> float:
    """The host engine's tp=2 forward against the GSPMD tp step's forward
    on two gloo ranks: the largest absolute difference."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    from ..parallel.tensor import LocalCombiner, _TPEngine, tp_shard_params
    from ..parallel.tensor import _full_params, _to_device

    model = _model(device, SMOKE_DIMS)
    full = _full_params(model, None)
    x = np.random.default_rng(3).integers(0, SMOKE_DIMS["vocab_size"],
                                          (2, 8))
    comb = LocalCombiner(2)
    engines = [_TPEngine(model, None, comb.bound(t)) for t in range(2)]
    shards = [_to_device(tp_shard_params(model, full, t, 2), engines[t].device)
              for t in range(2)]
    outs = [None, None]

    def run(t):
        outs[t] = engines[t].forward(shards[t], x).cpu().numpy()

    _threads(run, 2)
    assert np.array_equal(outs[0], outs[1]), "tp ranks disagree"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gspmd_rank,
                         args=(r, port, "cpu" if device == "cpu" else None,
                               x, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        want = q.get(timeout=300)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    err = float(np.abs(outs[0] - want).max())
    np.testing.assert_allclose(outs[0], want, rtol=FWD_RTOL, atol=FWD_ATOL)
    return err


def smoke(device) -> None:
    n = smoke_literals(device)
    print(f"smoke: rule table reproduces the literal specs ({n} leaves)  OK",
          flush=True)
    smoke_all_none(device)
    print("smoke: all-None table tp=2 == tp=1 bit for bit  OK", flush=True)
    smoke_plane(device)
    print("smoke: TPTrainer dp2xtp2 over socket planes == SerialTPRunner "
          "bit for bit  OK", flush=True)
    err = smoke_host_vs_gspmd(device)
    print(f"smoke: host tp=2 logits == GSPMD tp forward within float32 "
          f"tolerance (max abs {err:.3g})  OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the checks, no timing")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.smoke:
        try:
            smoke(args.device)
        except AssertionError as e:
            print(f"smoke: FAILED {e}", file=sys.stderr, flush=True)
            return 1
        return 0
    row = run(args.device, args.steps)
    for cell in row["cells"]:
        print(json.dumps(cell), flush=True)
    print(json.dumps({k: v for k, v in row.items() if k != "cells"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
