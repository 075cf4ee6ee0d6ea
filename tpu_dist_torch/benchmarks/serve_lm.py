"""Continuous-batching serving on the card — counterpart of ``run()`` in
``benchmarks/bench_serve.py`` of the JAX package, at full width.

The model is the GPT-2-small ``TransformerLM`` the training slices use
(vocab 32768, dim 768, depth 12, heads 12, ``max_seq_len`` 2048, learned
positions, LayerNorm, float32 parameters) with random weights from a seeded
generator, served by ``SlotEngine(8 slots, max_len 2048)``.

The traffic is bench_serve's (:func:`workload`): 96 greedy requests, prompt
lengths drawn from four sizes, one request in five generating 96 tokens and
the others 4 or 8 — the mix that starves run-to-completion batching, since
a batch lives as long as its longest member.  One cut: bench_serve runs a
pool of 160 positions and this one 2048, so prompt lengths are scaled by
2048 / 160 (6, 12, 24, 40 become 77, 154, 307, 512 tokens) to take the same
share of the context; the request count, the order of the lengths and
counts, and the prompt ids (below 251) are bench_serve's.  At a
160-position pool the list is bench_serve's own, request for request.

Three runs, as in bench_serve, for each KV-cache dtype (float32, int8):

- ``static``: run-to-completion batching — admit ``slots`` requests, decode
  until every one of them finishes, only then admit the next batch;
- ``continuous``: the :class:`~tpu_dist_torch.serve.Scheduler` path, every
  request submitted up front — freed slots are refilled between decode
  iterations;
- ``sweep``: the continuous path at sustained request rates, 0.25, 0.5 and
  0.8 of the capacity the continuous run measured, on a second list drawn
  from seed 1.

Every request's tokens must be the same in static and continuous batching:
the pool's shapes do not depend on its occupancy, so batching is a
schedule, not a change of numbers.  Reported per run: aggregate generated
tokens/s, TTFT p50/p99, end-to-end p50/p99, decode-step p50/p99, prefill
p50, occupancy and peak device memory; per cache, continuous tokens/s over
static.  Times are host clocks around work that ends in a device sync
(every step reads its tokens back).

    python -m tpu_dist_torch.benchmarks.serve_lm [--requests 96]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..models import TransformerLM
from ..nn.module import reset_parameters
from ..ops._build import resolve_device
from ..serve import Request, Scheduler, SlotEngine

__all__ = ["CONFIG", "build", "workload", "warmup", "run"]

CONFIG = dict(vocab_size=32768, dim=768, depth=12, num_heads=12,
              max_seq_len=2048)
CACHE_DTYPES = {"float32": torch.float32, "int8": torch.int8}
# bench_serve's pool, whose prompt lengths workload() scales to max_len
REFERENCE_POOL = 160
SWEEP = (0.25, 0.5, 0.8)


def build(config: dict = CONFIG, seed: int = 0, device=None):
    """The served model, its weights drawn from a generator seeded with
    ``seed``."""
    device = resolve_device(device)
    model = TransformerLM(**config, device=device)
    reset_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model


def workload(n: int = 96, seed: int = 0,
             max_len: int = CONFIG["max_seq_len"]) -> list:
    """bench_serve's ``_workload(n, seed)``, prompt lengths scaled from its
    160-position pool to ``max_len``: each request's prompt length is drawn
    from {6, 12, 24, 40}, its new-token count is 96 with probability 0.2
    and else 4 or 8, and its prompt ids below 251, by bench_serve's own
    draws; each prompt is then extended (or cut) to ``max_len / 160``
    times its length, with ids from a second generator, so the lengths and
    counts come in bench_serve's order at any pool size.  Returns dicts of
    ``prompt``/``max_new_tokens``/``temperature``/``seed`` (all greedy)."""
    rng = np.random.default_rng(seed)
    more = np.random.default_rng([seed, REFERENCE_POOL])
    scale = max_len / REFERENCE_POOL
    reqs = []
    for _ in range(n):
        plen = int(rng.choice([6, 12, 24, 40]))
        gen = 96 if rng.random() < 0.2 else int(rng.choice([4, 8]))
        prompt = rng.integers(0, 251, size=plen)
        size = round(plen * scale)
        extra = more.integers(0, 251, size=max(0, size - plen))
        reqs.append({"prompt": np.concatenate([prompt, extra])[:size]
                     .astype(np.int32),
                     "max_new_tokens": gen, "temperature": 0.0, "seed": 0})
    return reqs


def warmup(engine: SlotEngine, reqs: list) -> None:
    """One request through every prompt bucket the list uses, then the
    stats are reset: first calls (allocator growth, library set-up) stay
    out of the measured window."""
    for b in sorted({engine.bucket_for(len(r["prompt"])) for r in reqs}):
        engine.admit(Request(np.zeros(min(b, engine.max_len - 2), np.int32),
                             2))
        while not engine.idle():
            engine.step()
    engine.reset_stats()


def _summary(mode: str, engine: SlotEngine, wall: float, outputs: list,
             device) -> dict:
    st = engine.stats()
    row = {"mode": mode, "wall_s": wall,
           "generated_tokens": st["generated_tokens"],
           "tokens_per_s": st["generated_tokens"] / wall,
           "occupancy": st["occupancy"],
           "decode_steps": st["decode_steps"],
           "ttft_p50_ms": st["ttft"]["p50"] * 1e3,
           "ttft_p99_ms": st["ttft"]["p99"] * 1e3,
           "e2e_p50_ms": st["e2e"]["p50"] * 1e3,
           "e2e_p99_ms": st["e2e"]["p99"] * 1e3,
           "decode_step_p50_ms": st["decode_step"]["p50"] * 1e3,
           "decode_step_p99_ms": st["decode_step"]["p99"] * 1e3,
           "prefill_p50_ms": st["prefill"]["p50"] * 1e3,
           "outputs": outputs}
    if device.type == "cuda":
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return row


def _submit_args(r: dict) -> dict:
    return {k: r[k] for k in ("max_new_tokens", "temperature", "seed")}


def _engine(model, reqs: list, slots: int, cache_dtype) -> SlotEngine:
    """A warmed-up engine, the device's peak memory reset after it.  The
    previous run's engine is collected first, so the peak is this one's."""
    gc.collect()
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    engine = SlotEngine(model, num_slots=slots, cache_dtype=cache_dtype,
                        device=model.device)
    warmup(engine, reqs)
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    return engine


def run_static(model, reqs: list, slots: int, cache_dtype) -> dict:
    """Run-to-completion batching over the engine: the admission barrier
    is the only difference from :func:`run_continuous`."""
    engine = _engine(model, reqs, slots, cache_dtype)
    outs = {}
    order = []
    t0 = time.perf_counter()
    for i in range(0, len(reqs), slots):
        for r in reqs[i:i + slots]:
            req = Request(r["prompt"], on_token=lambda q, t: outs.setdefault(
                q.id, []).append(t), **_submit_args(r))
            order.append(req.id)
            engine.admit(req)
        while not engine.idle():      # run-to-completion barrier
            engine.step()
    wall = time.perf_counter() - t0
    return _summary("static", engine, wall, [outs[i] for i in order],
                    model.device)


def run_continuous(model, reqs: list, slots: int, cache_dtype,
                   qps: float = 0.0, batch_window: float = 0.002) -> dict:
    """The scheduler path: ``qps`` > 0 paces the submissions at that rate,
    0 submits every request up front."""
    engine = _engine(model, reqs, slots, cache_dtype)
    sched = Scheduler(engine, batch_window=batch_window)
    try:
        t0 = time.perf_counter()
        handles = []
        for i, r in enumerate(reqs):
            if qps > 0:
                time.sleep(max(0.0, t0 + i / qps - time.perf_counter()))
            handles.append(sched.submit(r["prompt"], timeout=60.0,
                                        **_submit_args(r)))
        outputs = [h.wait_done(timeout=600.0) for h in handles]
        wall = time.perf_counter() - t0
    finally:
        sched.close()
    return dict(_summary("continuous", engine, wall, outputs, model.device),
                qps_target=qps)


def run(requests: int = 96, slots: int = 8, config: dict = CONFIG,
        cache_dtypes=("float32", "int8"), device=None) -> dict:
    """Static and continuous batching and the sustained-rate sweep for
    each KV-cache dtype; returns the rows (without the token lists) and
    whether the two batching modes gave every request the same tokens."""
    device = resolve_device(device)
    model = build(config, device=device)
    max_len = config["max_seq_len"]
    reqs = workload(requests, max_len=max_len)
    rows = []
    mismatched = 0
    for name in cache_dtypes:
        dtype = CACHE_DTYPES[name]
        static = run_static(model, reqs, slots, dtype)
        cont = run_continuous(model, reqs, slots, dtype)
        mismatched += sum(a != b for a, b in zip(static["outputs"],
                                                 cont["outputs"]))
        capacity = len(reqs) / cont["wall_s"]
        runs = [static, cont] + [
            dict(run_continuous(model, workload(requests, seed=1,
                                                max_len=max_len),
                                slots, dtype, qps=frac * capacity),
                 mode="sweep", qps_frac_of_capacity=frac)
            for frac in SWEEP]
        for row in runs:
            row.pop("outputs")
            rows.append(dict(row, cache=name))
        rows.append({"mode": "continuous_vs_static", "cache": name,
                     "tokens_per_s_ratio": (cont["tokens_per_s"]
                                            / static["tokens_per_s"])})
    return {"metric": "serve_lm_generated_tokens_per_s",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
            "model": dict(config), "slots": slots, "requests": len(reqs),
            "prompt_tokens": int(sum(len(r["prompt"]) for r in reqs)),
            "new_tokens": int(sum(r["max_new_tokens"] for r in reqs)),
            "rows": rows, "requests_differing_between_modes": mismatched}


# ---------------------------------------------------------------------------
# multi-rank rows: tensor-parallel decode (bench_serve's run_sharded)
# ---------------------------------------------------------------------------

# bench_serve's smoke configurations: the sharded row's and the disagg row's
SHARD_SMOKE_CONFIG = dict(vocab_size=251, dim=32, depth=2, num_heads=4,
                          max_seq_len=96)
DISAGG_SMOKE_CONFIG = dict(vocab_size=251, dim=64, depth=2, num_heads=2,
                           max_seq_len=160)
SHARD_WORLDS = (1, 2, 4)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def mixed_requests(n: int, seed: int = 3) -> list:
    """bench_serve's ``_mixed_requests``: prompt lengths 6, 12 or 24 (ids
    1-250), 48 new tokens with probability 0.3 and else 8 or 16; greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.choice([6, 12, 24]))
        gen = 48 if rng.random() < 0.3 else int(rng.choice([8, 16]))
        out.append({"prompt": rng.integers(1, 251, size=plen)
                    .astype(np.int32), "max_new_tokens": gen,
                    "temperature": 0.0, "seed": 0})
    return out


def long_requests(max_len: int, vocab: int, seed: int = 5) -> list:
    """Two greedy requests whose prompts fill three quarters and three
    eighths of a ``max_len`` pool (1536 and 768 tokens at 2048 positions;
    ids 1..vocab-1), 16 new tokens each.  At dim 768 their prefill partials
    are far above the sharded decoder's 128 KiB exchange limit, so they
    combine on the ring, at the matmul shapes of real prompts."""
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, vocab, size=max_len * k // 8)
             .astype(np.int32), "max_new_tokens": 16, "temperature": 0.0,
             "seed": 0} for k in (6, 3)]


def _as_request(r) -> dict:
    if isinstance(r, dict):
        return dict(r, prompt=np.asarray(r["prompt"], np.int32))
    p, g = r
    return {"prompt": np.asarray(p, np.int32), "max_new_tokens": int(g),
            "temperature": 0.0, "seed": 0}


def drive_engine(engine: SlotEngine, reqs: list) -> dict:
    """Drive a pool (single-rank or a sharded leader) to completion over
    ``reqs``, one admission per decode iteration (bench_serve's
    ``_drive_engine``).  Returns tokens/s, end-to-end and decode-step
    percentiles, every request's tokens in submission order, and
    ``finished``: ``(slot, tokens)`` in the order the requests ended — the
    stream a follower's :attr:`ShardFollower.streams` must equal."""
    reqs = [_as_request(r) for r in reqs]
    outs, slot_of, finished = {}, {}, []

    def on_done(q, reason):
        finished.append((slot_of[q.id], list(outs.get(q.id, []))))

    pending = [Request(r["prompt"], r["max_new_tokens"],
                       temperature=r["temperature"], seed=r["seed"],
                       on_token=lambda q, t: outs.setdefault(
                           q.id, []).append(t), on_done=on_done)
               for r in reqs]
    order = [q.id for q in pending]
    engine.reset_stats()
    t0 = time.perf_counter()
    while pending or not engine.idle():
        if pending and engine.free_slots() > 0:
            q = pending.pop(0)
            slot_of[q.id] = engine._admission_slot(q)
            engine.admit(q)
        engine.step()
    wall = time.perf_counter() - t0
    st = engine.stats()
    return {"tokens_per_s": st["generated_tokens"] / wall, "wall_s": wall,
            "generated_tokens": st["generated_tokens"],
            "e2e_p50_ms": st["e2e"]["p50"] * 1e3,
            "e2e_p99_ms": st["e2e"]["p99"] * 1e3,
            "decode_step_p50_ms": st["decode_step"]["p50"] * 1e3,
            "decode_step_p99_ms": st["decode_step"]["p99"] * 1e3,
            "decode_steps": st["decode_steps"],
            "outputs": [outs[i] for i in order], "finished": finished}


def generate_refs(model, reqs: list, cache_dtype=None) -> list:
    """Ground truth per request: ``generate()`` alone (greedy, or the
    request's seed at its temperature)."""
    from ..serve import random_key
    out = []
    for r in (_as_request(r) for r in reqs):
        prompt = torch.from_numpy(r["prompt"]).to(model.device)
        toks = model.generate(
            prompt[None], r["max_new_tokens"],
            temperature=r["temperature"], cache_dtype=cache_dtype,
            rng=random_key(r["seed"]) if r["temperature"] else None)
        out.append(toks[0, len(r["prompt"]):].tolist())
    return out


def shard_world_threads(model, world: int, drive, slots: int = 3,
                        comm_dtype=None, timeout: float = 300.0) -> dict:
    """A ``world``-way sharded group of ``model`` in ONE process: leader
    and followers as threads over in-process DataPlanes (the test-rig
    layout; a deployment runs a rank a process).  Returns ``{"out":
    drive(leader engine), r: (close cause, streams) per follower}``; any
    rank's error raises."""
    import threading

    from ..collectives.transport import DataPlane
    from ..dist.store import TCPStore
    from ..interop import jax_params
    from ..serve import (ShardedDecoder, ShardedSlotEngine, ShardFollower,
                         shard_params)

    full = jax_params(model)
    store = TCPStore(is_master=True)
    dps = [DataPlane(store, r, world) for r in range(world)]
    result, errs = {}, []

    def rank_main(r):
        try:
            dec = ShardedDecoder(model, shard_params(model, full, r, world),
                                 dps[r], r, world, comm_dtype=comm_dtype)
            if r == 0:
                engine = ShardedSlotEngine(dec, num_slots=slots)
                try:
                    result["out"] = drive(engine)
                finally:
                    engine.close()
            else:
                f = ShardFollower(dec, num_slots=slots)
                result[r] = (f.run(deadline=timeout), f.streams)
        except Exception:
            import traceback
            errs.append((r, traceback.format_exc()))

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        for dp in dps:
            dp.close()
        store.close()
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"shard group failed: {errs or 'timed out'}")
    return result


@contextlib.contextmanager
def _file_reads():
    """Count the bytes read from every file ``open``-ed for reading inside
    the block (at the file object, under any buffering): yields a
    one-element list holding the count."""
    import builtins
    import io

    count = [0]
    real_open = builtins.open

    class Counting(io.FileIO):
        def read(self, n=-1):
            b = super().read(n)
            count[0] += len(b or b"")
            return b

        def readall(self):
            b = super().readall()
            count[0] += len(b)
            return b

        def readinto(self, buf):
            n = super().readinto(buf)
            count[0] += n or 0
            return n

    def counting_open(file, mode="r", buffering=-1, encoding=None, *a, **k):
        if a or k or not isinstance(file, (str, os.PathLike)) \
                or mode not in ("r", "rb", "rt"):
            return real_open(file, mode, buffering, encoding, *a, **k)
        raw = Counting(file, "r")
        if "b" in mode:
            return raw if buffering == 0 else io.BufferedReader(raw)
        return io.TextIOWrapper(io.BufferedReader(raw), encoding=encoding)

    builtins.open = counting_open
    try:
        yield count
    finally:
        builtins.open = real_open


def _trees_equal(a: dict, b: dict) -> bool:
    return (set(a) == set(b) and all(
        set(a[p]) == set(b[p]) and all(
            a[p][n].dtype == b[p][n].dtype
            and np.array_equal(a[p][n], b[p][n]) for n in a[p])
        for p in a))


def _device_for(kind: str, rank: int):
    if kind == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _shard_worker_main(rank: int, world: int, store_addr: str,
                       job_path: str) -> int:
    """One rank of a sharded group in its own process (the deployment
    layout), driven by the JSON job at ``job_path``: ``config``, ``seed``,
    ``device`` (``cuda``: rank r on card r mod the count), ``slots``,
    ``max_len``, ``comm_dtype``, ``ckpt`` (a full checkpoint to load the
    shard from, else the shard of the seeded model), ``runs`` (named
    request lists the leader drives, each warmed by its first two
    requests), ``kill`` (the leader serves ``kill`` requests through a
    Scheduler and records how they end once a follower dies), ``out`` (a
    directory: ``r{rank}.json``)."""
    from ..collectives.transport import DataPlane
    from ..dist.store import TCPStore
    from ..interop import jax_params
    from ..ops import KERNELS
    from ..serve import (Scheduler, ShardedDecoder, ShardedParams,
                         ShardedSlotEngine, ShardFollower, shard_params)

    with open(job_path) as f:
        job = json.load(f)
    device = _device_for(job.get("device", "cuda"), rank)
    cache_dtype = CACHE_DTYPES[job.get("cache", "float32")]
    model = build(job["config"], seed=job.get("seed", 0), device=device)
    want = shard_params(model, jax_params(model), rank, world)
    rec = {"rank": rank, "world": world, "device": str(device)}
    params = want
    if job.get("ckpt"):
        t0 = time.perf_counter()
        with _file_reads() as read:
            params = ShardedParams.from_checkpoint(job["ckpt"], model, rank,
                                                   world)
        rec.update(ckpt_s=time.perf_counter() - t0, ckpt_read_bytes=read[0],
                   ckpt_equal=_trees_equal(params, want),
                   shard_bytes=int(sum(a.nbytes for e in params.values()
                                       for a in e.values())),
                   ckpt_leaves=int(sum(len(e) for e in params.values())))
    host, _, port = store_addr.rpartition(":")
    store = TCPStore(host, int(port))
    dp = DataPlane(store, rank, world)
    dec = ShardedDecoder(model, params, dp, rank, world,
                         comm_dtype=job.get("comm_dtype"))
    del model, want, params
    slots, max_len = job.get("slots", 8), job.get("max_len")
    for k in KERNELS:
        k.launches = 0
    path = os.path.join(job["out"], f"r{rank}.json")

    def dump():
        rec["kernel_launches"] = {k.__name__: k.launches for k in KERNELS}
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)

    try:
        if rank != 0:
            f = ShardFollower(dec, num_slots=slots, max_len=max_len,
                              cache_dtype=cache_dtype)
            if job.get("kill"):
                # a follower killed by the job leaves its streams so far
                _every_finish(f, lambda: (rec.update(
                    streams=list(f.streams)), dump()))
            try:
                rec["cause"] = f.run(deadline=job.get("deadline", 900))
            except Exception as e:   # the leader's death, named
                rec["cause"] = f"error:{type(e).__name__}"
            rec.update(streams=f.streams, decode_steps=f.decode_steps)
        else:
            engine = ShardedSlotEngine(dec, num_slots=slots, max_len=max_len,
                                       cache_dtype=cache_dtype)
            rec["runs"], finished = {}, []
            for name, reqs in job.get("runs", {}).items():
                warm = drive_engine(engine, reqs[:2])
                before = dict(dec.algo_counts)
                rec["runs"][name] = drive_engine(engine, reqs)
                rec["runs"][name]["combines"] = {
                    k: v - before.get(k, 0)
                    for k, v in dec.algo_counts.items()}
                finished += warm["finished"] + rec["runs"][name]["finished"]
            rec["finished_all"] = finished
            rec["algo_counts"] = dict(dec.algo_counts)
            if job.get("kill"):
                rec.update(_serve_until_killed(engine, job, Scheduler))
            else:
                engine.close()
    finally:
        dump()
        dp.close()
        store.close()
    return 0


def _every_finish(follower, fn) -> None:
    """Call ``fn`` each time ``follower`` records a finished stream."""
    inner = follower._maybe_free

    def maybe_free(slot, token):
        n = len(follower.streams)
        inner(slot, token)
        if len(follower.streams) != n:
            fn()
    follower._maybe_free = maybe_free


def _serve_until_killed(engine, job: dict, scheduler_cls) -> dict:
    """The leader's half of the follower-SIGKILL check: serve the job's
    ``kill`` requests through a Scheduler, mark ``ready.json`` once every
    one streams, then record how each ends (its error's class and message
    and the wall-clock time) and the scheduler's fatal cause."""
    sched = scheduler_cls(engine, batch_window=0.0)
    try:
        handles = [sched.submit(r["prompt"], max_new_tokens=r[
            "max_new_tokens"], timeout=60.0) for r in
            (_as_request(r) for r in job["kill"])]
        for h in handles:
            next(iter(h.iter_tokens(timeout=300.0)))
        with open(os.path.join(job["out"], "ready.json"), "w") as f:
            json.dump({"t": time.time()}, f)
        ends = []
        for h in handles:
            try:
                h.wait_done(timeout=120.0)
                ends.append({"outcome": "done", "t": time.time()})
            except Exception as e:
                ends.append({"outcome": type(e).__name__,
                             "message": str(e)[:400], "t": time.time()})
        fatal = sched.fatal
        return {"ends": ends, "fatal": None if fatal is None
                else type(fatal).__name__}
    finally:
        sched.close()


def spawn_shard_world(job: dict, world: int, tmpdir: str):
    """Start ``world`` rank processes of :func:`_shard_worker_main` over a
    store this process hosts; returns ``(store, procs)`` (the caller waits
    them and closes the store)."""
    import subprocess

    from ..dist.store import TCPStore

    os.makedirs(job["out"], exist_ok=True)
    path = os.path.join(tmpdir, f"job_w{world}_{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    store = TCPStore(is_master=True)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.benchmarks.serve_lm",
         "--_shard_worker", "--rank", str(r), "--world", str(world),
         "--store", f"127.0.0.1:{store.port}", "--job", path],
        cwd=_REPO, env=env) for r in range(world)]
    return store, procs


def _wait_all(procs, timeout: float) -> list:
    import subprocess
    deadline = time.monotonic() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


def _requests_json(reqs: list) -> list:
    return [dict(_as_request(r), prompt=_as_request(r)["prompt"].tolist())
            for r in reqs]


def run_sharded(smoke: bool = False, world: Optional[int] = None,
                device=None, requests: int = 24, slots: int = 8,
                config: dict = CONFIG) -> dict:
    """bench_serve's ``run_sharded`` rows: tokens/s and p50/p99 by shard
    world.  ``smoke``: a world-2 group of the smoke model (threads in one
    process) whose streamed tokens must equal ``generate()`` token for
    token.  Otherwise the served model at shard worlds 1, 2 and 4 (those
    up to ``world``, default the card count), every rank a process, rank r
    on card r mod the count; world 1 is the single-rank engine.  Each
    world drives ``requests`` mixed requests (the measured run), then the
    two :func:`long_requests`.  Rows: tokens/s, end-to-end and
    decode-step p50/p99 (ms) of the mixed run, the combines it took by
    exchange and by ring and those of the long run, the requests of each
    run whose tokens differ from world 1's, and whether every follower's
    stream equals the leader's; a group whose followers left lockstep
    raises once its row is printed."""
    import tempfile

    rows = []
    if smoke:
        device = resolve_device(device)
        model = build(SHARD_SMOKE_CONFIG, device=device)
        reqs = mixed_requests(4)
        refs = generate_refs(model, reqs)
        res = shard_world_threads(model, 2, lambda e: drive_engine(e, reqs),
                                  slots=3)
        got = res["out"]
        assert got["outputs"] == refs, (
            f"sharded tokens diverged from generate(): {got['outputs']} vs "
            f"{refs}")
        assert res[1][1] == got["finished"], "follower left lockstep"
        row = {"metric": "serve_sharded_decode", "mode": "sharded",
               "shard_world": 2, "requests": len(reqs), "slots": 3,
               "tokens_per_sec": got["tokens_per_s"],
               "p50_latency_ms": got["e2e_p50_ms"],
               "p99_latency_ms": got["e2e_p99_ms"], "tokens_ok": True}
        print(json.dumps(row), flush=True)
        return row
    kind = "cpu" if device == "cpu" else "cuda"
    n_cards = torch.cuda.device_count() if kind == "cuda" else 1
    world = world or n_cards
    reqs = mixed_requests(requests)
    longs = long_requests(config["max_seq_len"], config["vocab_size"])
    base = None
    tmp = tempfile.mkdtemp(prefix="serve_sharded_",
                           dir=os.environ.get("TMPDIR"))
    for w in (w for w in SHARD_WORLDS if w <= world):
        if w == 1:
            model = build(config, device=_device_for(kind, 0))
            engine = SlotEngine(model, num_slots=slots, device=model.device)
            drive_engine(engine, reqs[:2])
            got = drive_engine(engine, reqs)
            got_long = drive_engine(engine, longs)
            algo = long_algo = {"exchange": 0, "ring": 0}
            lockstep = True
            del engine, model
            gc.collect()
            if kind == "cuda":
                torch.cuda.empty_cache()
        else:
            out = os.path.join(tmp, f"w{w}")
            store, procs = spawn_shard_world(
                {"config": config, "device": kind, "slots": slots,
                 "runs": {"mixed": _requests_json(reqs),
                          "long": _requests_json(longs)}, "out": out},
                w, tmp)
            try:
                rcs = _wait_all(procs, 1800)
            finally:
                store.close()
            if any(rcs):
                raise RuntimeError(f"shard world {w} failed: rcs {rcs}")
            recs = []
            for r in range(w):
                with open(os.path.join(out, f"r{r}.json")) as f:
                    recs.append(json.load(f))
            got, got_long = recs[0]["runs"]["mixed"], recs[0]["runs"]["long"]
            algo, long_algo = got["combines"], got_long["combines"]
            # every follower mirrored the leader's finished streams, slot
            # by slot (each samples from its own replicated logits)
            lockstep = bool(recs[0]["finished_all"]) and all(
                rec.get("streams") == recs[0]["finished_all"]
                for rec in recs[1:])
        if base is None:
            base, base_long = got, got_long
        rows.append({"metric": "serve_sharded_decode", "shard_world": w,
                     "cards": min(w, n_cards), "requests": len(reqs),
                     "slots": slots,
                     "tokens_per_sec": got["tokens_per_s"],
                     "p50_latency_ms": got["e2e_p50_ms"],
                     "p99_latency_ms": got["e2e_p99_ms"],
                     "decode_step_p50_ms": got["decode_step_p50_ms"],
                     "decode_step_p99_ms": got["decode_step_p99_ms"],
                     "combines": algo, "long_combines": long_algo,
                     "requests_differing_from_world1": sum(
                         a != b for a, b in zip(got["outputs"],
                                                base["outputs"])),
                     "long_prompt_lens": [len(r["prompt"]) for r in longs],
                     "long_differing_from_world1": sum(
                         a != b for a, b in zip(got_long["outputs"],
                                                base_long["outputs"])),
                     "followers_equal_leader": lockstep})
        print(json.dumps(rows[-1]), flush=True)
        if not lockstep:
            raise RuntimeError(
                f"shard world {w}: a follower's token streams differ from "
                f"the leader's — the group left lockstep")
    return {"metric": "serve_sharded_tokens_per_sec",
            "device": (torch.cuda.get_device_name(0) if kind == "cuda"
                       else "cpu"), "model": dict(config), "rows": rows}


# ---------------------------------------------------------------------------
# disaggregated prefill/decode rows (bench_serve's run_disagg)
# ---------------------------------------------------------------------------

class DisaggRig:
    """In-process disaggregated stack: one decode pool and one prefill
    worker thread over store-only typed channels and real data-plane KV
    frames (bench_serve's ``_DisaggRig``; a deployment runs
    a rank a process, ``examples/serve_lm.py --disagg``).
    ``prefill_model``: the prefill ranks' copy of the model (another card's,
    for a run with the two roles on separate cards); ``model`` by
    default."""

    def __init__(self, model, max_len: int, slots: int, prefix=None,
                 cache_dtype=None, prefill_model=None):
        import threading

        from .. import serve
        from ..collectives.transport import DataPlane
        from ..dist.store import TCPStore
        from ..roles.channel import Channel

        graph = serve.disagg_graph(1, 1)
        world = graph.world
        self.store = TCPStore(is_master=True)
        self.dps = [DataPlane(self.store, r, world) for r in range(world)]
        self._chans = []

        def chan(name, rank):
            spec = graph.channel_spec(name)
            role, _ = graph.role_of(rank)
            ch = Channel(spec, self.store, rank, role,
                         src_span=list(graph.span(spec.src)),
                         dst_span=list(graph.span(spec.dst)),
                         generation=0, graph_world=world, dp=False)
            self._chans.append(ch)
            return ch

        cache_dtype = cache_dtype or torch.float32
        pmodel = prefill_model if prefill_model is not None else model
        with torch.inference_mode():
            template = serve.kv_template(model.init_slot_cache(
                1, max_len, cache_dtype))
        self.worker = serve.PrefillWorker(
            pmodel, serve.KVTransfer(self.dps[0], template),
            claim_ch=chan(serve.PREFILL_QUEUE, 0),
            env_chans={0: chan(serve.kv_channel(0), 0)},
            rank=0, max_len=max_len, dtype=cache_dtype, prefix=prefix)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self.worker.run,
                                        args=(self._stop,), daemon=True,
                                        name="bench-prefill")
        self.engine = serve.DisaggSlotEngine(
            model, serve.KVTransfer(self.dps[1], template),
            dispatch_ch=chan(serve.PREFILL_QUEUE, 1),
            arrive_ch=chan(serve.kv_channel(0), 1),
            num_slots=slots, max_len=max_len, cache_dtype=cache_dtype,
            rank=1, role_rank=0, device=model.device)
        self.sched = serve.DisaggScheduler(self.engine, batch_window=0.002)
        self._thread.start()

    def close(self) -> None:
        self.sched.close()
        self.engine.close()
        self._stop.set()
        self._thread.join(15.0)
        for ch in self._chans:
            try:
                ch.close()
            except Exception:
                pass
        for dp in self.dps:
            dp.close()
        self.store.close()


def bursty_workload(seed: int = 7):
    """bench_serve's ``_bursty_workload``: a steady background of 6 long
    generations (8-token prompts, 56 new tokens) and one burst of 16 long
    prompts (384, 448, 512 tokens) wanting 4 new tokens each."""
    rng = np.random.default_rng(seed)
    bg = [(rng.integers(1, 251, size=8).astype(np.int32), 56)
          for _ in range(6)]
    plens = [384, 448, 512]
    burst = [(rng.integers(1, 251, size=plens[i % len(plens)])
              .astype(np.int32), 4) for i in range(16)]
    return bg, burst


def drive_burst(sched, engine, bg, burst) -> dict:
    """Submit the background, wait for the pool to fill, fire the burst,
    wait for everything; the engine's own histograms measure both arms
    alike."""
    engine.reset_stats()
    t0 = time.perf_counter()
    hs = [sched.submit(p, max_new_tokens=g, timeout=60.0) for p, g in bg]
    fill_deadline = time.monotonic() + 60
    want_free = max(0, engine.num_slots - len(bg))
    while engine.free_slots() > want_free \
            and time.monotonic() < fill_deadline:
        time.sleep(0.005)
    hs += [sched.submit(p, max_new_tokens=g, timeout=60.0)
           for p, g in burst]
    outs = [h.wait_done(timeout=600.0) for h in hs]
    wall = time.perf_counter() - t0
    st = engine.stats()
    return {"wall_sec": wall, "generated_tokens": st["generated_tokens"],
            "tokens_per_sec": st["generated_tokens"] / wall,
            "p50_ttft_ms": st["ttft"]["p50"] * 1e3,
            "p99_ttft_ms": st["ttft"]["p99"] * 1e3,
            "p99_latency_ms": st["e2e"]["p99"] * 1e3,
            "occupancy": st["occupancy"], "outputs": outs, "stats": st}


def warm_disagg(sched, max_len: int, plens=(8, 48, 64, 96)) -> None:
    """One request through every prompt bucket both sides will run."""
    rng = np.random.default_rng(99)
    hs = [sched.submit(rng.integers(1, 251, size=p).astype(np.int32),
                       max_new_tokens=2, timeout=60.0)
          for p in plens if p + 3 <= max_len]
    for h in hs:
        h.wait_done(timeout=600.0)


def run_disagg(smoke: bool = False, device=None, repeats: int = 3,
               prefill_device=None, config: dict = CONFIG,
               model=None) -> dict:
    """bench_serve's ``run_disagg`` rows: the bursty workload, unified
    against disaggregated (JAX's acceptance: higher tokens/s AND lower p99
    TTFT), and the prefix-heavy row (prefilled against requested tokens
    with one hot 64-token preamble).  ``smoke``: five requests of the
    smoke model through the disaggregated rig, three sharing a 36-token
    prefix, token for token against ``generate()``.  ``prefill_device``:
    the prefill rank's card (the decode rank keeps ``device``'s).
    ``model``: the served model when the caller has it built already."""
    from ..serve import PrefixCache, Scheduler

    device = resolve_device(device)
    if smoke:
        model = build(DISAGG_SMOKE_CONFIG, device=device)
        max_len = DISAGG_SMOKE_CONFIG["max_seq_len"]
        rig = DisaggRig(model, max_len, slots=4,
                        prefix=PrefixCache(block_tokens=16, device=device))
        try:
            shared = list(range(5, 41))
            reqs = [(np.asarray(shared + [60 + i], np.int32), 6)
                    for i in range(3)]
            reqs += [(np.arange(3, 3 + p, dtype=np.int32), g)
                     for p, g in ((6, 4), (20, 8))]
            refs = generate_refs(model, reqs)
            outs = [rig.sched.submit(p, max_new_tokens=g, timeout=60.0)
                    .wait_done(timeout=600.0) for p, g in reqs]
            for i, ref in enumerate(refs):
                assert outs[i] == ref, (
                    f"disagg request {i} diverged from generate(): "
                    f"{outs[i]} vs {ref}")
            st = rig.engine.stats()
            assert st["kv"]["transfers"] == len(reqs), st["kv"]
            assert st["prefix_cache"]["hits"] >= 2, st["prefix_cache"]
            row = {"metric": "serve_disagg_smoke", "requests": len(reqs),
                   "transfers": st["kv"]["transfers"],
                   "prefix_hits": st["prefix_cache"]["hits"],
                   "tokens_ok": True}
            print(json.dumps(row), flush=True)
            return row
        finally:
            rig.close()

    if model is None:
        model = build(config, device=device)
    device = model.device
    pmodel = (build(config, device=prefill_device)
              if prefill_device is not None else None)
    max_len, slots = config["max_seq_len"], 8
    bg, burst = bursty_workload()
    rows = []

    def best(sched, engine):
        top = None
        for _ in range(repeats):
            r = drive_burst(sched, engine, bg, burst)
            if top is None or r["tokens_per_sec"] > top["tokens_per_sec"]:
                top = r
        return top

    engine = SlotEngine(model, num_slots=slots, max_len=max_len,
                        device=device)
    sched = Scheduler(engine)
    try:
        warm_disagg(sched, max_len, plens=(8, 384))
        uni = best(sched, engine)
    finally:
        sched.close()
    uni_out = uni.pop("outputs")
    uni.pop("stats")
    rows.append(dict(uni, mode="unified", metric="serve_disagg_bursty"))

    rig = DisaggRig(model, max_len, slots, prefill_model=pmodel)
    try:
        warm_disagg(rig.sched, max_len, plens=(8, 384))
        dis = best(rig.sched, rig.engine)
        w = rig.worker.stats()
    finally:
        rig.close()
    st = dis.pop("stats")
    dis_out = dis.pop("outputs")
    rows.append(dict(
        dis, mode="disagg", metric="serve_disagg_bursty",
        transfer_p50_ms=st["transfer"]["p50"] * 1e3,
        transfer_p99_ms=st["transfer"]["p99"] * 1e3,
        kv_transfers=st["kv"]["transfers"],
        send_ms_p50=w["send"]["p50"] * 1e3,
        send_mb_per_s=w["send_mb_per_s"],
        requests_differing_from_unified=sum(
            a != b for a, b in zip(dis_out, uni_out))))
    rows.append({"metric": "serve_disagg_bursty_vs_unified",
                 "tokens_per_sec_ratio": (dis["tokens_per_sec"]
                                          / uni["tokens_per_sec"]),
                 "p99_ttft_ratio": dis["p99_ttft_ms"] / uni["p99_ttft_ms"]})

    prefix = PrefixCache(block_tokens=16, device=(prefill_device
                                                  or device))
    rig = DisaggRig(model, max_len, slots, prefix=prefix,
                    prefill_model=pmodel)
    try:
        warm_disagg(rig.sched, max_len)
        w = rig.worker
        base_total, base_run = w.total_tokens, w.prefilled_tokens
        rng = np.random.default_rng(11)
        preamble = rng.integers(1, 251, size=64).astype(np.int32)
        preqs = [(np.concatenate([preamble, rng.integers(1, 251, size=8)
                                  .astype(np.int32)]), 8)
                 for _ in range(24)]
        rig.engine.reset_stats()
        t0 = time.perf_counter()
        hs = [rig.sched.submit(p, max_new_tokens=g, timeout=60.0)
              for p, g in preqs]
        for h in hs:
            h.wait_done(timeout=600.0)
        wall = time.perf_counter() - t0
        st = rig.engine.stats()
        total = w.total_tokens - base_total
        ran = w.prefilled_tokens - base_run
        rows.append({
            "metric": "serve_disagg_prefix_heavy", "requests": len(preqs),
            "prefix_tokens": 64, "tokens_requested": int(total),
            "tokens_prefilled": int(ran),
            "prefill_compute_ratio": total / max(ran, 1),
            "prefix_hits": st["prefix_cache"]["hits"],
            "prefix_tokens_saved": st["prefix_cache"]["tokens_saved"],
            "mean_prefill_ms": st["prefill"]["mean"] * 1e3,
            "tokens_per_sec": st["generated_tokens"] / wall})
    finally:
        rig.close()
    for r in rows:
        print(json.dumps(r), flush=True)
    return {"metric": "serve_disagg_tokens_per_sec",
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else str(device),
            "prefill_device": str(prefill_device or device),
            "model": dict(config), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="with --sharded or --disagg: the smoke model's "
                         "token-for-token check against generate()")
    ap.add_argument("--sharded", action="store_true",
                    help="tensor-parallel rows at shard worlds 1, 2, 4")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode rows")
    ap.add_argument("--world", type=int, default=0,
                    help="--sharded: the largest shard world (default: the "
                         "card count); rank r runs on card r mod the count. "
                         "--disagg: 2 puts the prefill rank on card 1")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="--smoke runs: where (default cuda)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="--disagg: best of N bursty runs per arm")
    # one rank of a --sharded group, in its own process
    ap.add_argument("--_shard_worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--job", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if getattr(args, "_shard_worker"):
        return _shard_worker_main(args.rank, args.world, args.store,
                                  args.job)
    if args.sharded:
        out = run_sharded(smoke=args.smoke, world=args.world or None,
                          device=args.device, requests=args.requests or 24)
    elif args.disagg:
        pdev = (torch.device("cuda", 1) if args.world >= 2 else None)
        out = run_disagg(smoke=args.smoke, device=args.device,
                         repeats=args.repeats, prefill_device=pdev)
    else:
        out = run(requests=args.requests or 96, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
