"""The port's host data plane wired into its users, against the JAX package:

- the eager collectives' JAX routing: gloo ranks with a control-plane store
  (world 3, three processes) give the JAX package's results bit for bit on
  both sides of ``TPU_DIST_DP_THRESHOLD`` (the store below it, the ring
  above it), on the float32 and ``int8_block256`` wires;
- ``Bucketer(dp=, comm_dtype=)`` with ``error_feedback=`` and
  ``ZeroOptimizer(dp=, comm_dtype=, error_feedback=, gather_comm_dtype=)``
  over thread ranks (the JAX tests' rigs), against the JAX package's;
- a reshard whose fragments are pushed by a peer over the data plane,
  against the JAX package's ``execute_plan`` (its ``TestPeerFetch``);
- the benchmark twins' smoke runs on the CPU.

The collectives and residuals are held bit for bit.  The optimizer update
is the port's torch arithmetic against the JAX package's numpy, so
parameters are held to 1e-6 relative (``tests/test_torch_zero.py``'s
rule), and byte-identical across ranks."""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from tpu_dist.collectives import transport as JT
from tpu_dist_torch.collectives import transport as TT
from tpu_dist_torch.dist.store import TCPStore

pytestmark = [pytest.mark.collectives, pytest.mark.multiprocess]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store():
    s = TCPStore(is_master=True, timeout=30)
    yield s
    s.close()


def run_world(store, kinds, fn, timeout=120):
    n = len(kinds)
    dps, out, errs = [], [None] * n, []
    try:
        for r, k in enumerate(kinds):
            dps.append((TT if k == "t" else JT).DataPlane(store, r, n))

        def run(r):
            try:
                out[r] = fn(dps[r], r)
            except Exception as e:  # surfaced below
                errs.append((r, repr(e)))

        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        assert not any(t.is_alive() for t in threads), "a rank hung"
    finally:
        for dp in dps:
            dp.close()
    assert not errs, errs
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the eager collectives' JAX routing, world 3, against the JAX package
# ---------------------------------------------------------------------------

EAGER_WORKER = textwrap.dedent("""
    import importlib, os, pickle, sys
    import numpy as np
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    def payload(r):
        g = np.random.default_rng(r)
        return {"small": g.standard_normal(100).astype(np.float32),
                "big": g.standard_normal(70001).astype(np.float32),
                "ints": (g.standard_normal(20000) * 100).astype(np.int32)}

    def drive(C):
        x = payload(rank)
        res = {}
        res["ar_avg"] = C.all_reduce_host(x, op="avg")
        res["ar_sum"] = C.all_reduce_host(x, op="sum")
        res["ar_max"] = C.all_reduce_host(x, op="max")
        res["ar_async"] = C.all_reduce_host(x, op="avg",
                                            async_op=True).wait(60)
        os.environ["TPU_DIST_COMM_DTYPE"] = "int8_block256"
        res["ar_int8"] = C.all_reduce_host(x, op="avg")
        os.environ["TPU_DIST_COMM_DTYPE"] = "bfloat16"
        res["ar_bf16"] = C.all_reduce_host(x, op="sum")
        del os.environ["TPU_DIST_COMM_DTYPE"]
        res["ag"] = C.all_gather_host(x)
        res["bc"] = C.broadcast_host(x, src=1)
        res["reduce"] = C.reduce_host(x, dst=1, op="sum")
        res["gather"] = C.gather_host(x["small"], dst=2)
        res["scatter"] = C.scatter_host(
            np.zeros(3), [np.full(3, float(i)) for i in range(world)]
            if rank == 2 else None, src=2)
        res["a2a"] = C.all_to_all_host([f"{rank}->{q}" for q in
                                        range(world)])
        res["obj"] = C.all_gather_object({"r": rank})
        res["bobj"] = C.broadcast_object_list([rank, "x"], src=2)
        if rank == 0:
            C.send(x["big"], dst=2, tag=3)
            C.send(x["small"], dst=2, tag=3)
        if rank == 2:
            res["recv"] = [C.recv(0, tag=3), C.recv(0, tag=3)]
        return res

    # the port: a gloo group with the control-plane store
    os.environ["TPU_DIST_STORE_ADDR"] = os.environ["PORT_STORE"]
    from tpu_dist_torch import collectives as TC, dist
    from tpu_dist_torch.collectives import eager as te
    dist.init_process_group(
        init_method=f"tcp://127.0.0.1:{os.environ['PORT_MASTER']}",
        world_size=world, rank=rank, device="cpu")
    port = drive(TC)
    counters = te.transport_counters()
    dist.destroy_process_group()

    # the JAX package: its store and data plane through a rank shim, as
    # its own benchmarks drive them
    from tpu_dist import collectives as JC
    from tpu_dist.dist.store import TCPStore
    host, _, p = os.environ["JAX_STORE"].rpartition(":")
    rdzv = importlib.import_module("tpu_dist.dist.rendezvous")
    rdzv._store = TCPStore(host, int(p))

    class _G:
        def __init__(self, rank, n):
            self.rank, self.num_processes = rank, n

    import tpu_dist.dist as jd
    jd.get_default_group = lambda: _G(rank, world)
    jax_ = drive(JC)
    rdzv._store.barrier(world, tag="done")
    with open(out, "wb") as f:
        pickle.dump({"port": port, "jax": jax_,
                     "counters": sorted(counters)}, f)
""")


def _same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def test_eager_routing_equals_the_jax_package_at_world_3(tmp_path):
    world = 3
    port_store = TCPStore(is_master=True, timeout=60)
    from tpu_dist.dist.store import TCPStore as JStore
    jax_store = JStore(is_master=True)
    script = tmp_path / "worker.py"
    script.write_text(EAGER_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PORT_STORE=f"127.0.0.1:{port_store.port}",
               JAX_STORE=f"127.0.0.1:{jax_store.port}",
               PORT_MASTER=str(_free_port()), OMP_NUM_THREADS="1")
    for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_HOST_TRANSPORT",
              "TPU_DIST_COMM_DTYPE", "TPU_DIST_DP_THRESHOLD"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(tmp_path / f"r{r}.pkl")],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        port_store.close()
        jax_store.close()
    assert [p.returncode for p in procs] == [0] * world, logs
    for r in range(world):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            got = pickle.load(f)
        _same(got["port"], got["jax"], f"rank{r}")
        # both transports carried payloads: the store below the
        # threshold, the data plane above it
        assert {"all_reduce/store", "all_reduce/dataplane",
                "all_gather/dataplane", "broadcast/dataplane"} <= set(
                    got["counters"]), got["counters"]


def test_a_group_without_the_store_keeps_its_backend(monkeypatch):
    from tpu_dist_torch.collectives import eager as te

    class _Gloo:
        backend, rank, num_processes = "gloo", 0, 2

    class _Nccl(_Gloo):
        backend = "nccl"

    store = object()
    assert te._use_backend(_Gloo(), None)          # no store: the backend
    assert not te._use_backend(_Gloo(), store)     # the JAX routing
    assert te._use_backend(_Nccl(), store)         # the card's default
    monkeypatch.setenv("TPU_DIST_HOST_TRANSPORT", "dataplane")
    assert not te._use_backend(_Nccl(), store)
    monkeypatch.setenv("TPU_DIST_HOST_TRANSPORT", "mesh")
    assert te._use_backend(_Gloo(), store)
    sub = _Gloo()
    sub._parent = object()                         # a dist.new_group group
    monkeypatch.setenv("TPU_DIST_HOST_TRANSPORT", "dataplane")
    assert te._use_backend(sub, store)


# ---------------------------------------------------------------------------
# Bucketer and ZeroOptimizer over thread ranks, against the JAX package's
# ---------------------------------------------------------------------------

def _grads(seed, step):
    g = np.random.default_rng(1000 * seed + step)
    return {"w1": g.standard_normal(1001).astype(np.float32),
            "b1": g.standard_normal(7).astype(np.float32),
            "w2": g.standard_normal((33, 65)).astype(np.float32),
            "z": np.zeros(3, np.float32)}


def _params():
    g = np.random.default_rng(5)
    return {"w1": g.standard_normal(1001).astype(np.float32),
            "b1": g.standard_normal(7).astype(np.float32),
            "w2": g.standard_normal((33, 65)).astype(np.float32),
            "z": np.zeros(3, np.float32)}


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("comm", [None, "bfloat16", "int8_block256"],
                         ids=lambda c: c or "f32")
@pytest.mark.parametrize("world", [2, 3, 4])
def test_bucketer_with_error_feedback_equals_jax(store, world, comm):
    from tpu_dist.collectives import Bucketer as JB
    from tpu_dist.collectives.quant import ErrorFeedback as JEF
    from tpu_dist_torch.collectives import Bucketer as TB
    from tpu_dist_torch.collectives.quant import ErrorFeedback as TEF

    def body(kind):
        def fn(dp, r):
            if kind == "t":
                b, ef = TB(bucket_bytes=8192, dp=dp, comm_dtype=comm), TEF()
            else:
                b, ef = JB(bucket_bytes=8192, dp=dp, comm_dtype=comm), JEF()
            efs = TEF() if kind == "t" else JEF()
            out = []
            for step in range(3):
                g = _grads(r, step)
                if kind == "t":
                    g = {k: torch.from_numpy(v) for k, v in g.items()}
                ar = b.all_reduce(g, op="avg", error_feedback=ef)
                rs = b.reduce_scatter(g, op="avg", error_feedback=efs)
                out.append((_np(ar.wait_all(60)), _np(rs.wait_all(60))))
            res = {repr(k): np.array(v) for k, v in ef.residuals.items()}
            res.update({f"s{k!r}": np.array(v)
                        for k, v in efs.residuals.items()})
            return out, res
        return fn

    port = run_world(store, "t" * world, body("t"))
    jax_ = run_world(store, "j" * world, body("j"))
    for r in range(world):
        _same(port[r], jax_[r], f"rank{r}")
        assert (len(port[r][1]) > 0) == (comm is not None)
    for step in range(3):
        _same(port[0][0][step][0], port[-1][0][step][0], "ranks")


@pytest.mark.parametrize("gather", [None, "bfloat16"],
                         ids=["exact", "bf16-gather"])
def test_zero_int8_error_feedback_equals_jax(store, gather):
    from tpu_dist import optim as jopt
    from tpu_dist.parallel import ZeroOptimizer as JZ
    from tpu_dist_torch import optim as topt
    from tpu_dist_torch.parallel import ZeroOptimizer as TZ
    world = 3

    def body(kind):
        def fn(dp, r):
            if kind == "t":
                z = TZ(topt.SGD(lr=0.1, momentum=0.9), dp=dp,
                       bucket_bytes=8192, comm_dtype="int8_block256",
                       error_feedback=True, gather_comm_dtype=gather)
                params = {k: torch.from_numpy(v) for k, v in
                          _params().items()}
            else:
                z = JZ(jopt.SGD(lr=0.1, momentum=0.9), dp=dp,
                       bucket_bytes=8192, comm_dtype="int8_block256",
                       error_feedback=True, gather_comm_dtype=gather)
                params = _params()
            zs = z.init(params)
            seen = []
            for step in range(3):
                g = _grads(r, step)
                if kind == "t":
                    g = {k: torch.from_numpy(v) for k, v in g.items()}
                frags = _np(z.reduce_scatter(g, state=zs).wait_all(60))
                h, zs = z.update(g, zs, timeout=60)
                params = _np(h.wait(60))
                seen.append((frags, _np(zs["ef"]), params))
            return seen
        return fn

    port = run_world(store, "ttt", body("t"))
    jax_ = run_world(store, "jjj", body("j"))
    for r in range(world):
        for step in range(3):
            pf, pe, pp = port[r][step]
            jf, je, jp = jax_[r][step]
            _same(pf, jf, f"rank{r} step{step} grad shards")
            _same(pe, je, f"rank{r} step{step} ef")
            for k in pp:
                np.testing.assert_allclose(pp[k], jp[k], rtol=1e-6,
                                           atol=1e-7)
            # the parameters are byte-identical on every rank
            _same(pp, port[0][step][2], f"rank{r} params")
            assert any(np.abs(v).sum() > 0 for v in pe.values())


# ---------------------------------------------------------------------------
# reshard: fragments pushed by a peer over the data plane
# ---------------------------------------------------------------------------

def test_reshard_pushes_fragments_over_the_data_plane(store, tmp_path):
    from tpu_dist.resilience import reshard as jreshard
    from tpu_dist_torch import checkpoint as tckpt
    from tpu_dist_torch import optim as topt
    from tpu_dist_torch.parallel import ZeroOptimizer as TZ
    from tpu_dist_torch.resilience import reshard as treshard

    class _Plane:
        def __init__(self, rank, n):
            self.rank, self.num_processes = rank, n

    root = str(tmp_path)
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    for r in range(3):
        z = TZ(topt.SGD(lr=0.1, momentum=0.9), dp=_Plane(r, 3),
               error_feedback=True)
        zs = z.init(params)
        for key in zs["ef"]:
            zs["ef"][key] += float(r + 1)
        tckpt.save(root, {"zero": zs}, step=5, shard=(r, 3))
    vis = {0: {0, 1, 2}, 1: set()}

    def body(R):
        plan = R.ReshardPlan(R.load_manifest(root, 5, 0), 2)
        return lambda dp, r: R.execute_plan(
            plan, rank=r, root=root, step=5, visibility=vis, dp=dp,
            verify=True, timeout=60)

    port = run_world(store, "tt", body(treshard))
    jax_ = run_world(store, "jj", body(jreshard))
    plan = treshard.ReshardPlan(treshard.load_manifest(root, 5, 0), 2)
    ref = [treshard.execute_plan(plan, rank=r, root=root, step=5,
                                 visibility={0: {0, 1, 2},
                                             1: {0, 1, 2}})[0]
           for r in range(2)]
    for r in range(2):
        arrays, stats = port[r]
        assert arrays.keys() == ref[r].keys() == jax_[r][0].keys()
        assert any("ef" in p for p in arrays)
        for path in ref[r]:
            assert arrays[path].tobytes() == ref[r][path].tobytes(), path
            assert arrays[path].tobytes() == jax_[r][0][path].tobytes()
    assert port[1][1].frags_peer > 0 and port[1][1].frags_disk == 0
    assert port[0][1].frags_pushed == port[1][1].frags_peer == \
        jax_[1][1].frags_peer


# ---------------------------------------------------------------------------
# the benchmark twins on the CPU
# ---------------------------------------------------------------------------

def _run_module(module, *argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_HOST_TRANSPORT",
              "TPU_DIST_COMM_DTYPE", "TPU_DIST_DP_THRESHOLD"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_bench_host_collectives_smoke():
    # numerics, hier/SHM bit for bit and cross-rank byte identity are
    # asserted inside the workers; overheads are reported, not gated
    rows = _run_module("tpu_dist_torch.benchmarks.bench_host_collectives",
                       "--device", "cpu", "--smoke")
    hc = [r for r in rows if r.get("metric") == "host_collective"]
    assert {(r["op"], r["path"]) for r in hc} >= {
        (op, p) for op in ("all_reduce", "all_gather", "broadcast")
        for p in ("store", "dataplane")}
    comp = {r["comm"]: r["compression"] for r in hc
            if r["op"] == "all_reduce" and r["path"] == "dataplane"}
    assert comp["f32"] == 1.0 and comp["bfloat16"] == 2.0
    assert 3.9 < comp["int8_block256"] < 4.0
    assert any(r.get("algo") == "flat_shm" and r["shm_active"] for r in hc)
    assert any(r["metric"] == "crc_overhead_8MiB_w2" for r in rows)


def test_bench_overlap_smoke():
    rows = _run_module("tpu_dist_torch.benchmarks.bench_overlap",
                       "--device", "cpu", "--smoke")
    assert {r["mode"] for r in rows} == {"per_leaf_sync", "per_leaf_async",
                                        "tree_sync", "bucketed_async"}
    assert all(r["value"] > 0 and r["leaves"] == 16 for r in rows)


def test_accuracy_run_quant_gate_small_run():
    rows = _run_module("tpu_dist_torch.benchmarks.accuracy_run",
                       "--quant-gate-only", "--device", "cpu",
                       "--quant-gate-steps", "10")
    (row,) = rows
    assert row["scheme"] == "int8_block256" and row["device"] == "cpu"
    assert 0.0 < row["f32_accuracy"] <= 1.0
    assert 0.0 < row["quant_ef_accuracy"] <= 1.0
    assert row["ef_residual_norm"] > 0
    assert row["within_noise"] == (abs(row["delta"])
                                   <= row["noise_band_3se"])
    # the JAX script's other modes are here too; on the card by default,
    # so without one they refuse before any work
    out = subprocess.run([sys.executable, "-m",
                          "tpu_dist_torch.benchmarks.accuracy_run",
                          "--quick"], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 2 and "no CUDA device" in out.stderr
