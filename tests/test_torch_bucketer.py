"""The port's async collectives, in-step ops and Bucketer against the JAX
package's.

``Work``/``wait_all``/``drain_pending`` run in process.  The port's worlds 2
and 3 are spawned gloo ranks (one spawn each, every case inside it); the
JAX side runs its ``collectives.ops`` under ``shard_map`` over as many of
conftest's virtual devices, and its pinned-mode ``Bucketer`` over fake
ranks in threads (one TCPStore, a DataPlane each, as ``tests/test_zero.py``
does).  Tolerances: at world 2 every result is held bit for bit (two
addends sum alike in any order); at world 3 the sums are held to float32
rounding (rtol 1e-6, atol 1e-6), since gloo's reduction order is not the
JAX ring's, and everything else bit for bit.  Inside the port, the
Bucketer's reduce-scatter shards are the spans of its all-reduce bit for
bit at both worlds.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_dist.collectives import ops as jops
from tpu_dist_torch.collectives import ops as tops
from tpu_dist_torch.collectives import work as twork
from tpu_dist_torch.collectives.bucketer import (Bucketer, chunk_bounds,
                                                 _bucket_bytes_env)

REPO = str(pathlib.Path(__file__).resolve().parents[1])
WORLDS = (2, 3)
RTOL = ATOL = 1e-6   # float32 rounding of a 3-term sum in another order


def _x(rank, shape=(6, 4), seed=100):
    return np.random.default_rng(seed + rank).standard_normal(
        shape).astype(np.float32)


def _grad_tree(seed):
    g = np.random.default_rng(seed)
    return {
        "w1": g.standard_normal(1001).astype(np.float32),   # uneven
        "w2": g.standard_normal((7, 13)).astype(np.float32),
        "w3": g.standard_normal(3).astype(np.float32),      # < world
        "b": np.float32(g.standard_normal()),               # scalar
    }


# ---------------------------------------------------------------------------
# Work, wait_all, drain_pending (in process)
# ---------------------------------------------------------------------------

def test_completed_work_returns_its_result():
    w = twork.completed_work(7, "x")
    assert w.is_completed() and w.wait() == 7 and w.result() == 7
    assert w.exception() is None and "done" in repr(w)


def test_executor_runs_in_issue_order_and_wait_returns_result():
    twork.reset()
    order = []
    works = [twork.engine().submit(lambda i=i: order.append(i) or i * i)
             for i in range(20)]
    assert twork.wait_all(works, timeout=30) == [i * i for i in range(20)]
    assert order == list(range(20))


def test_error_is_captured_and_reraised_at_wait():
    twork.reset()

    def boom():
        raise ValueError("peer gone")

    w = twork.engine().submit(boom)
    with pytest.raises(ValueError, match="peer gone"):
        w.wait(timeout=30)
    assert isinstance(w.exception(), ValueError) and "error" in repr(w)


def test_wait_timeout_raises_timeout_error_and_work_continues():
    twork.reset()
    gate = threading.Event()
    w = twork.engine().submit(lambda: gate.wait(30) and "late")
    with pytest.raises(TimeoutError, match="still in flight"):
        w.wait(timeout=0.05)
    assert not w.is_completed() and w.exception() is None
    gate.set()
    assert w.wait(timeout=30) == "late"


def test_wait_all_reraises_first_error_after_all_waited():
    twork.reset()

    def bad():
        raise RuntimeError("first")

    works = [twork.engine().submit(lambda: 1), twork.engine().submit(bad),
             twork.engine().submit(lambda: 3)]
    with pytest.raises(RuntimeError, match="first"):
        twork.wait_all(works, timeout=30)
    assert works[2].wait() == 3


def test_drain_pending_waits_for_queued_work():
    twork.reset()
    done = []
    twork.engine().submit(lambda: time.sleep(0.2) or done.append(1))
    twork.drain_pending(timeout=30)
    assert done == [1]


def test_deferred_work_runs_then_on_wait():
    w = twork.Work("deferred", [], lambda: "ready")
    assert not w.is_completed()
    assert w.wait(timeout=1) == "ready" and w.is_completed()


def test_bucket_bytes_env(monkeypatch):
    monkeypatch.setenv("TPU_DIST_BUCKET_BYTES", "8192")
    assert _bucket_bytes_env() == 8192 == Bucketer().bucket_bytes
    monkeypatch.setenv("TPU_DIST_BUCKET_BYTES", "12")
    assert _bucket_bytes_env() == 4096          # the JAX floor
    monkeypatch.delenv("TPU_DIST_BUCKET_BYTES")
    assert _bucket_bytes_env() == 25 * 1024 * 1024


@pytest.mark.parametrize("size,n", [(10, 3), (2, 4), (1001, 2), (0, 3)])
def test_chunk_bounds_are_the_jax_rings(size, n):
    from tpu_dist.collectives.ring import _bounds
    assert chunk_bounds(size, n) == _bounds(size, n)


class _Plane:
    """A pinned-mode stand-in for a DataPlane (rank and world only)."""

    def __init__(self, rank, n):
        self.rank, self.num_processes = rank, n


def test_comm_dtype_and_error_feedback_name_a9_1b():
    # A9.1b (the host data plane) brought both: a pinned world of one
    # returns copies of its leaves, on their devices
    from tpu_dist_torch.collectives.quant import ErrorFeedback
    x = torch.arange(4.0)
    b = Bucketer(comm_dtype="bfloat16", dp=_Plane(0, 1))
    out = b.all_reduce({"a": x}, error_feedback=ErrorFeedback()).wait_all()
    assert torch.equal(out["a"], x) and out["a"].data_ptr() != x.data_ptr()
    # what is still refused: the pinned ring-only harness takes no leaf
    # the ring cannot reduce
    with pytest.raises(ValueError, match="ring-only"):
        Bucketer(dp=_Plane(0, 2)).all_reduce({"m": torch.ones(2) > 0})


# ---------------------------------------------------------------------------
# ops over a group of one: each returns its input, as under an axis of 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [
    lambda x: tops.all_reduce(x), lambda x: tops.psum(x),
    lambda x: tops.pmean(x), lambda x: tops.all_gather(x, tiled=True),
    lambda x: tops.reduce_scatter(x), lambda x: tops.broadcast(x),
    lambda x: tops.all_to_all(x, split_axis=0, concat_axis=1),
    lambda x: tops.ring_all_reduce(x),
    lambda x: tops.ppermute(x, perm=[(0, 0)])],
    ids=["all_reduce", "psum", "pmean", "all_gather_tiled",
         "reduce_scatter", "broadcast", "all_to_all", "ring", "ppermute"])
def test_ops_over_one_rank_return_their_input(fn):
    x = torch.from_numpy(_x(0))
    assert torch.equal(fn(x), x)


def test_all_gather_untiled_over_one_rank_adds_an_axis():
    x = torch.from_numpy(_x(0))
    assert torch.equal(tops.all_gather(x, axis=1), x.unsqueeze(1))


def test_ops_map_over_a_tree():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3)]}
    out = tops.all_reduce(tree)
    assert out["a"] is tree["a"] and out["b"][0] is tree["b"][0]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_per_rank(fn, xs):
    n = len(xs)
    mesh = Mesh(np.array(jax.devices()[:n]), ("i",))
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=P("i"), out_specs=P("i"),
                              check_vma=False))
    out = np.asarray(f(np.stack(xs)))
    return [out[r] for r in range(n)]


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


JAX_OPS = {
    "sum": lambda n: (lambda v: jops.all_reduce(v, "i", "sum")),
    "avg": lambda n: (lambda v: jops.all_reduce(v, "i", "avg")),
    "max": lambda n: (lambda v: jops.all_reduce(v, "i", "max")),
    "min": lambda n: (lambda v: jops.all_reduce(v, "i", "min")),
    "prod": lambda n: (lambda v: jops.all_reduce(v, "i", "product")),
    "gather": lambda n: (lambda v: jops.all_gather(v, "i")),
    "gather_tiled": lambda n: (lambda v: jops.all_gather(v, "i", axis=1,
                                                         tiled=True)),
    "rs_sum": lambda n: (lambda v: jops.reduce_scatter(v, "i")),
    "rs_avg": lambda n: (lambda v: jops.reduce_scatter(v, "i", op="avg")),
    "bcast": lambda n: (lambda v: jops.broadcast(v, "i", src=1)),
    "a2a": lambda n: (lambda v: jops.all_to_all(v, "i", 0, 1)),
    "ppermute": lambda n: (lambda v: jops.ppermute(v, "i", _ring(n))),
    "ppermute_partial": lambda n: (lambda v: jops.ppermute(v, "i",
                                                           [(0, 1)])),
    "ring": lambda n: (lambda v: jops.ring_all_reduce(v, "i",
                                                      axis_size=n)),
}
SUMS = {"sum", "avg", "prod", "rs_sum", "rs_avg", "ring"}


def _jax_bucketer(n, op, scatter):
    """The JAX pinned-mode Bucketer over n fake ranks in threads (buckets
    of 4096 bytes: several a tree)."""
    from tpu_dist.collectives.bucketer import Bucketer as JB
    from tpu_dist.collectives.transport import DataPlane
    from tpu_dist.dist.store import TCPStore
    store = TCPStore(is_master=True)
    dps = [DataPlane(store, r, n) for r in range(n)]
    out, errs = [None] * n, []

    def run(r):
        try:
            b = JB(bucket_bytes=4096, dp=dps[r])
            fn = b.reduce_scatter if scatter else b.all_reduce
            out[r] = fn(_grad_tree(r), op=op).wait_all(timeout=60)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append((r, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for dp in dps:
        dp.close()
    store.close()
    assert not errs, errs
    return out


# ---------------------------------------------------------------------------
# the port side: one gloo world of each size, every case inside it
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist
    from tpu_dist_torch.collectives import ops
    from tpu_dist_torch.collectives.bucketer import Bucketer

    n, rank, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
    torch.set_num_threads(1)
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=n, rank=rank, device="cpu",
                                 timeout=120)
    def x(seed=100):
        return torch.from_numpy(np.random.default_rng(seed + rank)
                                .standard_normal((6, 4)).astype(np.float32))
    def tree():
        g = np.random.default_rng(rank)
        return {"w1": torch.from_numpy(g.standard_normal(1001).astype(np.float32)),
                "w2": torch.from_numpy(g.standard_normal((7, 13)).astype(np.float32)),
                "w3": torch.from_numpy(g.standard_normal(3).astype(np.float32)),
                "b": torch.tensor(np.float32(g.standard_normal()))}
    ring = [(i, (i + 1) % n) for i in range(n)]
    res = {
        "sum": ops.all_reduce(x()), "avg": ops.all_reduce(x(), op="avg"),
        "max": ops.all_reduce(x(), op="max"),
        "min": ops.all_reduce(x(), op="min"),
        "prod": ops.all_reduce(x(), op="product"),
        "gather": ops.all_gather(x()),
        "gather_tiled": ops.all_gather(x(), axis=1, tiled=True),
        "rs_sum": ops.reduce_scatter(x()),
        "rs_avg": ops.reduce_scatter(x(), op="avg"),
        "bcast": ops.broadcast(x(), src=1),
        "a2a": ops.all_to_all(x(), split_axis=0, concat_axis=1),
        "ppermute": ops.ppermute(x(), perm=ring),
        "ppermute_partial": ops.ppermute(x(), perm=[(0, 1)]),
        "ring": ops.ring_all_reduce(x()),
        "axis": ops.psum(x(), group="data"),
    }
    for op in ("sum", "avg", "max"):
        b = Bucketer(bucket_bytes=4096)
        ar = b.all_reduce(tree(), op=op, group=pg)
        rs = b.reduce_scatter(tree(), op=op, group=pg)
        for k, v in ar.wait_all(timeout=60).items():
            res[f"bar_{op}_{k}"] = v
        for k, v in rs.wait_all(timeout=60).items():
            res[f"brs_{op}_{k}"] = v
    np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bucketer")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    procs = []
    for n in WORLDS:
        port = _free_port()
        procs += [(n, r, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(n), str(r), str(port),
             str(tmp / f"w{n}r{r}.npz")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for r in range(n)]
    for n, r, p in procs:
        try:
            _, err = p.communicate(timeout=180)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
    return {n: [dict(np.load(tmp / f"w{n}r{r}.npz")) for r in range(n)]
            for n in WORLDS}


def _hold(got, want, n, summed):
    if n == 2 or not summed:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(JAX_OPS))
def test_ops_match_jax_ops(worlds, n, name):
    want = _jax_per_rank(JAX_OPS[name](n), [_x(r) for r in range(n)])
    for r in range(n):
        _hold(worlds[n][r][name], want[r], n, name in SUMS)


@pytest.mark.parametrize("n", WORLDS)
def test_ops_take_a_mesh_axis_name(worlds, n):
    for r in range(n):
        np.testing.assert_array_equal(worlds[n][r]["axis"],
                                      worlds[n][r]["sum"])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_bucketed_all_reduce_matches_jax_bucketer(worlds, n, op):
    want = _jax_bucketer(n, op, scatter=False)
    for r in range(n):
        for k, v in want[r].items():
            _hold(worlds[n][r][f"bar_{op}_{k}"], np.asarray(v), n,
                  op != "max")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", ["sum", "avg"])
def test_bucketed_reduce_scatter_matches_jax_bucketer(worlds, n, op):
    want = _jax_bucketer(n, op, scatter=True)
    for r in range(n):
        for k, v in want[r].items():
            _hold(worlds[n][r][f"brs_{op}_{k}"], np.asarray(v), n, True)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_shards_are_the_all_reduce_spans_bitwise(worlds, n, op):
    sizes = {k: np.asarray(v).size for k, v in _grad_tree(0).items()}
    for r in range(n):
        res = worlds[n][r]
        for k, size in sizes.items():
            lo, hi = chunk_bounds(size, n)[r]
            full = res[f"bar_{op}_{k}"].reshape(-1)
            assert res[f"brs_{op}_{k}"].tobytes() == full[lo:hi].tobytes()
        # every rank holds the same all-reduced values
        for k in sizes:
            assert res[f"bar_{op}_{k}"].tobytes() == \
                worlds[n][0][f"bar_{op}_{k}"].tobytes()
