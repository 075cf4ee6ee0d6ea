"""The port's eager host collectives against the JAX package's.

One script of calls (:data:`CASES`) runs in two worlds of two processes:
the JAX package's eager functions on its store path
(``TPU_DIST_HOST_TRANSPORT=store``, a TCPStore and a group shim, as its
benchmarks' workers run them) and the port's over gloo.  Each function's
result on each rank is held to the JAX one exactly: the same values, the
same numpy dtypes (the port reduces on the host in rank order with the same
numpy ufuncs).  A group of one process runs in this process.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = str(pathlib.Path(__file__).resolve().parents[1])

CASES = textwrap.dedent("""
    import numpy as np

    def run(E, g, rank, n):
        def x(seed=0):
            r = np.random.default_rng(seed + rank)
            return {"a": r.standard_normal((5, 3)).astype(np.float32),
                    "b": (np.arange(6, dtype=np.int32) + 3 * rank)}
        ints = {"i": np.array([5, 6, 12], np.int64) + rank}
        res = {}
        for op in ("sum", "avg", "max", "min", "product"):
            res[f"ar_{op}"] = E.all_reduce_host(x(), group=g, op=op)
        for op in ("band", "bor", "bxor"):
            res[f"ar_{op}"] = E.all_reduce_host(ints, group=g, op=op)
        res["ar_async"] = E.all_reduce_host(x(1), group=g, op="avg",
                                            async_op=True).wait(timeout=60)
        res["ag"] = E.all_gather_host({"a": x()["a"],
                                       "s": np.float32(rank + 0.5)}, group=g)
        res["ag_async"] = E.all_gather_host(x(2), group=g,
                                            async_op=True).wait(timeout=60)
        src = x(3) if rank == n - 1 else {k: np.zeros_like(v)
                                      for k, v in x(3).items()}
        res["bc"] = E.broadcast_host(src, group=g, src=n - 1)
        res["bc_async"] = E.broadcast_host(src, group=g, src=n - 1,
                                           async_op=True).wait(timeout=60)
        res["reduce"] = E.reduce_host(x(4), dst=n - 1, group=g, op="sum")
        res["gather"] = E.gather_host(np.arange(rank + 2, dtype=np.int16),
                                      dst=0, group=g)
        res["scatter"] = E.scatter_host(
            np.zeros(3, np.float64),
            [np.full(3, i + 0.25) for i in range(n)] if rank == 0 else None,
            src=0, group=g)
        if n > 1 and rank == 0:
            E.send(np.arange(6, dtype=np.float64).reshape(2, 3), 1, group=g,
                   tag=3)
            E.send(np.array([-1, 7], np.int16), 1, group=g)
            E.send(np.float32(2.5), 1, group=g, tag=3, async_op=True).wait(
                timeout=60)
            res["p2p"] = None
        elif n > 1 and rank == 1:
            res["p2p"] = [E.recv(0, group=g, tag=3), E.recv(0, group=g),
                          E.recv(0, group=g, tag=3, async_op=True).wait(
                              timeout=60)]
        else:
            res["p2p"] = None
        obj = {"rank": rank, "s": "x" * rank, "t": (rank, [1.5])}
        res["ago"] = E.all_gather_object(obj, group=g)
        res["go"] = E.gather_object(obj, dst=n - 1, group=g)
        res["bol"] = E.broadcast_object_list([rank, {"k": rank}], src=0,
                                             group=g)
        res["sol"] = E.scatter_object_list(
            [("o", i) for i in range(n)] if rank == n - 1 else None, src=n - 1,
            group=g)
        res["a2a"] = E.all_to_all_host([f"{rank}->{q}" for q in range(n)],
                                       group=g)
        res["a2a_arrays"] = E.all_to_all_host(
            [np.full(q + 1, rank, np.int32) for q in range(n)], group=g)
        return res
""")
NAMES = ["ar_sum", "ar_avg", "ar_max", "ar_min", "ar_product", "ar_band",
         "ar_bor", "ar_bxor", "ar_async", "ag", "ag_async", "bc",
         "bc_async", "reduce", "gather", "scatter", "p2p", "ago", "go",
         "bol", "sol", "a2a", "a2a_arrays"]

JAX_WORKER = textwrap.dedent("""
    import importlib, os, pickle, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["TPU_DIST_HOST_TRANSPORT"] = "store"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpu_dist.dist.store import TCPStore
    from tpu_dist.collectives import eager as E
    rank, n, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
    rdzv = importlib.import_module("tpu_dist.dist.rendezvous")
    rdzv._store = TCPStore("127.0.0.1", port)

    class G:
        def __init__(self, rank, n):
            self.rank, self.num_processes = rank, n
        def size(self):
            return self.num_processes

    ns = {}
    exec(sys.argv[5], ns)
    with open(out, "wb") as f:
        pickle.dump(ns["run"](E, G(rank, n), rank, n), f)
    rdzv._store.barrier(n, tag="exit")
""")

PORT_WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    from tpu_dist_torch import dist
    from tpu_dist_torch.collectives import eager as E
    rank, n, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
    torch.set_num_threads(1)
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=n, rank=rank, device="cpu",
                                 timeout=120)
    ns = {}
    exec(sys.argv[5], ns)
    res = ns["run"](E, pg, rank, n)
    # send_recv_device: rank 1's block replaces rank 0's, on the device
    blk = torch.full((2, 3), float(rank + 1))
    res["device_p2p"] = E.send_recv_device(blk, src=1, dst=0).numpy()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from tpu_dist.dist.store import TCPStore
    tmp = tmp_path_factory.mktemp("eager")
    n = 2
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR", "TPU_DIST_RESTART_COUNT"):
        env.pop(var, None)
    store = TCPStore(is_master=True)
    tport = _free_port()
    procs = [("jax", r, subprocess.Popen(
        [sys.executable, "-c", JAX_WORKER, str(r), str(n), str(store.port),
         str(tmp / f"jax{r}.pkl"), CASES], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for r in range(n)]
    procs += [("port", r, subprocess.Popen(
        [sys.executable, "-c", PORT_WORKER, str(r), str(n), str(tport),
         str(tmp / f"port{r}.pkl"), CASES], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for r in range(n)]
    try:
        for kind, r, p in procs:
            try:
                _, err = p.communicate(timeout=180)
            finally:
                p.kill()
            assert p.returncode == 0, (kind, r, err[-3000:])
    finally:
        store.close()

    def load(name):
        with open(tmp / name, "rb") as f:
            return pickle.load(f)

    return ([load(f"jax{r}.pkl") for r in range(n)],
            [load(f"port{r}.pkl") for r in range(n)])


def _same(got, want, path="") -> None:
    """Equal values of the same kinds and numpy dtypes, recursively."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype, (path, got.dtype,
                                                     want.dtype)
        assert got.shape == np.shape(want), path
        assert got.tobytes() == np.asarray(want).tobytes(), path
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_eager_function_matches_jax(world2, name):
    jax_res, port_res = world2
    for r in range(2):
        _same(port_res[r][name], jax_res[r][name], f"rank {r} {name}")


def test_send_recv_device_moves_the_src_block(world2):
    _, port_res = world2
    np.testing.assert_array_equal(port_res[0]["device_p2p"],
                                  np.full((2, 3), 2.0, np.float32))
    np.testing.assert_array_equal(port_res[1]["device_p2p"],
                                  np.full((2, 3), 2.0, np.float32))


# ---------------------------------------------------------------------------
# a group of one process, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def pg1():
    from tpu_dist_torch import dist
    pg = dist.init_process_group(device="cpu")
    yield pg
    dist.destroy_process_group()


@pytest.fixture
def jpg1():
    from tpu_dist.dist.process_group import ProcessGroup
    import jax
    return ProcessGroup(jax.devices()[:1])


@pytest.mark.parametrize("name", [n for n in NAMES if n != "p2p"])
def test_world1_matches_jax(pg1, jpg1, name):
    from tpu_dist.collectives import eager as JE
    from tpu_dist_torch.collectives import eager as TE
    ns = {}
    exec(CASES, ns)
    got = ns["run"](TE, pg1, 0, 1)[name]
    want = ns["run"](JE, jpg1, 0, 1)[name]
    _same(got, want, name)


def test_errors_match_jax(pg1):
    from tpu_dist_torch.collectives import eager as TE
    with pytest.raises(ValueError, match="Unknown reduce op"):
        TE.all_reduce_host(np.ones(2), op="median")
    with pytest.raises(ValueError, match="out of range"):
        TE.reduce_host(np.ones(2), dst=3)
    with pytest.raises(ValueError, match="scatter_list"):
        TE.scatter_host(np.zeros(2), [np.zeros(2)] * 2)
    with pytest.raises(ValueError, match="self"):
        TE.send(np.ones(1), 0)
    with pytest.raises(ValueError, match="one entry per process"):
        TE.all_to_all_host([1, 2])


def test_tensors_in_numpy_out(pg1):
    from tpu_dist_torch.collectives import eager as TE
    out = TE.all_reduce_host({"t": torch.arange(3.0)})
    assert isinstance(out["t"], np.ndarray)
    np.testing.assert_array_equal(out["t"], np.arange(3.0, dtype=np.float32))
