"""The port's ring collectives (``tpu_dist_torch/collectives/ring.py``)
against the JAX package's ``tpu_dist/collectives/ring.py``: the four ring
collectives and ``tree_broadcast``, at worlds 2, 3 and 4, on the float32,
``bfloat16`` and ``int8_block256`` wires, with error-feedback residuals,
custom bounds and low-precision and integer payloads — bit for bit, and a
mixed ring (JAX ranks and port ranks in one ring) byte-identical to an
all-JAX ring.

Rigs: fake ranks in threads, a ``DataPlane`` each over one ``TCPStore``
bound to port 0 (the JAX tests' ``tests/test_quant_collectives.py``)."""

import threading

import numpy as np
import pytest

import ml_dtypes
from tpu_dist.collectives import ring as JR
from tpu_dist.collectives import transport as JT
from tpu_dist_torch.collectives import _lowp
from tpu_dist_torch.collectives import ring as TR
from tpu_dist_torch.collectives import transport as TT
from tpu_dist_torch.dist.store import TCPStore

pytestmark = pytest.mark.collectives

SIZE = 70001          # several 256 KiB frames, uneven over every world
WIRES = [None, "bfloat16", "int8_block256"]


@pytest.fixture
def store():
    s = TCPStore(is_master=True, timeout=30)
    yield s
    s.close()


def run_world(store, kinds, fn, timeout=120):
    """``fn(dp, rank, kind)`` on one thread a rank; ``kinds[r]`` is "t"
    (the port's DataPlane and ring) or "j" (the JAX package's)."""
    n = len(kinds)
    dps = []
    out, errs = [None] * n, []
    try:
        for r, k in enumerate(kinds):
            dps.append((TT if k == "t" else JT).DataPlane(store, r, n))

        def run(r):
            try:
                out[r] = fn(dps[r], r, kinds[r])
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


def _bf16(x, kind):
    return (_lowp.cast(x, _lowp.LOWP["bfloat16"]) if kind == "t"
            else x.astype(ml_dtypes.bfloat16))


def _suite(dp, r, kind, n, wire):
    """Every collective of the ring module on rank ``r``'s seeded data;
    returns ``{name: bytes}`` plus the wire byte counts."""
    R = TR if kind == "t" else JR
    vals = np.random.default_rng(100 + r).standard_normal(SIZE).astype(
        np.float32)
    out, stats = {}, {}
    for op in ("sum", "avg"):
        st: dict = {}
        out[f"ar_{op}"] = R.ring_all_reduce(dp, vals, op=op, tag=f"ar{op}",
                                            comm_dtype=wire, stats=st)
        stats[f"ar_{op}"] = (st["wire_bytes"], st["raw_wire_bytes"],
                             st["comm"])
    out["ar_max"] = R.ring_all_reduce(dp, vals, op="max", tag="mx",
                                      comm_dtype=wire)
    out["rs"] = R.ring_reduce_scatter(dp, vals, op="avg", tag="rs",
                                      comm_dtype=wire)
    bounds = R._bounds(SIZE, n)
    lo, hi = bounds[r]
    buf = np.zeros(SIZE, np.float32)
    buf[lo:hi] = vals[lo:hi]
    out["cag"] = R.ring_chunk_all_gather(dp, buf, bounds, tag="cag",
                                         comm_dtype=wire)
    out["ag"] = R.ring_all_gather(dp, vals[:999], tag="ag",
                                  comm_dtype=wire)
    out["bc"] = R.tree_broadcast(dp, vals, src=n - 1, tag="bc")
    # error feedback: a full-payload residual, then an owned-chunk one,
    # over two steps each (the second folds the first's loss back in)
    full = np.zeros(SIZE, np.float32)
    own = np.zeros(hi - lo, np.float32)
    for step in range(2):
        out[f"ar_ef{step}"] = R.ring_all_reduce(
            dp, vals, op="avg", tag=f"ef{step}", comm_dtype=wire,
            quant_residual=full)
        out[f"rs_ef{step}"] = R.ring_reduce_scatter(
            dp, vals, op="avg", tag=f"efs{step}", comm_dtype=wire,
            quant_residual=own)
    out["res_full"], out["res_own"] = full, own
    # bfloat16 payloads (sum widens to float32, max stays bfloat16) and an
    # int32 payload (sum in int64, avg in float64)
    b = _bf16(vals[:5000], kind)
    out["bf_sum"] = R.ring_all_reduce(dp, b, op="sum", tag="bfs",
                                      comm_dtype=wire)
    out["bf_max"] = R.ring_all_reduce(dp, b, op="max", tag="bfm")
    ints = (vals[:3001] * 1000).astype(np.int32)
    out["i_sum"] = R.ring_all_reduce(dp, ints, op="sum", tag="is",
                                     comm_dtype=wire)
    out["i_avg"] = R.ring_all_reduce(dp, ints, op="avg", tag="ia")
    # custom bounds (the Bucketer's)
    cb = [(0, 7)] + [(7 + i * 10, 17 + i * 10) for i in range(n - 2)]
    cb.append((cb[-1][1], SIZE))
    out["ar_bounds"] = R.ring_all_reduce(dp, vals, op="sum", tag="cb",
                                         comm_dtype=wire, bounds=cb)
    res = {k: (str(v.dtype) if not _lowp.is_lowp(v.dtype)
               else _lowp.dtype_name(v.dtype), v.shape,
               np.ascontiguousarray(v).reshape(-1).view(np.uint8).tobytes())
           for k, v in out.items()}
    res["stats"] = stats
    return res


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "f32")
@pytest.mark.parametrize("world", [2, 3, 4])
def test_port_ring_equals_jax_ring(store, world, wire):
    port = run_world(store, "t" * world,
                     lambda dp, r, k: _suite(dp, r, k, world, wire))
    jax_ = run_world(store, "j" * world,
                     lambda dp, r, k: _suite(dp, r, k, world, wire))
    for r in range(world):
        assert port[r].keys() == jax_[r].keys()
        for k in port[r]:
            assert port[r][k] == jax_[r][k], (r, k)
    # replicated results are byte-identical across ranks
    for k in ("ar_sum", "ar_avg", "ar_max", "cag", "ag", "bc", "ar_ef0",
              "ar_ef1", "bf_sum", "bf_max", "i_sum", "ar_bounds"):
        assert len({port[r][k] for r in range(world)}) == 1, k


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "f32")
@pytest.mark.parametrize("kinds", ["tjt", "jttj"])
def test_mixed_ring_is_byte_identical_to_a_jax_ring(store, kinds, wire):
    n = len(kinds)
    mixed = run_world(store, kinds,
                      lambda dp, r, k: _suite(dp, r, k, n, wire))
    jax_ = run_world(store, "j" * n,
                     lambda dp, r, k: _suite(dp, r, k, n, wire))
    assert mixed == jax_


def test_int8_error_is_within_the_jax_bound(store):
    # tests/test_quant_collectives.py's bound: 0.05 * max(|exact|, 1)
    n = 4
    vals = [np.random.default_rng(50 + r).standard_normal(SIZE).astype(
        np.float32) for r in range(n)]
    exact = np.sum(vals, axis=0) / n
    outs = run_world(store, "tttt", lambda dp, r, k: TR.ring_all_reduce(
        dp, vals[r], op="avg", comm_dtype="int8_block256"))
    assert len({o.tobytes() for o in outs}) == 1
    err = float(np.abs(outs[0] - exact).max())
    assert err <= 0.05 * max(float(np.abs(exact).max()), 1.0)
    assert err > 0     # the wire is lossy


def test_bad_arguments_raise_as_in_jax(store):
    def both(fn):
        msgs = []
        for R, P in ((TR, TT), (JR, JT)):
            dp = P.DataPlane(store, 0, 2)
            try:
                with pytest.raises(ValueError) as ei:
                    fn(R, dp)
                msgs.append(str(ei.value))
            finally:
                dp.close()
        assert msgs[0] == msgs[1]

    x = np.zeros(10, np.float32)
    both(lambda R, dp: R.ring_all_reduce(dp, x, bounds=[(0, 4), (5, 10)]))
    both(lambda R, dp: R.ring_all_reduce(dp, x, op="prod"))
    both(lambda R, dp: R.ring_all_reduce(
        dp, x, comm_dtype="int8_block256",
        quant_residual=np.zeros(3, np.float32)))
    both(lambda R, dp: R.ring_chunk_all_gather(dp, x.reshape(2, 5),
                                               [(0, 5), (5, 10)]))
    assert TR.ring_chunk_span(10, 3, 1) == JR.ring_chunk_span(10, 3, 1)
    assert TR.RING_OPS == JR.RING_OPS
