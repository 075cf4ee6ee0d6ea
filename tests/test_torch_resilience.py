"""The port's resilience layer against the JAX package's: chaos specs and
faults, ``TrainState`` (save, resume, the store-agreed step, pruning),
the reshard manifest, world-size resharding, and sharded ZeRO checkpoints
crossing packages.

ZeRO states are built as the JAX tests build them (``tests/test_reshard.
py``): every element of the logical world-1 state is a function of its
global index, and a (rank, world) shard is a numpy slice of it, so the
expected result of a reshard never comes from the reshard code.  Each
crossing is held bit for bit; none needs a peer (fragments come from disk).
"""

import dataclasses
import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

from tpu_dist import checkpoint as jckpt
from tpu_dist import optim as joptim
from tpu_dist.resilience import chaos as jchaos
from tpu_dist.resilience import reshard as jreshard
from tpu_dist_torch import checkpoint as tckpt
from tpu_dist_torch.parallel import ZeroOptimizer as TZero
from tpu_dist_torch.resilience import TrainState as TTrainState
from tpu_dist_torch.resilience import chaos as tchaos
from tpu_dist_torch.resilience import reshard as treshard


@pytest.fixture(autouse=True)
def _no_launcher_env(monkeypatch):
    for var in ("TPU_DIST_STORE_ADDR", "TPU_DIST_CHAOS", "RANK",
                "WORLD_SIZE", "TPU_DIST_RESTART_COUNT",
                "TPU_DIST_HEARTBEAT_TIMEOUT"):
        monkeypatch.delenv(var, raising=False)
    yield
    tchaos.uninstall()


# ---------------------------------------------------------------------------
# chaos: the grammar, its errors and the faults are the JAX package's
# ---------------------------------------------------------------------------

SPECS = ["kill:rank=1,step=5", "exit:step=3,code=9",
         "shrink:rank=1,step=20;grow:rank=0,step=35,world=2",
         "shrink:rank=2,step=4,world=2", "raise:step=0",
         "stall:rank=0,step=3,delay=0.5", "stall-heartbeat:rank=0,step=3",
         "drop-store:rank=1,op=4", "delay-store:op=1,delay=0.2",
         " kill : rank=0 , step=1 ; ; exit:step=2 "]
BAD_SPECS = ["", ";;", "teleport:step=1", "kill:rank=1", "drop-store:rank=0",
             "delay-store:op=1", "grow:step=3", "grow:step=3,world=1",
             "kill:step", "kill:step=1,color=2", "kill:step=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_to_the_jax_faults(spec):
    got = [dataclasses.asdict(f) for f in tchaos.parse(spec)]
    want = [dataclasses.asdict(f) for f in jchaos.parse(spec)]
    assert got == want


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_spec_errors_are_the_jax_errors(spec):
    with pytest.raises(ValueError) as want:
        jchaos.parse(spec)
    with pytest.raises(ValueError) as got:
        tchaos.parse(spec)
    assert str(got.value) == str(want.value)


def test_exit_codes_are_the_jax_ones():
    from tpu_dist_torch import resilience
    assert (resilience.PREEMPTED_EXIT_CODE, resilience.GROW_EXIT_CODE) == \
        (jchaos.PREEMPTED_EXIT_CODE, jchaos.GROW_EXIT_CODE) == (117, 118)


def test_raise_fault_fires_at_its_step_only():
    c = tchaos.Chaos(tchaos.parse("raise:rank=1,step=3"), rank=1)
    c.on_step(2)
    with pytest.raises(tchaos.ChaosError, match="rank 1 at step 3"):
        c.on_step(3)
    tchaos.Chaos(tchaos.parse("raise:rank=1,step=3"), rank=0).on_step(3)


@pytest.mark.parametrize("step,want", [(None, False), (2, False), (3, True),
                                       (4, True)])
def test_heartbeat_stall_matches_jax(step, want):
    spec = "stall-heartbeat:rank=0,step=3;stall:rank=1,step=4"
    for r in (0, 1):
        got = tchaos.Chaos(tchaos.parse(spec), rank=r).heartbeat_stalled(step)
        ref = jchaos.Chaos(jchaos.parse(spec), rank=r).heartbeat_stalled(step)
        assert got == ref
    assert tchaos.Chaos(tchaos.parse(spec), rank=0).heartbeat_stalled(
        step) == want


def test_install_wires_the_store_hook_and_heartbeat(monkeypatch):
    from tpu_dist_torch.dist import store as tstore
    from tpu_dist_torch.resilience import Heartbeat
    monkeypatch.setenv("TPU_DIST_CHAOS", "stall-heartbeat:rank=0,step=2;"
                                         "drop-store:rank=0,op=2")
    c = tchaos.install_from_env()
    assert tchaos.install_from_env() is c and tchaos.active() is c
    assert tstore.FAULT_HOOK == c.store_op
    closed = []
    client = types.SimpleNamespace(_sock=types.SimpleNamespace(
        close=lambda: closed.append(1)))
    c.store_op(client, 1, "k")
    c.store_op(client, 1, "k")
    assert closed == [1]
    sets = []
    hb = Heartbeat(rank=0, store=types.SimpleNamespace(
        set=lambda k, v: sets.append(v)))
    hb.set_step(1)
    hb.set_step(2)   # stalled from step 2 on: no beat
    assert len(sets) == 1 and sets[0].split(":")[1] == "1"
    tchaos.uninstall()
    assert tstore.FAULT_HOOK is None and tchaos.active() is None


# ---------------------------------------------------------------------------
# ZeRO states: ground truth by global index (the JAX tests' construction)
# ---------------------------------------------------------------------------

class _G:
    def __init__(self, rank=0, num_processes=1):
        self.rank, self.num_processes = rank, num_processes
        self.device = torch.device("cpu")
        self.torch_group = None


def _params():
    g = np.random.default_rng(7)
    return {"w1": g.standard_normal(1001).astype(np.float32),
            "w2": g.standard_normal((7, 13)).astype(np.float32),
            "w3": g.standard_normal(3).astype(np.float32),
            "b": np.float32(g.standard_normal()),
            "i": np.arange(17, dtype=np.int32)}


def _full():
    from tpu_dist.parallel import ZeroOptimizer
    full = ZeroOptimizer(joptim.Adam(1e-3), group=_G()).init(_params())
    for a in full["shards"].values():
        a[...] = (np.arange(a.size) % 251).astype(a.dtype)
    flat, treedef = jax.tree_util.tree_flatten(full["opt"])
    out = []
    for i, leaf in enumerate(flat):
        a = np.array(leaf)
        if a.ndim == 1:
            a[...] = ((np.arange(a.size) * 3 + i) % 241).astype(a.dtype)
        out.append(a)
    full["opt"] = jax.tree_util.tree_unflatten(treedef, out)
    full["opt"]["step"] = np.int32(5)
    return full


def _expect_shard(flat, sizes, idxs, world, rank):
    from tpu_dist.collectives.ring import _bounds
    offs, pos = {}, 0
    for i in idxs:
        offs[i] = pos
        pos += sizes[i]
    frags = [flat[offs[i] + lo:offs[i] + hi]
             for i in idxs for lo, hi in [_bounds(sizes[i], world)[rank]]]
    return np.concatenate(frags) if frags else np.zeros(0, flat.dtype)


def _jax_state(world, rank, full):
    from tpu_dist.parallel import ZeroOptimizer
    st = ZeroOptimizer(joptim.Adam(1e-3), group=_G(rank, world)).init(
        _params())
    sizes = [int(s) for s in st["meta"]["leaf_size"]]
    groups = dict(jreshard._groups([str(d) for d in
                                    st["meta"]["leaf_dtype"]]))
    for key, idxs in groups.items():
        st["shards"][key] = _expect_shard(full["shards"][key], sizes, idxs,
                                          world, rank)
    for k in ("m", "v"):
        st["opt"][k] = {key: _expect_shard(np.asarray(full["opt"][k][key]),
                                           sizes, idxs, world, rank)
                        for key, idxs in groups.items()}
    st["opt"]["step"] = np.int32(5)
    return st


def _port_state(world, rank, full):
    """The port's ZeroOptimizer state at (rank, world) holding the same
    values."""
    from tpu_dist_torch import optim
    st = TZero(optim.Adam(1e-3), group=_G(rank, world)).init(
        {k: torch.from_numpy(np.array(v)) for k, v in _params().items()})
    js = _jax_state(world, rank, full)
    st["shards"] = {k: torch.from_numpy(np.array(v))
                    for k, v in js["shards"].items()}
    for k in ("m", "v"):
        st["opt"][k] = {d: torch.from_numpy(np.array(v))
                        for d, v in js["opt"][k].items()}
    st["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    return st


def _save(pkg, root, world, step, full):
    for r in range(world):
        if pkg == "jax":
            jckpt.save(root, {"zero": _jax_state(world, r, full)}, step=step,
                       shard=(r, world))
        else:
            tckpt.save(root, {"zero": _port_state(world, r, full)},
                       step=step, shard=(r, world))


def _flat(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tckpt._flatten(tree).items()}


def test_port_zero_meta_is_the_jax_meta():
    for world, rank in ((1, 0), (3, 2)):
        jm = _jax_state(world, rank, _full())["meta"]
        tm = _port_state(world, rank, _full())["meta"]
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_array_equal(np.asarray(tm[k]),
                                          np.asarray(jm[k]), err_msg=k)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_manifest_equals_jax_manifest(tmp_path, world):
    full = _full()
    _save("jax", str(tmp_path / "j"), world, 5, full)
    _save("port", str(tmp_path / "t"), world, 5, full)
    for r in range(world):
        got = treshard.load_manifest(str(tmp_path / "t"), 5, r)
        want = jreshard.load_manifest(str(tmp_path / "j"), 5, r)
        assert got == want and got is not None


@pytest.mark.parametrize("old,new", [(2, 1), (1, 3), (3, 2), (4, 3)])
def test_reshard_crossings_bitwise_within_memory_bound(tmp_path, old, new):
    full = _full()
    root = str(tmp_path)
    _save("port", root, old, 5, full)
    old_bytes = max(sum(v.numel() * v.element_size()
                        for v in _port_state(old, r, full)["shards"].values())
                    for r in range(old))
    for d in range(new):
        tmpl = {"zero": _port_state(new, d, _full())}
        for k in ("shards",):   # the template's values must not leak through
            tmpl["zero"][k] = {key: torch.zeros_like(v)
                               for key, v in tmpl["zero"][k].items()}
        got, stats = treshard.reshard_restore(root, tmpl, 5, shard=(d, new),
                                              verify=True)
        want = _flat({"zero": _port_state(new, d, full)})
        flat = _flat(got)
        assert set(flat) == set(want)
        for k in want:
            assert flat[k].dtype == want[k].dtype and \
                flat[k].tobytes() == want[k].tobytes(), k
        assert stats.old_world == old and stats.new_world == new
        # the JAX bound: new shard + one fragment, and never an old shard
        # more than the old shards' largest
        assert stats.peak_bytes <= (stats.new_shard_bytes
                                    + stats.frag_bytes_max + old_bytes)
        assert stats.frags_peer == 0 and stats.frags_disk == stats.frags_total


@pytest.mark.parametrize("saver,old,new", [("jax", 2, 3), ("jax", 3, 2),
                                           ("port", 2, 3), ("port", 3, 2)])
def test_sharded_zero_checkpoint_crosses_packages(tmp_path, saver, old, new):
    full = _full()
    root = str(tmp_path)
    _save(saver, root, old, 5, full)
    for d in range(new):
        if saver == "jax":
            got, _ = treshard.reshard_restore(
                root, {"zero": _port_state(new, d, full)}, 5, shard=(d, new))
        else:
            got, _ = jreshard.reshard_restore(
                root, {"zero": _jax_state(new, d, full)}, 5, shard=(d, new))
        want = _flat({"zero": _port_state(new, d, full)})
        flat = {k: np.asarray(v) for k, v in _flat(got).items()}
        for k in want:
            assert flat[k].tobytes() == want[k].tobytes(), k


class _SilentPeer:
    """A data plane whose every receive fails with ``err``."""

    rank, num_processes = 1, 2

    def __init__(self, err):
        self.err = err

    def recv_array(self, src, tag, timeout=None):
        raise self.err


def test_missing_fragment_raises_the_named_error(tmp_path):
    full = _full()
    root = str(tmp_path)
    _save("port", root, 2, 5, full)
    plan = treshard.ReshardPlan(treshard.load_manifest(root, 5, 0), 2)
    with pytest.raises(treshard.ReshardError, match="data plane"):
        treshard.execute_plan(plan, rank=1, root=root, step=5,
                              visibility={0: {0, 1}, 1: set()})
    # with a data plane the fragment is awaited from its source rank, and a
    # peer that never delivers, or dies, is named
    for err, match in ((TimeoutError("late"), "did not deliver"),
                       (ConnectionError("reset"), "died while serving")):
        with pytest.raises(treshard.ReshardError, match=match):
            treshard.execute_plan(plan, rank=1, root=root, step=5,
                                  visibility={0: {0, 1}, 1: set()},
                                  dp=_SilentPeer(err), timeout=0.5)
    with pytest.raises(treshard.ReshardError, match=r"old rank\(s\)"):
        plan.resolve_sources({0: {0}, 1: set()})


def test_plan_summary_matches_jax(tmp_path):
    _save("port", str(tmp_path), 3, 5, _full())
    m = treshard.load_manifest(str(tmp_path), 5, 0)
    assert treshard.plan_summary(m, 2) == jreshard.plan_summary(m, 2)


# ---------------------------------------------------------------------------
# TrainState
# ---------------------------------------------------------------------------

def _tstate(step_val):
    return {"params": {"w": torch.full((4,), float(step_val))},
            "count": torch.tensor(step_val, dtype=torch.int32)}


def test_trainstate_saves_on_cadence_resumes_latest_and_keeps_n(tmp_path):
    root = str(tmp_path)
    with TTrainState(root, save_every=2, keep=2, heartbeat=False) as ts:
        state, start = ts.resume(_tstate(0))
        assert start == 0
        for step in range(7):
            ts.end_step(_tstate(step), step)
    assert tckpt.all_steps(root) == [4, 6]
    with TTrainState(root, save_every=2, keep=2, heartbeat=False) as ts:
        state, start = ts.resume(_tstate(0))
    assert start == 7 and float(state["params"]["w"][0]) == 6.0
    # the JAX TrainState resumes the port's checkpoint alike
    from tpu_dist.resilience import TrainState as JTrainState
    with JTrainState(root, save_every=2, heartbeat=False) as js:
        jstate, jstart = js.resume({"params": {"w": np.zeros(4, np.float32)},
                                    "count": np.int32(0)})
    assert jstart == start and int(jstate["count"]) == 6


def test_trainstate_runs_chaos_after_the_save(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DIST_CHAOS", "raise:step=4")
    root = str(tmp_path)
    with TTrainState(root, save_every=2, heartbeat=False) as ts:
        ts.end_step(_tstate(2), 2)
        with pytest.raises(tchaos.ChaosError):
            ts.end_step(_tstate(4), 4)
    assert tckpt.all_steps(root) == [2, 4]


def test_sharded_trainstate_resumes_at_another_world(tmp_path):
    full = _full()
    root = str(tmp_path)
    for r in range(3):
        with TTrainState(root, save_every=5, keep=3, heartbeat=False,
                         shard=(r, 3), sharded_keys=("zero",)) as ts:
            ts.save({"params": {"w": torch.ones(2)},
                     "zero": _port_state(3, r, full)}, 5)
    for d in range(2):
        tmpl = {"params": {"w": torch.zeros(2)},
                "zero": _port_state(2, d, _full())}
        with TTrainState(root, heartbeat=False, shard=(d, 2),
                         sharded_keys=("zero",)) as ts:
            got, start = ts.resume(tmpl)
        assert start == 6 and torch.equal(got["params"]["w"], torch.ones(2))
        want = _flat({"zero": _port_state(2, d, full)})
        flat = _flat({"zero": got["zero"]})
        for k in want:
            assert flat[k].tobytes() == want[k].tobytes(), k


def test_sharded_same_world_resume_is_the_exact_restore(tmp_path):
    full = _full()
    root = str(tmp_path)
    for r in range(2):
        with TTrainState(root, heartbeat=False, shard=(r, 2),
                         sharded_keys=("zero",)) as ts:
            ts.save({"p": torch.ones(1), "zero": _port_state(2, r, full)}, 3)
    with TTrainState(root, heartbeat=False, shard=(1, 2),
                     sharded_keys=("zero",)) as ts:
        got, start = ts.resume({"p": torch.zeros(1),
                                "zero": _port_state(2, 1, _full())})
    assert start == 4
    for k, v in _flat({"zero": _port_state(2, 1, full)}).items():
        assert _flat({"zero": got["zero"]})[k].tobytes() == v.tobytes()


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_prune_sharded_matches_jax(tmp_path, keep):
    full = _full()
    trees = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        for step, world in ((1, 2), (2, 2), (3, 3), (4, 3)):
            _save(pkg, root, world, step, full)
            (jckpt if pkg == "jax" else tckpt).save(
                root, {"p": np.ones(2, np.float32)}, step=step)
        # step 5: replicated written, one shard missing (a mid-save kill)
        _save(pkg, root, 1, 5, full)
        tckpt.save(root, {"zero": _port_state(2, 0, full)}, step=6,
                   shard=(0, 2))
        tckpt.save(root, {"p": np.ones(2, np.float32)}, step=6)
        trees[pkg] = root
    got = tckpt.prune_sharded(trees["port"], keep)
    want = jckpt.prune_sharded(trees["jax"], keep)
    assert got == want
    assert tckpt.all_steps(trees["port"]) == jckpt.all_steps(trees["jax"])


def test_resume_agreement_is_the_max_of_the_intersection(monkeypatch):
    from tpu_dist_torch.dist.store import TCPStore
    server = TCPStore("127.0.0.1", 0, is_master=True)
    monkeypatch.setenv("TPU_DIST_STORE_ADDR", f"127.0.0.1:{server.port}")
    out, errs = {}, []

    def run(rank, steps):
        try:
            ts = TTrainState("/nonexistent", heartbeat=False,
                             shard=(rank, 2), sharded_keys=("z",))
            out[rank] = ts._agree_resume_step(steps)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(0, {10, 20, 30})),
               threading.Thread(target=run, args=(1, {10, 20}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    server.close()
    assert not errs and out == {0: 20, 1: 20}


def test_trainstate_publishes_ckpt_root(tmp_path, monkeypatch):
    from tpu_dist_torch.dist.store import TCPStore
    server = TCPStore("127.0.0.1", 0, is_master=True)
    monkeypatch.setenv("TPU_DIST_STORE_ADDR", f"127.0.0.1:{server.port}")
    try:
        TTrainState(str(tmp_path), heartbeat=False).close()
        assert server.get("tpu_dist/elastic/ckpt_root").decode() == \
            os.path.abspath(str(tmp_path))
    finally:
        server.close()


def test_sharded_keys_need_a_shard():
    with pytest.raises(ValueError, match="shard="):
        TTrainState("/tmp/x", heartbeat=False, sharded_keys=("z",))


def test_manifest_of_a_tree_without_zero_meta_is_none():
    assert treshard.manifest_from_arrays({"['p']": np.ones(3)}) is None
    arrays = {k: v for k, v in tckpt._flatten(
        {"zero": _jax_state(2, 1, _full())}).items()}
    assert treshard.manifest_from_arrays(arrays) == \
        jreshard.manifest_from_arrays(arrays)
    assert json.loads(json.dumps(treshard.manifest_from_arrays(arrays)))
