"""The port's checkpoint module against the JAX package's: the same
directory format, written by either package and restored (``verify=True``)
by the other, on a nested dict / list / NamedTuple tree of float32, int32,
uint32 and int8 leaves; its refusals; and the port's own resume paths.

Values cross bit for bit (the tests compare with ``array_equal``); the two
packages' ``tree.json`` files agree on every field but the digest (the
npz's zip entries carry their write time)."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import checkpoint as jckpt
from tpu_dist_torch import checkpoint as tckpt
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.models import TransformerLM
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = Path(__file__).resolve().parent.parent


class Pair(NamedTuple):
    first: object
    second: object


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "layers": [
            {"count": rng.integers(-5, 5, (2,)).astype(np.int32),
             "q": rng.integers(-128, 127, (2, 3)).astype(np.int8)},
            Pair(rng.integers(0, 2 ** 32 - 1, (4,), dtype=np.uint32),
                 np.float32(rng.standard_normal())),
        ],
        "b": {"z": np.zeros((0, 2), np.float32),
              "a": rng.standard_normal((5,)).astype(np.float32)},
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, Pair):
        return Pair(*(_map(fn, v) for v in tree))
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _torch_tree(seed=0):
    return _map(lambda a: torch.from_numpy(np.array(a)), _numpy_tree(seed))


def _assert_tree_equal(got, want):
    assert type(got) is type(want)
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _meta(path):
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    meta.pop("arrays_sha256")
    return meta


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    path = tckpt.save(str(tmp_path / "port"), _torch_tree(), step=7,
                      metadata={"run": "a"})
    got = jckpt.restore(str(tmp_path / "port"), template=_numpy_tree(1),
                        verify=True)
    _assert_tree_equal(_map(np.asarray, got),
                       _map(np.asarray, _numpy_tree(0)))
    # the JAX package writes the same tree.json for the same tree
    jpath = jckpt.save(str(tmp_path / "jax"),
                       _map(jnp.asarray, _numpy_tree()), step=7,
                       metadata={"run": "a"})
    assert _meta(path) == _meta(jpath)
    assert list(_meta(path)["leaves"]) == list(_meta(jpath)["leaves"])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jckpt.save(str(tmp_path), _map(jnp.asarray, _numpy_tree(2)), step=3)
    got = tckpt.restore(str(tmp_path), template=_torch_tree(), verify=True)
    assert isinstance(got["layers"][1], Pair)
    _assert_tree_equal(got, _torch_tree(2))
    # a numpy template takes numpy leaves
    got = tckpt.restore(str(tmp_path), template=_numpy_tree(), step=3,
                        verify=True)
    _assert_tree_equal(_map(np.asarray, got),
                       _map(np.asarray, _numpy_tree(2)))


def test_bfloat16_leaves_round_trip_by_the_recorded_dtype(tmp_path):
    """numpy has no bfloat16: the port writes 2-byte voids with "bfloat16"
    in tree.json, as the JAX package does, and reads them back by that
    dtype, from its own directory and from the JAX package's (which the
    JAX package itself cannot restore, ROADMAP C5)."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    tckpt.save(str(tmp_path / "port"), {"x": x, "y": torch.ones(2)}, step=0)
    meta = _meta(os.path.join(tmp_path / "port", "step_00000000"))
    assert meta["leaves"]["['x']"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "port" / "step_00000000" / "arrays.npz") as z:
        assert z["['x']"].dtype == np.dtype("V2")
    got = tckpt.restore(str(tmp_path / "port"),
                        {"x": torch.zeros(3, 5, dtype=torch.bfloat16),
                         "y": torch.zeros(2)}, verify=True)
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jckpt.save(str(tmp_path / "jax"), {"x": jx}, step=0)
    got = tckpt.restore(str(tmp_path / "jax"),
                        {"x": torch.zeros(3, 5, dtype=torch.bfloat16)},
                        verify=True)
    assert torch.equal(got["x"], x)
    with pytest.raises(ValueError, match="dtype"):
        tckpt.restore(str(tmp_path / "port"),
                      {"x": torch.zeros(3, 5), "y": torch.zeros(2)})


@pytest.mark.parametrize("fault", ["digest", "missing", "extra", "shape",
                                   "dtype"])
def test_refusals_match_the_jax_package(tmp_path, fault):
    """Each fault is refused by both packages, on either package's
    directory."""
    for writer in ("port", "jax"):
        root = str(tmp_path / writer)
        if writer == "port":
            tckpt.save(root, _torch_tree(), step=1)
        else:
            jckpt.save(root, _map(jnp.asarray, _numpy_tree()), step=1)
        t_tmpl, j_tmpl = _torch_tree(), _numpy_tree()
        if fault == "digest":
            npz = os.path.join(root, "step_00000001", "arrays.npz")
            data = bytearray(open(npz, "rb").read())
            data[len(data) // 2] ^= 0xFF
            open(npz, "wb").write(bytes(data))
            for restore, tmpl, err in (
                    (tckpt.restore, t_tmpl, tckpt.DigestError),
                    (jckpt.restore, j_tmpl, jckpt.DigestError)):
                with pytest.raises(err, match="digest"):
                    restore(root, tmpl, verify=True)
            continue
        if fault == "missing":
            del t_tmpl["w"], j_tmpl["w"]
        elif fault == "extra":
            t_tmpl["new"] = torch.zeros(1)
            j_tmpl["new"] = np.zeros(1, np.float32)
        elif fault == "shape":
            t_tmpl["w"] = torch.zeros(4, 3)
            j_tmpl["w"] = np.zeros((4, 3), np.float32)
        else:
            t_tmpl["w"] = torch.zeros(3, 4, dtype=torch.float64)
            j_tmpl["w"] = np.zeros((3, 4), np.float64)
        match = {"missing": "missing", "extra": "extra", "shape": "shape",
                 "dtype": "dtype"}[fault]
        for restore, tmpl in ((tckpt.restore, t_tmpl),
                              (jckpt.restore, j_tmpl)):
            with pytest.raises(ValueError, match=match):
                restore(root, tmpl, verify=True)


def test_steps_keep_metadata_and_empty_root(tmp_path):
    root = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(root, {"a": torch.zeros(2)})
    for s in (1, 5, 3, 9):
        tckpt.save(root, {"a": torch.full((2,), float(s))}, step=s, keep=3,
                   metadata={"s": s})
    assert tckpt.all_steps(root) == jckpt.all_steps(root) == [3, 5, 9]
    assert tckpt.latest_step(root) == 9
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    got = tckpt.restore(root, {"a": torch.zeros(2)}, step=5)
    assert torch.equal(got["a"], torch.full((2,), 5.0))
    assert _meta(os.path.join(root, "step_00000009"))["metadata"] == {"s": 9}
    assert not [n for n in os.listdir(root) if n.startswith(".tmp")]


def test_shard_coordinates(tmp_path):
    root = str(tmp_path)
    tree = {"m": torch.arange(4.0)}
    for rank in range(2):
        path = tckpt.save(root, {"m": tree["m"] + rank}, step=2,
                          shard=(rank, 2))
        assert path == os.path.join(tckpt.shard_root(root, rank),
                                    "step_00000002")
    assert tckpt.shard_root(root, 1) == jckpt.shard_root(root, 1)
    got = tckpt.restore(root, tree, shard=(1, 2), verify=True)
    assert torch.equal(got["m"], tree["m"] + 1)
    # the JAX package reads the port's shard, coordinates and all
    got = jckpt.restore(root, {"m": np.zeros(4, np.float32)}, shard=(1, 2))
    np.testing.assert_array_equal(got["m"], np.arange(4.0) + 1)
    with pytest.raises(ValueError, match="rank 1 of world 2"):
        tckpt.restore(root, tree, shard=(1, 4))


class TestAsyncCheckpointer:
    def test_snapshot_isolated_from_in_place_updates(self, tmp_path):
        """The port's train_step updates its tensors in place: the write
        must hold what the state was when save() was called."""
        a = torch.zeros(1024)
        b = np.zeros(8, np.float32)
        with tckpt.AsyncCheckpointer(str(tmp_path)) as ckpt:
            ckpt.save({"a": a, "b": b, "c": a.to(torch.bfloat16)}, step=0)
            a.add_(7.0)
            b += 3.0
        got = tckpt.restore(str(tmp_path),
                            {"a": torch.ones(1024), "b": np.ones(8,
                                                                 np.float32),
                             "c": torch.ones(1024, dtype=torch.bfloat16)})
        assert not got["a"].any() and not got["b"].any()
        assert not got["c"].float().any()

    def test_interchange_errors_and_close(self, tmp_path):
        with tckpt.AsyncCheckpointer(str(tmp_path), keep=2) as ckpt:
            for s in range(4):
                ckpt.save(_torch_tree(s), step=s)
        assert tckpt.all_steps(str(tmp_path)) == [2, 3]
        got = jckpt.restore(str(tmp_path), _numpy_tree(), verify=True)
        _assert_tree_equal(_map(np.asarray, got),
                           _map(np.asarray, _numpy_tree(3)))
        ckpt = tckpt.AsyncCheckpointer(str(tmp_path / "f"))
        (tmp_path / "f").write_text("a file where the root should be")
        ckpt.save({"a": torch.zeros(1)}, step=0)
        with pytest.raises(OSError):
            ckpt.wait()
        ckpt.close()
        with pytest.raises(RuntimeError, match="closed"):
            ckpt.save({"a": torch.zeros(1)}, step=1)


def test_graceful_shutdown_flag_and_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with tckpt.GracefulShutdown() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested and stop.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == before


def test_train_state_keys_and_a_bit_exact_resume(tmp_path):
    """A DDP TrainState (AdamW with a schedule, dropout-free LM) plus an EMA
    saved mid-run and restored into a fresh DDP continues bit for bit like
    the uninterrupted run; the key paths are keystr's."""
    def build():
        model = TransformerLM(vocab_size=13, dim=16, depth=1, num_heads=2,
                              max_seq_len=8, device="cpu")
        return TorchDDP(model, optimizer=toptim.AdamW(
            lr=toptim.warmup_cosine(0.05, 2, 6)), loss_fn=tnn.CrossEntropyLoss(),
            accum_steps=2)

    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 13, (4, 8)))
               for _ in range(6)]
    ema = toptim.EMA(0.9)

    def run(ddp, state, ema_state, steps):
        for x in steps:
            state, _ = ddp.train_step(state, x, x)
            ema.update(ema_state, state.params)
        return state, ema_state

    ddp = build()
    state = ddp.init(seed=0)
    full, full_ema = run(ddp, state, ema.init(state.params), batches)
    want = {k: v.clone() for k, v in full.params.items()}

    ddp = build()
    state = ddp.init(seed=0)
    state, ema_state = run(ddp, state, ema.init(state.params), batches[:3])
    with tckpt.AsyncCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save({"state": state, "ema": ema_state}, step=state.step)
    keys = _meta(os.path.join(tmp_path, "step_00000003"))["leaves"]
    assert ".params['head.weight']" not in keys
    assert "['state'].params['head.weight']" in keys
    assert "['state'].opt_state['m']['head.weight']" in keys
    assert "['state'].opt_state['step']" in keys
    assert "['state'].step" in keys and "['state'].rng" in keys
    assert "['ema']['shadow']['head.weight']" in keys
    assert keys["['state'].opt_state['step']"]["dtype"] == "int32"

    fresh = build()
    template = {"state": fresh.init(seed=1), "ema": ema.init(
        dict(fresh.module.named_parameters()))}
    got = tckpt.restore(str(tmp_path), template, verify=True,
                        device=tckpt.devices(template))
    assert got["state"].step == 3 and isinstance(got["state"].step, int)
    state, ema_state = run(fresh, got["state"], got["ema"], batches[3:])
    for k, v in state.params.items():
        assert torch.equal(v, want[k]), k
    for tree in ("m", "v"):
        for k, v in state.opt_state[tree].items():
            assert torch.equal(v, full.opt_state[tree][k]), (tree, k)
    assert int(state.opt_state["step"]) == int(full.opt_state["step"]) == 6
    for k, v in ema_state["shadow"].items():
        assert torch.equal(v, full_ema["shadow"][k]), k
    assert int(ema_state["step"]) == 6


def _run_example(module, *argv, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)  # one process, no rendezvous
    return subprocess.run(
        [sys.executable, "-m", f"tpu_dist_torch.examples.{module}", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_example_mp_checkpoint_and_resume(tmp_path):
    """The twin of ``tests/test_checkpoint.py``'s example round trip: train,
    checkpoint, resume from the latest step."""
    base = ("--device", "cpu", "--synthetic", "--epochs", "1",
            "--batch-size", "32", "--checkpoint-dir", str(tmp_path))
    r1 = _run_example("example_mp", *base, "--max-steps", "3",
                      "--checkpoint-every", "2")
    assert r1.returncode == 0, r1.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    r2 = _run_example("example_mp", *base, "--max-steps", "2", "--resume")
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "resumed from step 3" in r2.stdout
    assert "step_00000005" in os.listdir(tmp_path)
    r3 = _run_example("example_mp", "--device", "cpu", "--synthetic",
                      "--resume")
    assert r3.returncode != 0 and "--resume requires --checkpoint-dir" in \
        r3.stderr
