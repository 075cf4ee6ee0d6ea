"""The port's data path and spawn against the JAX package's.

Everything here is exact: the ``DistributedSampler`` index lists over a grid
of (n, world, rank, epoch, shuffle, drop_last), the synthetic MNIST and
CIFAR-10 arrays (byte for byte), the batched transforms and the
``DataLoader`` batches for a given seed, rank and epoch (byte for byte after
the NHWC → NCHW transpose, with and without worker threads), and the
``DeviceLoader`` on the CPU (including each rank's slice with
``local_shards=False``).  ``spawn`` must run two workers and bring a child's
exception back with its traceback."""

import itertools
import operator
import os
import time

import numpy as np
import pytest
import torch

from tpu_dist import data as jdata
from tpu_dist.data import transforms as jtransforms
from tpu_dist_torch import data as tdata
from tpu_dist_torch.data import transforms as ttransforms
from tpu_dist_torch.dist import ProcessGroup
from tpu_dist_torch.launch import (ProcessExitedException,
                                   ProcessRaisedException, spawn)


class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n", [1, 7, 10, 13, 64])
def test_distributed_sampler_index_lists_match_jax(n):
    for world, shuffle, drop_last, epoch in itertools.product(
            (1, 2, 3, 4), (False, True), (False, True), (0, 1)):
        for rank in range(world):
            kw = dict(num_replicas=world, rank=rank, shuffle=shuffle,
                      seed=5, drop_last=drop_last)
            ours = tdata.DistributedSampler(_Len(n), **kw)
            theirs = jdata.DistributedSampler(_Len(n), **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs), (world, rank, kw, epoch)
            assert len(ours) == len(theirs)


def test_sampler_set_world_and_defaults():
    s = tdata.DistributedSampler(_Len(10), num_replicas=2, rank=0)
    s.set_world(2, 3)
    want = jdata.DistributedSampler(_Len(10), num_replicas=3, rank=2)
    assert list(s) == list(want)
    with pytest.raises(ValueError, match="rank"):
        s.set_world(3, 3)
    # no group: world 1, rank 0
    assert list(tdata.DistributedSampler(_Len(5), shuffle=False)) == \
        list(range(5))
    r = tdata.RandomSampler(_Len(9), seed=3)
    r.set_epoch(2)
    j = jdata.RandomSampler(_Len(9), seed=3)
    j.set_epoch(2)
    assert list(r) == list(j)
    b = tdata.BatchSampler(tdata.SequentialSampler(_Len(7)), 3, False)
    assert list(b) == [[0, 1, 2], [3, 4, 5], [6]] and len(b) == 3


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_synthetic_arrays_are_byte_equal(name):
    ours = getattr(tdata, f"synthetic_{name}_arrays")
    theirs = getattr(jdata, f"synthetic_{name}_arrays")
    for train, n in ((True, 5000), (False, 4097)):
        (xa, ya), (xb, yb) = ours(train, n), theirs(train, n)
        assert xa.dtype == np.uint8 and xa.shape == xb.shape
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
        assert ya.dtype == np.int64


def test_synthetic_chunking_keeps_the_stream():
    from tpu_dist_torch.data.datasets import _synthetic_arrays
    a = _synthetic_arrays(50, (4, 4), 3, 10, (1, 2), 1, chunk=7)
    b = _synthetic_arrays(50, (4, 4), 3, 10, (1, 2), 1, chunk=4096)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_datasets_with_synthetic_fallback():
    ours = tdata.MNIST("unused", train=False, synthetic_fallback=True)
    theirs = jdata.MNIST("unused", train=False, synthetic_fallback=True)
    assert ours.data.shape == (10000, 28, 28, 1)
    assert np.array_equal(ours.data, theirs.data)
    assert np.array_equal(ours.targets, theirs.targets)
    x, y = ours.gather(np.array([3, 1]))
    assert np.array_equal(x, theirs.data[[3, 1]]) and list(y) == list(
        theirs.targets[[3, 1]])
    # without files or the fallback, the readers name both ways out
    for cls in (tdata.CIFAR10, tdata.MNIST):
        with pytest.raises(FileNotFoundError,
                           match="missing dataset file.*download=True.*"
                                 "synthetic_fallback=True"):
            cls("nowhere", train=False)
    ds = tdata.TensorDataset(np.arange(4), np.arange(4) * 2)
    assert len(ds) == 4 and ds[2] == (2, 4)
    with pytest.raises(ValueError, match="size mismatch"):
        tdata.TensorDataset(np.arange(4), np.arange(3))


def _aug(mod):
    return mod.Compose([mod.RandomCrop(32, padding=4),
                        mod.RandomHorizontalFlip(),
                        mod.Normalize(mod.CIFAR10_MEAN, mod.CIFAR10_STD)])


def test_transforms_are_byte_equal():
    x = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                          dtype=np.uint8)
    xf = x.astype(np.float32) / 255.0
    a = _aug(ttransforms)(xf, np.random.default_rng(9))
    b = _aug(jtransforms)(xf, np.random.default_rng(9))
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(ttransforms.ToFloat()(x), jtransforms.ToFloat()(x))
    assert ttransforms.MNIST_MEAN == jtransforms.MNIST_MEAN
    assert ttransforms.CIFAR10_STD == jtransforms.CIFAR10_STD
    with pytest.raises(ValueError, match="rng"):
        ttransforms.RandomCrop(32, 4)(x)
    flip = ttransforms.RandomHorizontalFlip(p=1.0)(x)
    assert np.array_equal(flip, x[:, :, ::-1])


def _datasets(n=23):
    x, y = jdata.synthetic_cifar10_arrays(True, n)
    return (tdata.ArrayImageDataset(x, y, transform=_aug(ttransforms)),
            jdata.ArrayImageDataset(x, y, transform=_aug(jtransforms)))


@pytest.mark.parametrize("workers", [0, 2], ids=["inline", "threads"])
def test_dataloader_batches_are_byte_equal(workers):
    ours_ds, theirs_ds = _datasets()
    for rank, epoch in ((0, 0), (1, 0), (1, 3)):
        kw = dict(num_replicas=2, rank=rank, shuffle=True, seed=1)
        ours = tdata.DataLoader(ours_ds, batch_size=4, seed=7,
                                num_workers=workers,
                                sampler=tdata.DistributedSampler(
                                    ours_ds, **kw))
        theirs = jdata.DataLoader(theirs_ds, batch_size=4, seed=7,
                                  sampler=jdata.DistributedSampler(
                                      theirs_ds, **kw))
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == 3
        for (xa, ya), (xb, yb) in zip(got, want):
            assert isinstance(xa, torch.Tensor) and xa.is_contiguous()
            assert xa.shape[1:] == (3, 32, 32)
            assert np.array_equal(xa.numpy(), xb.transpose(0, 3, 1, 2))
            assert np.array_equal(ya.numpy(), yb)


def test_dataloader_collates_items_without_gather():
    ds = tdata.TensorDataset(np.arange(10, dtype=np.float32),
                             np.arange(10) % 3)
    batches = list(tdata.DataLoader(ds, batch_size=4))
    assert [b[0].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                               [8, 9]]
    assert batches[2][1].tolist() == [2, 0]


def test_device_loader_is_exact_on_cpu():
    ours_ds, _ = _datasets()
    loader = tdata.DataLoader(ours_ds, batch_size=5, seed=2)
    want = list(loader)
    got = list(tdata.DeviceLoader(loader, device="cpu", prefetch=2))
    assert len(got) == len(want) == 5
    for (xa, ya), (xb, yb) in zip(got, want):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
    # local_shards=False: each rank keeps its contiguous ceil(b/world) rows
    # of the identical global batch (the last batch has 3 rows)
    for world in (2, 3):
        parts = []
        for rank in range(world):
            group = ProcessGroup(world, rank, torch.device("cpu"), None)
            dl = tdata.DeviceLoader(loader, group=group, local_shards=False)
            parts.append(list(dl))
        for i, (xb, yb) in enumerate(want):
            per = -(-xb.shape[0] // world)
            for rank in range(world):
                xa, ya = parts[rank][i]
                rows = slice(rank * per, (rank + 1) * per)
                assert torch.equal(xa, xb[rows]) and torch.equal(ya, yb[rows])
            assert sum(parts[r][i][0].shape[0] for r in range(world)) == \
                xb.shape[0]


def test_device_loader_propagates_errors_and_stops_early():
    class Boom(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("boom at 5")
            return np.float32(i), i

    dl = tdata.DeviceLoader(tdata.DataLoader(Boom(), batch_size=2),
                            device="cpu")
    it = iter(dl)
    assert next(it)[0].tolist() == [0.0, 1.0]
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)
    # abandoning an iterator releases its fill thread
    ours_ds, _ = _datasets()
    it = iter(tdata.DeviceLoader(tdata.DataLoader(ours_ds, batch_size=2),
                                 device="cpu", prefetch=1))
    next(it)
    it.close()
    # augment= runs on the staged raw batch; its errors reach the consumer
    raw = tdata.DataLoader(ours_ds, batch_size=4, to_float=False)
    got = list(tdata.DeviceLoader(raw, device="cpu",
                                  augment=tdata.DeviceAugment.cifar10(32)))
    assert len(got) == 6 and got[0][0].shape == (4, 3, 32, 32)
    assert got[0][0].dtype == torch.float32
    assert torch.equal(got[0][1], next(iter(raw))[1])

    def broken(x, key, rows):
        raise KeyError("augment failed")

    with pytest.raises(KeyError, match="augment failed"):
        list(tdata.DeviceLoader(raw, device="cpu", augment=broken))


def test_device_loader_warns_without_distributed_sampler():
    ours_ds, _ = _datasets()
    group = ProcessGroup(2, 0, torch.device("cpu"), None)
    with pytest.warns(UserWarning, match="DistributedSampler"):
        tdata.DeviceLoader(tdata.DataLoader(ours_ds), group=group)


_FLAKY = """
import os, sys, time

def flaky(i, out, failing_generations):
    gen = int(os.environ["TPU_DIST_RESTART_COUNT"])
    open(os.path.join(out, f"g{gen}_r{i}"), "w").close()
    if i == 1 and gen < failing_generations:
        # the join's fail-fast terminates rank 0 once rank 1 exits: wait,
        # with a bound, until rank 0 has left its marker of this generation
        mark = os.path.join(out, f"g{gen}_r0")
        deadline = time.monotonic() + 30
        while not os.path.exists(mark) and time.monotonic() < deadline:
            time.sleep(0.01)
        sys.exit(3)
"""


def test_spawn_runs_workers_and_reports_a_child_exception(capfd, tmp_path,
                                                          monkeypatch):
    # standard-library targets keep the children's imports cheap: child i
    # prints i, computes i / 0, or exits with code i; the restart target
    # is a module of a few lines on the children's path
    spawn(print, args=("spawned",), nprocs=2)
    out = capfd.readouterr().out.split("\n")
    assert "0 spawned" in out and "1 spawned" in out
    with pytest.raises(ProcessRaisedException) as e:
        spawn(operator.truediv, args=(0,), nprocs=2)
    assert "Traceback" in str(e.value)
    assert "ZeroDivisionError" in str(e.value)
    with pytest.raises(ProcessExitedException, match="exit code 1") as e:
        spawn(os._exit, nprocs=2)
    assert e.value.error_index == 1 and e.value.exit_code == 1
    ctx = spawn(time.sleep, nprocs=1, join=False)
    assert ctx.join(timeout=60) is True
    assert len(ctx.pids()) == 1
    # max_restarts: generation 0 fails, generation 1 finishes; a world
    # that keeps failing raises once the budget is spent; the parent's
    # environment is left as it was
    (tmp_path / "spawn_flaky.py").write_text(_FLAKY)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delenv("TPU_DIST_RESTART_COUNT", raising=False)
    from spawn_flaky import flaky
    spawn(flaky, args=(str(tmp_path), 1), nprocs=2, max_restarts=1,
          restart_backoff=0.01)
    assert sorted(p.name for p in tmp_path.glob("g*")) == [
        "g0_r0", "g0_r1", "g1_r0", "g1_r1"]
    with pytest.raises(ProcessExitedException, match="exit code 3") as e:
        spawn(flaky, args=(str(tmp_path), 99), nprocs=2, max_restarts=1,
              restart_backoff=0.01)
    assert e.value.exit_code == 3
    assert "TPU_DIST_RESTART_COUNT" not in os.environ
    with pytest.raises(ValueError, match="join=True"):
        spawn(time.sleep, nprocs=1, join=False, max_restarts=1)
