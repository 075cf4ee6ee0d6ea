"""The port's image resampling, host resize transforms and augmentation
(``DeviceAugment``, ``DeviceLoader(augment=)``) against the JAX package's.

Tolerances:

- the resample against ``tpu_dist.data.transforms._bilinear_crop_resize_numpy``
  on the same boxes: atol 1e-5 on [0, 1] inputs (the same float32
  interpolation, rows and columns taken in the other order);
- the host transforms against the JAX package's with the same ``rng``: the
  same numpy draws, so atol 1e-5 for the resampling ones and exact for
  ``CenterCrop``;
- ``DeviceAugment`` against the JAX package's with the same key: the crop
  and flip decisions equal (integer crops and flips exactly, boxes within
  float32 rounding: JAX's ``exp`` and torch's differ in the last bit), the
  images within atol 1e-4 after normalization, and a bf16 output within one
  bf16 step of the value besides;
- ``DeviceLoader(augment=)`` over two epochs at world 1, and at world 2 (two
  gloo ranks, each with its ``DistributedSampler`` shard, against the JAX
  loader over a two-device mesh whose global batch is the ranks' rows in
  rank order): the same limits.  This holds the per-rank rule: a rank
  draws for the global batch and keeps its rows."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import data as jdata
from tpu_dist.data import transforms as jtransforms
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist_torch import data as tdata
from tpu_dist_torch import random as trandom
from tpu_dist_torch.data import transforms as ttransforms

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4


def _bf16_step(v):
    """bf16's spacing at |v| (float32 numpy)."""
    mag = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, bf16=False):
    """``got`` (port, NCHW tensor) against ``want`` (JAX, NHWC array)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32)).transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    limit = ATOL + (_bf16_step(want) if bf16 else 0.0)
    err = np.abs(got - want)
    assert (err <= limit).all(), float((err - limit).max())


def _boxes(rng, n, h, w):
    top = rng.uniform(-3, h, n).astype(np.float32)
    left = rng.uniform(-3, w, n).astype(np.float32)
    ch = rng.uniform(1, h + 4, n).astype(np.float32)
    cw = rng.uniform(1, w + 4, n).astype(np.float32)
    return top, left, ch, cw


@pytest.mark.parametrize("shape,out", [((4, 37, 29, 3), (16, 20)),
                                       ((3, 8, 8, 1), (24, 24)),
                                       ((2, 64, 48, 3), (7, 5))])
def test_resample_matches_numpy_oracle(shape, out):
    """Boxes inside, across and outside the image (clamped coordinates),
    down- and upsampling."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape).astype(np.float32)
    boxes = _boxes(rng, shape[0], *shape[1:3])
    want = jtransforms._bilinear_crop_resize_numpy(x, *boxes, out)
    got = tdata.bilinear_crop_resize(
        torch.from_numpy(x), *(torch.from_numpy(b) for b in boxes), out)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_host_transforms_match_jax():
    x = np.random.default_rng(0).random((6, 40, 30, 3)).astype(np.float32)
    for size in (24, (20, 28)):
        for name in ("RandomResizedCrop", "Resize"):
            a = getattr(ttransforms, name)(size)(x, np.random.default_rng(4))
            b = getattr(jtransforms, name)(size)(x, np.random.default_rng(4))
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        a = ttransforms.CenterCrop(size)(x)
        assert np.array_equal(a, jtransforms.CenterCrop(size)(x))
    # the example's host pipeline, composed
    pipe = [m.Compose([m.RandomResizedCrop(16, scale=(0.3, 1.0)),
                       m.RandomHorizontalFlip(),
                       m.Normalize(m.IMAGENET_MEAN, m.IMAGENET_STD)])
            for m in (ttransforms, jtransforms)]
    np.testing.assert_allclose(pipe[0](x, np.random.default_rng(8)),
                               pipe[1](x, np.random.default_rng(8)),
                               rtol=0, atol=1e-4)
    assert ttransforms.Resize(30)(x[:, :30]).dtype == np.float32
    with pytest.raises(ValueError, match="rng"):
        ttransforms.RandomResizedCrop(8)(x)
    with pytest.raises(ValueError, match="larger"):
        ttransforms.CenterCrop(41)(x)


AUGMENTS = {
    "imagenet": lambda m, **kw: m.DeviceAugment.imagenet(24, **kw),
    "imagenet_eval": lambda m, **kw: m.DeviceAugment.imagenet_eval(
        24, resize=32, **kw),
    "cifar10": lambda m, **kw: m.DeviceAugment.cifar10(32, **kw),
    "pad_crop_no_pad": lambda m, **kw: m.DeviceAugment(
        16, mode="pad_crop", **kw),
    "none": lambda m, **kw: m.DeviceAugment(40, mode="none", flip_p=0.3,
                                            **kw),
    "resized_crop_full_scale": lambda m, **kw: m.DeviceAugment(
        24, scale=(0.9, 1.0), ratio=(0.5, 2.0), flip_p=1.0, **kw),
}


def _jax_draws(aug, key, n, h, w):
    """The JAX ``DeviceAugment``'s draws, as its ``_build`` makes them."""
    k_area, k_ar, k_top, k_left, k_flip = jax.random.split(key, 5)
    out = {"flip": np.asarray(jax.random.uniform(k_flip, (n,)))}
    if aug.mode == "resized_crop":
        lo, hi = aug.scale
        target = h * w * jax.random.uniform(k_area, (n,), minval=lo,
                                            maxval=hi)
        aspect = jnp.exp(jax.random.uniform(
            k_ar, (n,), minval=np.log(aug.ratio[0]),
            maxval=np.log(aug.ratio[1])))
        cw, ch = jnp.sqrt(target * aspect), jnp.sqrt(target / aspect)
        bad = (cw > w) | (ch > h)
        shrink = jnp.minimum(w / jnp.maximum(cw, 1e-6),
                             h / jnp.maximum(ch, 1e-6))
        cw = jnp.where(bad, cw * shrink, cw)
        ch = jnp.where(bad, ch * shrink, ch)
        out["box"] = np.stack([
            np.asarray(jax.random.uniform(k_top, (n,)) * (h - ch)),
            np.asarray(jax.random.uniform(k_left, (n,)) * (w - cw)),
            np.asarray(ch), np.asarray(cw)])
    elif aug.mode == "pad_crop":
        ph, pw = h + 2 * aug.padding, w + 2 * aug.padding
        oh, ow = aug.size
        out["tl"] = np.stack([
            np.asarray(jax.random.randint(k_top, (n,), 0, ph - oh + 1)),
            np.asarray(jax.random.randint(k_left, (n,), 0, pw - ow + 1))])
    return out


@pytest.mark.parametrize("name", sorted(AUGMENTS))
@pytest.mark.parametrize("raw", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_augment_matches_jax(name, raw, dtype):
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 256, (12, 40, 36, 3), np.uint8)
    if not raw:
        x = x.astype(np.float32) / 255.0
    ja = AUGMENTS[name](jdata, dtype=getattr(jnp, dtype))
    ta = AUGMENTS[name](tdata, dtype=getattr(torch, dtype))
    for seed in (0, 5):
        key = jax.random.fold_in(jax.random.key(seed), 3)
        tkey = trandom.fold_in(trandom.key(seed), 3)
        want = ja(jnp.asarray(x), key)
        got = ta(torch.from_numpy(x), tkey)
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, bf16=dtype == "bfloat16")
        # the same crop and flip decisions
        d = ta.draws(tkey, 40, 36, (0, 12))
        jd = _jax_draws(ja, key, 12, 40, 36)
        if ta.mode == "center_crop":
            assert d is None
            continue
        np.testing.assert_array_equal(d[-1].numpy() < ta.flip_p,
                                      jd["flip"] < ta.flip_p)
        if ta.mode == "resized_crop":
            np.testing.assert_allclose(d[:4].numpy(), jd["box"], rtol=2e-6,
                                       atol=1e-5)
        elif ta.mode == "pad_crop":
            np.testing.assert_array_equal(d[:2].numpy(), jd["tl"])


def test_device_augment_invariants_and_refusals():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (6, 32, 40, 3), np.uint8))
    key = trandom.key(2)
    # a forced flip mirrors the unflipped result of the same draws
    flip = tdata.DeviceAugment.imagenet(16, flip_p=1.0)(x, key)
    keep = tdata.DeviceAugment.imagenet(16, flip_p=0.0)(x, key)
    assert torch.equal(flip, keep.flip(3))
    # the eval resample ignores its key
    ev = tdata.DeviceAugment.imagenet_eval(16, resize=24)
    assert torch.equal(ev(x, key), ev(x, trandom.key(9)))
    # a pad_crop window is an integer crop of the padded image
    crop = tdata.DeviceAugment(32, mode="pad_crop", padding=4, flip_p=0.0,
                               mean=(0.0,) * 3, std=(1.0,) * 3)
    out = crop(x, key)
    top, left, _ = crop.draws(key, 32, 40, (0, 6)).long()
    padded = torch.nn.functional.pad(x.float() / torch.tensor(255.0),
                                     (0, 0, 4, 4, 4, 4))
    for i in range(6):
        t, l = int(top[i]), int(left[i])
        assert torch.equal(out[i], padded[i, t:t + 32, l:l + 32]
                           .permute(2, 0, 1))
    # rows of a global batch: the draws of the whole, this part's rows
    whole = tdata.DeviceAugment.imagenet(16)(x, key)
    part = tdata.DeviceAugment.imagenet(16)(x[2:5], key, rows=(2, 6))
    assert torch.equal(part, whole[2:5])
    with pytest.raises(ValueError, match="unknown mode"):
        tdata.DeviceAugment(8, mode="crop")
    with pytest.raises(ValueError, match="resize"):
        tdata.DeviceAugment(8, mode="center_crop")
    with pytest.raises(ValueError, match="larger"):
        tdata.DeviceAugment(48, mode="pad_crop", padding=2)(x, key)
    with pytest.raises(ValueError, match="rows"):
        tdata.DeviceAugment.imagenet(16)(x, key, rows=(3, 6))


def _arrays(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 40, 36, 3), np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


def test_dataloader_raw_batches():
    x, y = _arrays()
    ours = tdata.DataLoader(tdata.ArrayImageDataset(x, y), batch_size=8,
                            shuffle=True, seed=3, to_float=False)
    theirs = jdata.DataLoader(jdata.ArrayImageDataset(x, y), batch_size=8,
                              shuffle=True, seed=3, to_float=False)
    for (xa, ya), (xb, yb) in zip(ours, theirs):
        assert xa.dtype == torch.uint8 and xa.shape[1:] == (40, 36, 3)
        assert np.array_equal(xa.numpy(), xb)
        assert np.array_equal(ya.numpy(), yb)
    with pytest.raises(ValueError, match="gather"):
        tdata.DataLoader(tdata.TensorDataset(np.zeros(4), np.zeros(4)),
                         to_float=False)


def test_device_loader_augment_matches_jax_over_two_epochs():
    x, y = _arrays()
    aug = {"imagenet": lambda m: m.DeviceAugment.imagenet(24),
           "cifar10": lambda m: m.DeviceAugment.cifar10(32)}
    for name, make in aug.items():
        jl = jdata.DeviceLoader(
            jdata.DataLoader(jdata.ArrayImageDataset(x, y), batch_size=8,
                             shuffle=True, seed=3, to_float=False),
            group=JaxGroup(jax.devices()[:1]), augment=make(jdata),
            augment_seed=5)
        tl = tdata.DeviceLoader(
            tdata.DataLoader(tdata.ArrayImageDataset(x, y), batch_size=8,
                             shuffle=True, seed=3, to_float=False),
            device="cpu", augment=make(tdata), augment_seed=5)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == 3
            for (xa, ya), (xb, yb) in zip(got, want):
                _close(xa, xb)
                assert np.array_equal(ya.numpy(), np.asarray(yb))
        # the epochs draw differently
        tl.set_epoch(0)
        first = next(iter(tl))[0]
        tl.set_epoch(1)
        assert not torch.equal(first, next(iter(tl))[0])


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import data, dist

    rank, port, inp, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(1)
    d = np.load(inp)
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank, device="cpu",
                                 timeout=120)
    ds = data.ArrayImageDataset(d["x"], d["y"])
    res = {}
    train = data.DeviceLoader(
        data.DataLoader(ds, batch_size=4, drop_last=True, to_float=False,
                        sampler=data.DistributedSampler(ds, seed=3)),
        group=pg, augment=data.DeviceAugment.imagenet(24), augment_seed=5)
    evl = data.DeviceLoader(
        data.DataLoader(ds, batch_size=6, to_float=False), group=pg,
        local_shards=False, augment=data.DeviceAugment.cifar10(32),
        augment_seed=7)
    for epoch in (0, 1):
        train.set_epoch(epoch)
        for i, (xb, yb) in enumerate(train):
            res[f"t{epoch}.{i}.x"] = xb.numpy()
            res[f"t{epoch}.{i}.y"] = yb.numpy()
    for i, (xb, yb) in enumerate(evl):
        res[f"e{i}.x"] = xb.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


class _RankOrder(jdata.Sampler):
    """The JAX loader's global batches: each step's rows of rank 0, then of
    rank 1, from the port's two ``DistributedSampler`` shards."""

    def __init__(self, n, per, epoch):
        shards = []
        for r in range(2):
            s = tdata.DistributedSampler(range(n), num_replicas=2, rank=r,
                                         seed=3)
            s.set_epoch(epoch)
            shards.append(list(s))
        steps = len(shards[0]) // per
        self.order = [i for k in range(steps) for s in shards
                      for i in s[k * per:(k + 1) * per]]

    def __iter__(self):
        return iter(self.order)

    def __len__(self):
        return len(self.order)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_device_loader_augment_world2_matches_jax_mesh(tmp_path):
    x, y = _arrays(18, seed=4)
    np.savez(tmp_path / "in.npz", x=x, y=y)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port),
         str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        finally:
            p.kill()
        assert p.returncode == 0, err
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    group = JaxGroup(jax.devices()[:2])
    ds = jdata.ArrayImageDataset(x, y)
    for epoch in (0, 1):
        jl = jdata.DeviceLoader(
            jdata.DataLoader(ds, batch_size=8, to_float=False,
                             sampler=_RankOrder(18, 4, epoch)),
            group=group, augment=jdata.DeviceAugment.imagenet(24),
            augment_seed=5)
        jl.set_epoch(epoch)
        batches = list(jl)
        assert len(batches) == 2
        for i, (xb, yb) in enumerate(batches):
            xb, yb = np.asarray(xb), np.asarray(yb)
            for r in range(2):
                rows = slice(4 * r, 4 * r + 4)
                _close(torch.from_numpy(ranks[r][f"t{epoch}.{i}.x"]),
                       xb[rows])
                assert np.array_equal(ranks[r][f"t{epoch}.{i}.y"], yb[rows])
    # local_shards=False: every rank draws for the identical global batch
    # of 6 and keeps its 3 rows
    jl = jdata.DeviceLoader(jdata.DataLoader(ds, batch_size=6,
                                             to_float=False),
                            group=group, local_shards=False,
                            augment=jdata.DeviceAugment.cifar10(32),
                            augment_seed=7)
    for i, (xb, _) in enumerate(jl):
        for r in range(2):
            _close(torch.from_numpy(ranks[r][f"e{i}.x"]),
                   np.asarray(xb)[3 * r:3 * r + 3])
