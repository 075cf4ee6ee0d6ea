"""The port's dataset readers, synthetic sets, dataset views and samplers
against the JAX package's, on files each test writes.

Everything here is exact (array-equal, index-equal) but one case: an
``ImageFolder`` with ``sample_size=`` resizes through each package's own
resample (the JAX package's native or numpy one, the port's torch one) and
truncates to uint8, so a value may land one step to either side when the
two float32 results straddle an integer: |Δ| <= 1 on at most 0.1% of the
values.  ``download=True`` runs through ``file://`` URLs to archives the
test writes (no network), with their md5 checked and a wrong md5 refused."""

import gzip
import hashlib
import io
import struct
import sys
import tarfile

import numpy as np
import pytest

from tpu_dist import data as jdata
from tpu_dist_torch import data as tdata
from tpu_dist_torch.data import datasets as tdatasets


def _idx(arr: np.ndarray) -> bytes:
    """``arr`` (uint8) in the IDX format."""
    head = struct.pack(">I", 0x0800 | arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    return head + arr.astype(np.uint8).tobytes()


def _mnist_files(n_train=12, n_test=7, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for p, n in (("train", n_train), ("t10k", n_test)):
        out[f"{p}-images-idx3-ubyte"] = _idx(
            rng.integers(0, 256, (n, 28, 28), np.uint8))
        out[f"{p}-labels-idx1-ubyte"] = _idx(
            rng.integers(0, 10, n, np.uint8))
    return out


def _write_mnist(root):
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for name, blob in _mnist_files().items():
        (raw / name).write_bytes(blob)


def _cifar_batches(seed=0):
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    return {name: rng.integers(0, 256, (3 + i, 3073), np.uint8).tobytes()
            for i, name in enumerate(names)}


def _same(ours, theirs):
    assert ours.data.dtype == np.uint8
    assert np.array_equal(ours.data, theirs.data)
    assert np.array_equal(ours.targets, theirs.targets)
    assert ours.targets.dtype == theirs.targets.dtype == np.int64


@pytest.mark.parametrize("train", [True, False])
def test_mnist_idx_reader_matches_jax(tmp_path, train):
    _write_mnist(tmp_path)
    ours = tdata.MNIST(str(tmp_path), train=train)
    _same(ours, jdata.MNIST(str(tmp_path), train=train))
    assert ours.data.shape == ((12 if train else 7), 28, 28, 1)
    x, y = ours.gather(np.array([2, 0]))
    assert np.array_equal(x, ours.data[[2, 0]])


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_binary_reader_matches_jax(tmp_path, train):
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    for name, blob in _cifar_batches().items():
        (d / name).write_bytes(blob)
    ours = tdata.CIFAR10(str(tmp_path), train=train)
    _same(ours, jdata.CIFAR10(str(tmp_path), train=train))
    assert ours.data.shape == ((3 + 4 + 5 + 6 + 7) if train else 8, 32, 32,
                               3)


def test_missing_files_name_the_fallbacks(tmp_path):
    for cls in (tdata.MNIST, tdata.CIFAR10):
        with pytest.raises(FileNotFoundError) as e:
            cls(str(tmp_path), train=False)
        msg = str(e.value)
        assert "missing dataset file" in msg and "download=True" in msg
        assert "synthetic_fallback=True" in msg
    ours = tdata.CIFAR10(str(tmp_path), train=False, synthetic_fallback=True)
    _same(ours, jdata.CIFAR10(str(tmp_path), train=False,
                              synthetic_fallback=True))


def _md5(blob: bytes) -> str:
    return hashlib.md5(blob).hexdigest()


def test_mnist_download_through_file_url(tmp_path, monkeypatch):
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    files = []
    for name, blob in _mnist_files(seed=3).items():
        gz = gzip.compress(blob)
        (mirror / f"{name}.gz").write_bytes(gz)
        files.append((f"{name}.gz", _md5(gz)))
    monkeypatch.setattr(tdatasets, "_MNIST_MIRROR", mirror.as_uri() + "/")
    monkeypatch.setattr(tdatasets, "_MNIST_FILES", tuple(files))
    root = tmp_path / "root"
    ours = tdata.MNIST(str(root), train=True, download=True)
    _same(ours, jdata.MNIST(str(root), train=True))
    # a wrong md5 is refused and leaves no file behind
    bad = tmp_path / "bad"
    monkeypatch.setattr(tdatasets, "_MNIST_FILES",
                        ((files[0][0], "0" * 32),) + tuple(files[1:]))
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        tdata.MNIST(str(bad), download=True)
    assert not list((bad / "MNIST" / "raw").iterdir())
    # an unreachable source names the fallback
    monkeypatch.setattr(tdatasets, "_MNIST_MIRROR",
                        (tmp_path / "nowhere").as_uri() + "/")
    with pytest.raises(RuntimeError, match="synthetic_fallback=True"):
        tdata.MNIST(str(tmp_path / "r2"), download=True)


def test_cifar10_download_through_file_url(tmp_path, monkeypatch):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, blob in _cifar_batches(seed=5).items():
            info = tarfile.TarInfo(f"cifar-10-batches-bin/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    archive = tmp_path / "cifar.tar.gz"
    archive.write_bytes(buf.getvalue())
    monkeypatch.setattr(tdatasets, "_CIFAR10_URL", archive.as_uri())
    monkeypatch.setattr(tdatasets, "_CIFAR10_MD5", _md5(buf.getvalue()))
    root = tmp_path / "root"
    ours = tdata.CIFAR10(str(root), train=False, download=True)
    _same(ours, jdata.CIFAR10(str(root), train=False))
    monkeypatch.setattr(tdatasets, "_CIFAR10_MD5", "f" * 32)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        tdata.CIFAR10(str(tmp_path / "other"), download=True)
    assert not (tmp_path / "other" / tdatasets._CIFAR10_ARCHIVE).exists()


def _image_tree(root, ext, sizes, seed=0):
    from PIL import Image
    rng = np.random.default_rng(seed)
    for c, n in (("cat", 3), ("dog", 2), ("emu", 4)):
        (root / c).mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            if ext == ".npy":
                np.save(root / c / f"{i}.npy", img)
            else:
                Image.fromarray(img).save(root / c / f"{i}{ext}")
    (root / "cat" / "notes.txt").write_text("skipped")


@pytest.mark.parametrize("ext", [".npy", ".png"])
def test_image_folder_matches_jax(tmp_path, ext):
    _image_tree(tmp_path, ext, [(20, 24)])
    ours, theirs = (m.ImageFolder(str(tmp_path)) for m in (tdata, jdata))
    assert ours.classes == theirs.classes == ["cat", "dog", "emu"]
    assert ours.samples == theirs.samples and len(ours) == 9
    idx = np.array([8, 0, 4, 3])
    (xa, ya), (xb, yb) = ours.gather(idx), theirs.gather(idx)
    assert xa.dtype == np.uint8 and np.array_equal(xa, xb)
    assert np.array_equal(ya, yb)
    x, y = ours[5]
    assert np.array_equal(x, theirs[5][0]) and y == theirs[5][1]


def test_image_folder_sample_size(tmp_path):
    _image_tree(tmp_path, ".npy", [(20, 24), (31, 17), (12, 12)], seed=2)
    ours, theirs = (m.ImageFolder(str(tmp_path), sample_size=(16, 18))
                    for m in (tdata, jdata))
    idx = np.arange(9)
    xa, xb = ours.gather(idx)[0], theirs.gather(idx)[0]
    assert xa.shape == xb.shape == (9, 16, 18, 3) and xa.dtype == np.uint8
    diff = np.abs(xa.astype(np.int16) - xb.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_image_folder_without_pil_raises(tmp_path, monkeypatch):
    _image_tree(tmp_path, ".png", [(8, 8)])
    ds = tdata.ImageFolder(str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="requires PIL"):
        ds.gather(np.array([0]))
    with pytest.raises(FileNotFoundError, match="no class"):
        tdata.ImageFolder(str(tmp_path / "cat"))


def test_synthetic_imagenet_is_bit_equal():
    for train in (True, False):
        kw = dict(train=train, n=20, image_size=40, num_classes=7, seed=9)
        ours, theirs = tdata.SyntheticImageNet(**kw), \
            jdata.SyntheticImageNet(**kw)
        assert len(ours) == 20
        assert np.array_equal(ours.targets, theirs.targets)
        idx = np.array([19, 3, 3, 0])
        (xa, ya), (xb, yb) = ours.gather(idx), theirs.gather(idx)
        assert xa.shape == (4, 40, 40, 3) and xa.dtype == np.uint8
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
        assert np.array_equal(ours[7][0], theirs[7][0])


def test_noisy_synthetic_arrays_are_byte_equal():
    for name in ("mnist", "cifar10"):
        for train in (True, False):
            a = getattr(tdata, f"synthetic_{name}_noisy_arrays")(train, 300)
            b = getattr(jdata, f"synthetic_{name}_noisy_arrays")(train, 300)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _base(mod, n=13, seed=0):
    rng = np.random.default_rng(seed)
    return mod.ArrayImageDataset(rng.integers(0, 256, (n, 4, 4, 3), np.uint8),
                                 rng.integers(0, 10, n))


def test_subset_concat_and_random_split_match_jax():
    ours, theirs = _base(tdata), _base(jdata)
    for lengths in ([5, 8], [0.3, 0.7], [0.5, 0.25, 0.25]):
        a = tdata.random_split(ours, lengths, seed=4)
        b = jdata.random_split(theirs, lengths, seed=4)
        assert [s.indices.tolist() for s in a] == \
            [s.indices.tolist() for s in b]
    sub_a, sub_b = tdata.Subset(ours, [7, 2, 9]), jdata.Subset(theirs,
                                                              [7, 2, 9])
    assert np.array_equal(sub_a.gather(np.array([2, 0]))[0],
                          sub_b.gather(np.array([2, 0]))[0])
    cat_a = tdata.ConcatDataset([ours, sub_a, _base(tdata, 5, seed=1)])
    cat_b = jdata.ConcatDataset([theirs, sub_b, _base(jdata, 5, seed=1)])
    assert len(cat_a) == len(cat_b) == 21
    idx = np.array([20, 0, 14, 13, -1, 15])
    for got, want in zip(cat_a.gather(idx), cat_b.gather(idx)):
        assert np.array_equal(got, want)
    assert np.array_equal(cat_a[16][0], cat_b[16][0])
    with pytest.raises(ValueError, match="sum of lengths"):
        tdata.random_split(ours, [3, 3])
    with pytest.raises(IndexError):
        cat_a.gather(np.array([21]))
    with pytest.raises(ValueError, match="differing transforms"):
        tdata.ConcatDataset([tdata.ArrayImageDataset(
            np.zeros((2, 1)), np.zeros(2), transform=object()), ours])
    # a base without gather: the loader collates item by item
    items = tdata.Subset(tdata.TensorDataset(np.arange(6.0), np.arange(6)),
                         [4, 1])
    assert items.gather is None
    assert [b[0].tolist() for b in tdata.DataLoader(items, batch_size=2)] \
        == [[4.0, 1.0]]


def test_weighted_and_subset_samplers_match_jax():
    w = [0.1, 0.0, 2.0, 1.0, 0.5, 3.0]
    for replacement, n in ((True, 10), (False, 4)):
        ours = tdata.WeightedRandomSampler(w, n, replacement, seed=2)
        theirs = jdata.WeightedRandomSampler(w, n, replacement, seed=2)
        for epoch in (0, 1, 5):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs) and len(ours) == n
        if not replacement:
            assert len(set(ours)) == n and 1 not in list(ours)
    ours = tdata.SubsetRandomSampler([9, 4, 7, 1], seed=3)
    theirs = jdata.SubsetRandomSampler([9, 4, 7, 1], seed=3)
    seqs = []
    for epoch in (0, 1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
        seqs.append(list(ours))
    assert sorted(seqs[0]) == [1, 4, 7, 9] and seqs[0] != seqs[1]
    for bad, match in ((([],), "non-empty"), (([1, -1],), "non-negative"),
                       (([0, 0],), "not all be zero")):
        with pytest.raises(ValueError, match=match):
            tdata.WeightedRandomSampler(*bad, num_samples=1)
    with pytest.raises(ValueError, match="distinct"):
        tdata.WeightedRandomSampler([1, 0, 1], 3, replacement=False)
