"""Datasets — counterpart of ``tpu_dist/data/datasets.py``.

Images are held as one contiguous uint8 NHWC array, as in the JAX package,
so the DataLoader gathers a whole batch with one fancy index and the
batched transforms run on it; the loader transposes to NCHW.  ``MNIST``
(IDX files) and ``CIFAR10`` (the binary batches) read the standard on-disk
formats, fetch them with ``download=True`` (checksummed), or take the
deterministic synthetic stand-ins with ``synthetic_fallback=True``;
``ImageFolder`` reads a ``root/<class>/<image>`` tree (``.npy`` natively,
other formats through PIL where it can be imported); ``SyntheticImageNet``
builds ImageNet-shaped images lazily.  Every array, split and stand-in is
byte-equal to the JAX package's for the same arguments."""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import tarfile
from typing import Optional, Tuple

import numpy as np

__all__ = ["Dataset", "TensorDataset", "ArrayImageDataset", "MNIST",
           "CIFAR10", "ImageFolder", "SyntheticImageNet", "Subset",
           "ConcatDataset", "random_split", "synthetic_mnist_arrays",
           "synthetic_cifar10_arrays", "synthetic_mnist_noisy_arrays",
           "synthetic_cifar10_noisy_arrays"]


class Dataset:
    """Abstract map-style dataset.  Subclasses may provide ``gather(indices)
    -> (batch_x, batch_y)`` for the DataLoader's vectorized batch path."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Tuple-of-arrays dataset (torch ``TensorDataset`` semantics)."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("TensorDataset needs at least one array")
        n = len(arrays[0])
        for a in arrays[1:]:
            if len(a) != n:
                raise ValueError(
                    f"size mismatch: {len(a)} vs {n} along dim 0")
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


class ArrayImageDataset(Dataset):
    """(images, targets) held as whole arrays, NHWC; vectorized ``gather``."""

    def __init__(self, data: np.ndarray, targets: np.ndarray, transform=None):
        if len(data) != len(targets):
            raise ValueError(f"size mismatch: {len(data)} images vs "
                             f"{len(targets)} targets")
        self.data = data
        self.targets = np.asarray(targets)
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], self.targets[i]

    def gather(self, indices: np.ndarray):
        return self.data[indices], self.targets[indices]


class Subset(Dataset):
    """View of ``dataset`` at ``indices`` (torch ``Subset``).  Keeps the
    base's vectorized ``gather`` (the indices compose by fancy indexing) and
    its ``transform``; over a base without ``gather`` the attribute is None,
    so the loader collates item by item."""

    def __init__(self, dataset: Dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        if self.indices.ndim != 1:
            raise ValueError(f"indices must be 1-D, got shape "
                             f"{self.indices.shape}")
        self.transform = getattr(dataset, "transform", None)
        if getattr(dataset, "gather", None) is None:
            self.gather = None

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def gather(self, indices: np.ndarray):
        return self.dataset.gather(self.indices[np.asarray(indices)])


class ConcatDataset(Dataset):
    """Concatenation of datasets (torch ``ConcatDataset``).  ``gather``
    exists when every child has one: the indices are bucketed by child,
    gathered, and put back in batch order.  The children share one
    ``transform`` object or none: the loader applies it to whole batches,
    so differing transforms raise here instead of being dropped."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])
        tfs = [getattr(d, "transform", None) for d in self.datasets]
        if any(t is not tfs[0] for t in tfs):
            raise ValueError(
                "children carry differing transforms; batch-level "
                "augmentation cannot honor per-child transforms — share "
                "one transform object across children (or none)")
        self.transform = tfs[0]
        if any(getattr(d, "gather", None) is None for d in self.datasets):
            self.gather = None

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def _locate(self, i: int):
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"index {i} out of range for {len(self)}")
        d = int(np.searchsorted(self.cumulative_sizes, i, side="right"))
        start = 0 if d == 0 else int(self.cumulative_sizes[d - 1])
        return d, i - start

    def __getitem__(self, i):
        d, local = self._locate(int(i))
        return self.datasets[d][local]

    def gather(self, indices: np.ndarray):
        indices = np.asarray(indices, dtype=np.int64)
        indices = np.where(indices < 0, indices + len(self), indices)
        if ((indices < 0) | (indices >= len(self))).any():
            raise IndexError(f"gather indices out of range for {len(self)}")
        which = np.searchsorted(self.cumulative_sizes, indices, side="right")
        starts = np.concatenate([[0], self.cumulative_sizes[:-1]])
        parts_x, parts_y, order = [], [], []
        for d in np.unique(which):
            sel = np.flatnonzero(which == d)
            x, y = self.datasets[int(d)].gather(indices[sel] - starts[d])
            parts_x.append(x)
            parts_y.append(y)
            order.append(sel)
        order = np.concatenate(order)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return np.concatenate(parts_x)[inv], np.concatenate(parts_y)[inv]


def random_split(dataset: Dataset, lengths, seed: int = 0):
    """Non-overlapping ``Subset``s of the given lengths (torch
    ``random_split``; fractions summing to 1 are scaled, the remainder
    dealt round-robin).  Deterministic given ``seed``: every rank passes the
    same seed and gets the same split."""
    lengths = list(lengths)
    if lengths and all(0.0 < float(l) <= 1.0 for l in lengths) \
            and abs(sum(float(l) for l in lengths) - 1.0) < 1e-6:
        n = len(dataset)
        sizes = [int(np.floor(n * float(f))) for f in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError(f"sum of lengths {sum(lengths)} != dataset size "
                         f"{len(dataset)}")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out


def _synthetic_arrays(n: int, hw: Tuple[int, int], channels: int,
                      num_classes: int, seed, split,
                      chunk: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Class templates from ``seed`` alone (shared by the train and test
    splits), then per-sample targets and noise from ``(*seed, split)``: the
    JAX package's draws in its order.  The noise is drawn and added
    ``chunk`` images at a time (a generator's stream does not depend on how
    its draws are split), which keeps the float64 sum to one chunk's size."""
    templates = np.random.default_rng(seed).normal(
        128.0, 40.0, (num_classes, *hw, channels))
    rng = np.random.default_rng((*seed, int(split)))
    targets = rng.integers(0, num_classes, n)
    data = np.empty((n, *hw, channels), np.uint8)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        noise = rng.standard_normal((hi - lo, *hw, channels),
                                    dtype=np.float32) * 32.0
        data[lo:hi] = np.clip(templates[targets[lo:hi]] + noise, 0, 255)
    return data, targets.astype(np.int64)


def synthetic_mnist_arrays(train: bool, n: Optional[int] = None):
    """Deterministic MNIST-shaped data: (n, 28, 28, 1) uint8 and int64
    labels, byte-equal to the JAX package's."""
    if n is None:
        n = 60000 if train else 10000
    return _synthetic_arrays(n, (28, 28), 1, 10, (0xDA7A, 0), int(train))


def synthetic_cifar10_arrays(train: bool, n: Optional[int] = None):
    """Deterministic CIFAR-shaped data: (n, 32, 32, 3) uint8 and int64
    labels, byte-equal to the JAX package's."""
    if n is None:
        n = 50000 if train else 10000
    return _synthetic_arrays(n, (32, 32), 3, 10, (0xDA7A, 1), int(train))


def _noisy_labels(y: np.ndarray, stream: int, train: bool,
                  label_noise: float) -> np.ndarray:
    """Each label replaced, with probability ``label_noise``, by a uniform
    draw over the 10 classes, from the stream ``(0xDA7A, stream, train)``."""
    rng = np.random.default_rng((0xDA7A, stream, int(train)))
    flip = rng.random(len(y)) < label_noise
    return np.where(flip, rng.integers(0, 10, len(y)), y).astype(np.int64)


def synthetic_mnist_noisy_arrays(train: bool, n: Optional[int] = None,
                                 label_noise: float = 0.25):
    """The low-SNR accuracy oracle over the MNIST-shaped set: the labels of
    :func:`synthetic_mnist_arrays` flipped uniformly with probability
    ``label_noise`` (train and test alike), so no model can score above
    ``(1 - label_noise) + label_noise / 10`` in expectation on the test
    split, and one that learned the classes scores that."""
    if n is None:
        n = 60000 if train else 10000
    x, y = synthetic_mnist_arrays(train, n)
    return x, _noisy_labels(y, 2, train, label_noise)


def synthetic_cifar10_noisy_arrays(train: bool, n: Optional[int] = None,
                                   label_noise: float = 0.25):
    """The same oracle over the CIFAR-shaped set."""
    if n is None:
        n = 50000 if train else 10000
    x, y = synthetic_cifar10_arrays(train, n)
    return x, _noisy_labels(y, 3, train, label_noise)


# ---------------------------------------------------------------------------
# the on-disk readers and download=True
# ---------------------------------------------------------------------------

def _download_file(url: str, dest: str, md5: Optional[str] = None) -> None:
    """Fetch ``url`` to ``dest`` through ``dest + ".part"``, checking its md5
    when given; a failed fetch or a wrong checksum leaves no file and
    raises ``RuntimeError``."""
    import urllib.error
    import urllib.request
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"download of {url} failed ({e}); this environment may have no "
            "network egress — place the files under the dataset root "
            "manually, or construct the dataset with synthetic_fallback=True"
        ) from e
    if md5 is not None:
        h = hashlib.md5()
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != md5:
            os.remove(tmp)
            raise RuntimeError(f"checksum mismatch for {url}: "
                               f"{h.hexdigest()} != {md5}")
    os.replace(tmp, dest)


# (gz name, md5 of the gz): torchvision's MNIST resource list
_MNIST_FILES = (
    ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
    ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432"),
    ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3"),
    ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c"),
)
_MNIST_MIRROR = "https://storage.googleapis.com/cvdf-datasets/mnist/"

_CIFAR10_ARCHIVE = "cifar-10-binary.tar.gz"
_CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-binary.tar.gz"
_CIFAR10_MD5 = "c32a1d4ab5d03f1284b67883e8d87530"


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST on-disk format): a big-endian magic
    whose low byte is the rank, the dims, then the uint8 data."""
    with open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


class _OnDisk(ArrayImageDataset):
    """A dataset read from ``root``, fetched first with ``download=True``,
    or the deterministic synthetic stand-in with ``synthetic_fallback``."""

    _synthetic = None

    def __init__(self, root: str, train: bool = True, transform=None,
                 synthetic_fallback: Optional[bool] = None,
                 download: bool = False):
        self.root = root
        self.train = train
        if synthetic_fallback:
            data, targets = type(self)._synthetic(train)
        else:
            if download:
                self._download(root)
            try:
                data, targets = self._load(root, train)
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"{e}; pass download=True to fetch it, or "
                    f"synthetic_fallback=True to use the deterministic "
                    f"SYNTHETIC stand-in") from e
        super().__init__(data, targets, transform=transform)


class MNIST(_OnDisk):
    """MNIST from the IDX files under ``{root}/MNIST/raw/``, (n, 28, 28, 1)
    uint8 NHWC; ``download=True`` fetches and gunzips them first."""

    _synthetic = staticmethod(synthetic_mnist_arrays)
    _raw_subdir = os.path.join("MNIST", "raw")

    def _load(self, root, train):
        raw = os.path.join(root, self._raw_subdir)
        p = "train" if train else "t10k"
        img_p = os.path.join(raw, f"{p}-images-idx3-ubyte")
        lbl_p = os.path.join(raw, f"{p}-labels-idx1-ubyte")
        for path in (img_p, lbl_p):
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing dataset file {path}")
        return _read_idx(img_p)[..., None], _read_idx(lbl_p).astype(np.int64)

    def _download(self, root):
        raw = os.path.join(root, self._raw_subdir)
        for gz_name, md5 in _MNIST_FILES:
            out = os.path.join(raw, gz_name[:-3])
            if os.path.exists(out):
                continue
            gz_path = os.path.join(raw, gz_name)
            if not os.path.exists(gz_path):
                _download_file(_MNIST_MIRROR + gz_name, gz_path, md5)
            with gzip.open(gz_path, "rb") as f_in, open(out, "wb") as f_out:
                f_out.write(f_in.read())


class CIFAR10(_OnDisk):
    """CIFAR-10 from the binary batches under ``{root}/cifar-10-batches-bin/``
    (records of 1 label byte and 3×32×32 planar RGB), (n, 32, 32, 3) uint8
    NHWC; ``download=True`` fetches and unpacks the archive first."""

    _synthetic = staticmethod(synthetic_cifar10_arrays)
    _bin_subdir = "cifar-10-batches-bin"

    def _load(self, root, train):
        d = os.path.join(root, self._bin_subdir)
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        imgs, lbls = [], []
        for name in names:
            p = os.path.join(d, name)
            if not os.path.exists(p):
                raise FileNotFoundError(f"missing dataset file {p}")
            rec = np.fromfile(p, np.uint8).reshape(-1, 3073)
            lbls.append(rec[:, 0])
            imgs.append(rec[:, 1:].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
        return (np.ascontiguousarray(np.concatenate(imgs)),
                np.concatenate(lbls).astype(np.int64))

    def _download(self, root):
        d = os.path.join(root, self._bin_subdir)
        if os.path.exists(os.path.join(d, "data_batch_1.bin")):
            return
        archive = os.path.join(root, _CIFAR10_ARCHIVE)
        if not os.path.exists(archive):
            _download_file(_CIFAR10_URL, archive, _CIFAR10_MD5)
        with tarfile.open(archive, "r:gz") as tf:
            # filter="data" refuses path traversal and special members
            tf.extractall(root, filter="data")


class ImageFolder(Dataset):
    """A ``root/<class>/<image>`` tree (torchvision's ``ImageFolder``
    layout), classes in sorted order.  ``.npy`` files (HWC uint8) load
    natively; other formats need PIL, and raise without it.
    ``sample_size=(h, w)`` resizes every image as it loads (``Resize``), so
    a batch stacks for the vectorized gather."""

    _IMG_EXT = (".npy", ".png", ".jpg", ".jpeg", ".bmp", ".ppm")

    def __init__(self, root: str, transform=None,
                 sample_size: Optional[Tuple[int, int]] = None):
        self.root = root
        self.transform = transform
        self.sample_size = sample_size
        self.classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(self._IMG_EXT):
                    self.samples.append((os.path.join(cdir, name),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images found under {root} "
                                    f"(extensions: {self._IMG_EXT})")
        self.targets = np.asarray([y for _, y in self.samples], np.int64)

    def __len__(self):
        return len(self.samples)

    def _load(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            arr = np.load(path)
        else:
            try:
                from PIL import Image
            except ImportError as e:
                raise RuntimeError(
                    f"decoding {path} requires PIL; convert images to .npy "
                    "(HWC uint8) for the PIL-free path") from e
            with Image.open(path) as im:
                arr = np.asarray(im.convert("RGB"))
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.sample_size and arr.shape[:2] != tuple(self.sample_size):
            from .transforms import Resize
            arr = Resize(self.sample_size)(arr[None].astype(np.float32))[0]
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

    def __getitem__(self, i):
        path, y = self.samples[i]
        return self._load(path), y

    def gather(self, indices: np.ndarray):
        xs = [self._load(self.samples[int(i)][0]) for i in indices]
        return np.stack(xs), self.targets[indices]


class SyntheticImageNet(Dataset):
    """Deterministic ImageNet-shaped stand-in: ``n`` images of
    ``image_size``²×3, each its class's 16×16 template (from ``seed``
    alone, shared by the train and test splits) upsampled by repetition
    plus noise from ``(seed, train, index)``, built at gather time so a
    large set is never held whole."""

    _TPL = 16  # the templates' edge

    def __init__(self, train: bool = True, n: int = 1024,
                 image_size: int = 224, num_classes: int = 1000,
                 transform=None, seed: int = 0xA1A):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.transform = transform
        self._seed = (seed, int(train))
        self._templates = np.random.default_rng((seed,)).normal(
            128.0, 45.0, (num_classes, self._TPL, self._TPL, 3)
        ).astype(np.float32)
        self.targets = np.random.default_rng(self._seed).integers(
            0, num_classes, n).astype(np.int64)

    def __len__(self):
        return self.n

    def _upsampled(self, classes: np.ndarray) -> np.ndarray:
        k = -(-self.image_size // self._TPL)
        t = self._templates[classes]
        t = np.repeat(np.repeat(t, k, axis=1), k, axis=2)
        return t[:, :self.image_size, :self.image_size, :]

    def gather(self, indices: np.ndarray):
        indices = np.asarray(indices, np.int64)
        base = self._upsampled(self.targets[indices])
        s = self.image_size
        out = np.empty((len(indices), s, s, 3), np.uint8)
        for k, i in enumerate(indices):
            r = np.random.default_rng((*self._seed, int(i)))
            noise = r.standard_normal((s, s, 3), dtype=np.float32) * 25.0
            out[k] = np.clip(base[k] + noise, 0, 255)
        return out, self.targets[indices]

    def __getitem__(self, i):
        x, y = self.gather(np.asarray([i]))
        return x[0], y[0]
