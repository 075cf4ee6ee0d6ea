"""Datasets — counterpart of ``tpu_dist/data/datasets.py`` (the part the
examples use).

Images are held as one contiguous uint8 NHWC array, as in the JAX package,
so the DataLoader gathers a whole batch with one fancy index and the
batched transforms run on it; the loader transposes to NCHW.  ``MNIST`` and
``CIFAR10`` take the deterministic synthetic stand-ins with
``synthetic_fallback=True``, byte-equal to the JAX package's; the on-disk
readers (MNIST IDX, CIFAR-10 binary) and ``download=True`` come with the
rest of the data module (ROADMAP A4)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["Dataset", "TensorDataset", "ArrayImageDataset", "MNIST",
           "CIFAR10", "synthetic_mnist_arrays", "synthetic_cifar10_arrays"]


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


class _Synthetic(ArrayImageDataset):
    _make = None
    _files = ""

    def __init__(self, root: str, train: bool = True, transform=None,
                 synthetic_fallback: Optional[bool] = None,
                 download: bool = False):
        self.root = root
        self.train = train
        if download:
            raise NotImplementedError(
                "download=True comes with the dataset readers of ROADMAP "
                "A4; pass synthetic_fallback=True")
        if not synthetic_fallback:
            raise FileNotFoundError(
                f"the port reads no {self._files} files from {root!r} yet "
                f"(the readers are ROADMAP A4); pass synthetic_fallback=True "
                f"to use the deterministic SYNTHETIC stand-in")
        data, targets = type(self)._make(train)
        super().__init__(data, targets, transform=transform)


class MNIST(_Synthetic):
    """MNIST, (n, 28, 28, 1) uint8 NHWC: the synthetic stand-in with
    ``synthetic_fallback=True``; otherwise raises ``FileNotFoundError``."""
    _make = staticmethod(synthetic_mnist_arrays)
    _files = "MNIST IDX"


class CIFAR10(_Synthetic):
    """CIFAR-10, (n, 32, 32, 3) uint8 NHWC: the synthetic stand-in with
    ``synthetic_fallback=True``; otherwise raises ``FileNotFoundError``."""
    _make = staticmethod(synthetic_cifar10_arrays)
    _files = "CIFAR-10 binary"
