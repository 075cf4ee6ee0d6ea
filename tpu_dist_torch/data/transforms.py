"""Batched host-side image transforms — counterpart of
``tpu_dist/data/transforms.py``.

They take batched NHWC numpy arrays, as the JAX package's do, and draw
their randomness from an explicit ``numpy.random.Generator`` in the same
order, so a batch comes out byte-equal to the JAX package's for the same
seed, rank, epoch and batch.  The loader transposes to NCHW once, when it
collates the batch into a tensor.  ``RandomResizedCrop``, ``Resize`` and
``CenterCrop`` come with the rest of the data module (ROADMAP A4)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Transform", "Compose", "ToFloat", "Normalize", "RandomCrop",
           "RandomHorizontalFlip", "MNIST_MEAN", "MNIST_STD", "CIFAR10_MEAN",
           "CIFAR10_STD", "IMAGENET_MEAN", "IMAGENET_STD"]

MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_Size = Union[int, Tuple[int, int]]


def _pair(size: _Size) -> Tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    return (int(size[0]), int(size[1]))


class Transform:
    """Base: callable on a batched NHWC array, with an optional generator."""

    def __call__(self, x: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        raise NotImplementedError

    def _require_rng(self, rng):
        if rng is None:
            raise ValueError(
                f"{type(self).__name__} is stochastic and requires an rng "
                "(numpy.random.Generator); the DataLoader supplies one "
                "per (rank, epoch, batch)")
        return rng


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, x, rng=None):
        for t in self.transforms:
            x = t(x, rng)
        return x

    def __repr__(self):
        return f"Compose({self.transforms!r})"


class ToFloat(Transform):
    """uint8 [0, 255] → float32 [0, 1] (torch ``ToTensor``'s scaling)."""

    def __call__(self, x, rng=None):
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return np.asarray(x, np.float32)


class Normalize(Transform):
    """Channel-wise ``(x - mean) / std`` over the trailing C axis."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        if np.any(self.std == 0):
            raise ValueError("std must be non-zero in every channel")

    def __call__(self, x, rng=None):
        return (np.asarray(x, np.float32) - self.mean) / self.std


class RandomCrop(Transform):
    """Zero-pad by ``padding``, then crop a random ``size`` window per image
    (torchvision's ``RandomCrop(32, padding=4)``, one offset per image)."""

    def __init__(self, size: _Size, padding: int = 0):
        self.size = _pair(size)
        self.padding = int(padding)

    def __call__(self, x, rng=None):
        rng = self._require_rng(rng)
        n, h, w, _ = x.shape
        p = self.padding
        th, tw = self.size
        if p:
            x = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
            h, w = h + 2 * p, w + 2 * p
        if th > h or tw > w:
            raise ValueError(f"crop {self.size} larger than padded input "
                             f"({h}, {w})")
        top = rng.integers(0, h - th + 1, size=n)
        left = rng.integers(0, w - tw + 1, size=n)
        rows = top[:, None] + np.arange(th)[None, :]
        cols = left[:, None] + np.arange(tw)[None, :]
        bidx = np.arange(n)[:, None, None]
        return x[bidx, rows[:, :, None], cols[:, None, :]]


class RandomHorizontalFlip(Transform):
    """Flip each image left-right independently with probability ``p``."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def __call__(self, x, rng=None):
        if self.p <= 0.0:
            return x
        flipped = x[:, :, ::-1, :]
        if self.p >= 1.0:
            return flipped
        rng = self._require_rng(rng)
        mask = rng.random(x.shape[0]) < self.p
        return np.where(mask[:, None, None, None], flipped, x)
