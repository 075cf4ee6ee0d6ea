"""Batched host-side image transforms — counterpart of
``tpu_dist/data/transforms.py``.

They take batched NHWC numpy arrays, as the JAX package's do, and draw
their randomness from an explicit ``numpy.random.Generator`` in the same
order, so a batch comes out byte-equal to the JAX package's for the same
seed, rank, epoch and batch.  The loader transposes to NCHW once, when it
collates the batch into a tensor.

``RandomResizedCrop`` and ``Resize`` resample through
:func:`bilinear_crop_resize`, one torch function over NHWC tensors (the
JAX package's half-pixel-centred separable maths), which
``DeviceAugment`` runs on the card; here it runs on CPU tensors over the
numpy batch, whose draws stay numpy's."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Transform", "Compose", "ToFloat", "Normalize", "RandomCrop",
           "RandomHorizontalFlip", "RandomResizedCrop", "Resize",
           "CenterCrop", "bilinear_crop_resize", "MNIST_MEAN", "MNIST_STD",
           "CIFAR10_MEAN", "CIFAR10_STD", "IMAGENET_MEAN", "IMAGENET_STD"]

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


def bilinear_crop_resize(x: torch.Tensor, top: torch.Tensor,
                         left: torch.Tensor, crop_h: torch.Tensor,
                         crop_w: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample per-image boxes ``(top, left, crop_h, crop_w)`` (each (N,)
    float) of ``x`` (N, H, W, C) to ``out_hw``, bilinearly, in float32:
    half-pixel-centred source coordinates clamped to the image, rows
    interpolated first (one gather of whole rows), then columns, as the JAX
    package's ``bilinear_crop_resize`` computes it.  Runs where ``x`` is."""
    x = x.float()
    n, h, w, _ = x.shape
    oh, ow = out_hw
    f32 = dict(dtype=torch.float32, device=x.device)
    top, left, crop_h, crop_w = (v.to(**f32) for v in (top, left, crop_h,
                                                       crop_w))
    # 0-d tensor divisors: CUDA divides by a Python number as a multiply
    # by its reciprocal, which rounds otherwise than the CPU's division
    step_h = crop_h[:, None] / torch.full((), float(oh), **f32)
    step_w = crop_w[:, None] / torch.full((), float(ow), **f32)
    ys = (top[:, None] + (torch.arange(oh, **f32)[None, :] + 0.5) * step_h
          - 0.5).clamp(0.0, h - 1.0)                            # (N, oh)
    xs = (left[:, None] + (torch.arange(ow, **f32)[None, :] + 0.5) * step_w
          - 0.5).clamp(0.0, w - 1.0)                            # (N, ow)
    y0 = ys.floor()
    x0 = xs.floor()
    wy = (ys - y0)[:, :, None, None]                            # (N, oh, 1, 1)
    wx = (xs - x0)[:, None, :, None]                            # (N, 1, ow, 1)
    y0, x0 = y0.long(), x0.long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    b = torch.arange(n, device=x.device)
    rows = x[b[:, None], y0] * (1 - wy) + x[b[:, None], y1] * wy
    bb = b[:, None, None]
    rr = torch.arange(oh, device=x.device)[None, :, None]
    return (rows[bb, rr, x0[:, None, :]] * (1 - wx)
            + rows[bb, rr, x1[:, None, :]] * wx)


def _resample(x: np.ndarray, top, left, crop_h, crop_w,
              out_hw) -> np.ndarray:
    """:func:`bilinear_crop_resize` over a numpy batch and float32 boxes."""
    boxes = [torch.from_numpy(np.asarray(v, np.float32))
             for v in (top, left, crop_h, crop_w)]
    return bilinear_crop_resize(torch.from_numpy(np.asarray(x, np.float32)),
                                *boxes, out_hw).numpy()


class RandomResizedCrop(Transform):
    """Random scale and aspect crop resized to ``size`` (torchvision's
    semantics: area in ``scale``·A, log-uniform aspect in ``ratio``; a draw
    that does not fit shrinks to the largest box of its aspect).  One
    vectorized draw per image, from ``rng`` in the JAX package's order."""

    def __init__(self, size: _Size, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.size = _pair(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, x, rng=None):
        rng = self._require_rng(rng)
        n, h, w, _ = x.shape
        area = h * w
        target = area * rng.uniform(self.scale[0], self.scale[1], n)
        aspect = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1]), n))
        cw = np.sqrt(target * aspect)
        ch = np.sqrt(target / aspect)
        bad = (cw > w) | (ch > h)
        shrink = np.minimum(w / np.maximum(cw, 1e-6),
                            h / np.maximum(ch, 1e-6))
        cw = np.where(bad, cw * shrink, cw)
        ch = np.where(bad, ch * shrink, ch)
        top = rng.uniform(0, 1, n) * (h - ch)
        left = rng.uniform(0, 1, n) * (w - cw)
        return _resample(x, top, left, ch, cw, self.size)


class Resize(Transform):
    """Bilinear resize of the whole image to ``size`` (int → square)."""

    def __init__(self, size: _Size):
        self.size = _pair(size)

    def __call__(self, x, rng=None):
        n, h, w, _ = x.shape
        if (h, w) == self.size:
            return np.asarray(x, np.float32)
        z = np.zeros(n, np.float32)
        return _resample(x, z, z, np.full(n, h, np.float32),
                         np.full(n, w, np.float32), self.size)


class CenterCrop(Transform):
    """The central ``size`` window of every image."""

    def __init__(self, size: _Size):
        self.size = _pair(size)

    def __call__(self, x, rng=None):
        _, h, w, _ = x.shape
        th, tw = self.size
        if th > h or tw > w:
            raise ValueError(f"crop {self.size} larger than input ({h}, {w})")
        i = (h - th) // 2
        j = (w - tw) // 2
        return x[:, i:i + th, j:j + tw, :]
