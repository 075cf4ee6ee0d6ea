"""Image augmentation on the card — counterpart of
``tpu_dist/data/device_augment.py``.

The host ships raw uint8 NHWC batches (``DataLoader(to_float=False)``: a
gather and a copy, a quarter of float32's bytes); the crop, flip and
normalize run here as plain tensor operations (gathers and element-wise
ops) on the device the batch is on, and the batch leaves in NCHW, the
layout of the port's models and host loader, in ``dtype``.  Everything is
computed in float32 and cast once at the end.

The draws are the JAX package's: ``split(key, 5)`` into the area, aspect,
top, left and flip keys, then ``uniform`` and ``randint`` of
:mod:`tpu_dist_torch.random`, which equal ``jax.random``'s bit for bit, so
for the same key the crop boxes and flips are the JAX package's.  They are
made on the host (a few hundred tiny integer ops, each a launch on the
card) and reach the card as one small non-blocking copy, so a batch gives
the same boxes wherever its images are.  JAX
augments a *global* batch with one key: image ``i``'s draws are row ``i``
of each ``(N,)`` draw, N the global batch.  A rank that holds rows
``[offset, offset + n)`` of it passes ``rows=(offset, N)``: it draws for
all N and keeps its own rows (``DeviceLoader`` does this)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import random
from .transforms import (CIFAR10_MEAN, CIFAR10_STD, IMAGENET_MEAN,
                         IMAGENET_STD, _pair, bilinear_crop_resize)

__all__ = ["DeviceAugment", "bilinear_crop_resize"]

MODES = ("resized_crop", "center_crop", "pad_crop", "none")


class DeviceAugment:
    """Augmentation of a raw uint8 (or float in [0, 1]) NHWC batch on its
    device; returns NCHW in ``dtype``.

    - ``mode="resized_crop"``: torchvision's RandomResizedCrop (area in
      ``scale``·A, log-uniform aspect in ``ratio``, an infeasible draw
      shrunk to the largest box of its aspect), then a horizontal flip with
      probability ``flip_p``, then Normalize.
    - ``"center_crop"``: ``Resize(resize)`` + ``CenterCrop(size)`` as one
      resample of the central box of the original image (no draws).
    - ``"pad_crop"``: zero-pad by ``padding``, an integer RandomCrop, flip,
      Normalize (torchvision's ``RandomCrop(32, padding=4)``).
    - ``"none"``: flip and Normalize only."""

    def __init__(self, size, mode: str = "resized_crop",
                 scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 padding: int = 0, flip_p: float = 0.5,
                 resize: Optional[int] = None,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD,
                 dtype: torch.dtype = torch.float32):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
        if mode == "center_crop" and not resize:
            raise ValueError("mode='center_crop' needs resize=")
        self.size = _pair(size)
        self.mode = mode
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.padding = int(padding)
        self.flip_p = float(flip_p)
        self.resize = resize
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.dtype = dtype
        self._norm = {}

    @classmethod
    def imagenet(cls, size: int = 224, dtype=torch.float32, **kw):
        """RandomResizedCrop(size) + flip + ImageNet Normalize."""
        return cls(size, mode="resized_crop", mean=IMAGENET_MEAN,
                   std=IMAGENET_STD, dtype=dtype, **kw)

    @classmethod
    def imagenet_eval(cls, size: int = 224, resize: int = 256,
                      dtype=torch.float32, **kw):
        """torchvision's evaluation pipeline, ``Resize(resize)`` +
        ``CenterCrop(size)``, as one resample: the central box of the
        original image whose short side is ``size/resize`` of the image's.
        No draws: the key is accepted and ignored."""
        return cls(size, mode="center_crop", resize=resize, flip_p=0.0,
                   mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=dtype, **kw)

    @classmethod
    def cifar10(cls, size: int = 32, padding: int = 4, dtype=torch.float32,
                **kw):
        """Pad + RandomCrop(size) + flip + CIFAR-10 Normalize."""
        return cls(size, mode="pad_crop", padding=padding,
                   mean=CIFAR10_MEAN, std=CIFAR10_STD, dtype=dtype, **kw)

    def draws(self, key: torch.Tensor, h: int, w: int,
              rows: Tuple[int, int]) -> Optional[torch.Tensor]:
        """This batch's draws on the host, one row per image: ``(top, left,
        crop_h, crop_w, flip)`` for ``resized_crop``, ``(top, left, flip)``
        for ``pad_crop``, ``(flip,)`` for ``none``, None for
        ``center_crop``; ``flip`` is the flip stream's uniform.  ``rows =
        (offset, total)``: every stream is drawn for the global batch of
        ``total`` and the batch's rows are kept."""
        if self.mode == "center_crop":
            return None
        offset, total = rows
        keys = random.split(key, 5)  # area, aspect, top, left, flip
        if self.mode == "resized_crop":
            lo = torch.tensor([self.scale[0], math.log(self.ratio[0]), 0.0,
                               0.0, 0.0])[:, None]
            hi = torch.tensor([self.scale[1], math.log(self.ratio[1]), 1.0,
                               1.0, 1.0])[:, None]
            # the five streams in one pass: each row is its key's draw
            u = random.uniform(keys, (total,), lo, hi)
            target = float(h * w) * u[0]
            aspect = torch.exp(u[1])
            cw = torch.sqrt(target * aspect)
            ch = torch.sqrt(target / aspect)
            bad = (cw > w) | (ch > h)
            # a tensor dividend: torch computes a Python number over a
            # tensor as a reciprocal times the number
            shrink = torch.minimum(torch.tensor(float(w)) / cw.clamp_min(1e-6),
                                   torch.tensor(float(h)) / ch.clamp_min(1e-6))
            cw = torch.where(bad, cw * shrink, cw)
            ch = torch.where(bad, ch * shrink, ch)
            d = torch.stack([u[2] * (h - ch), u[3] * (w - cw), ch, cw, u[4]])
        elif self.mode == "pad_crop":
            oh, ow = self.size
            spans = torch.tensor([h + 2 * self.padding - oh + 1,
                                  w + 2 * self.padding - ow + 1])[:, None]
            tl = random.randint(keys[2:4], (total,), 0, spans)
            d = torch.cat([tl.float(), random.uniform(keys[4], (1, total))])
        else:
            d = random.uniform(keys[4], (1, total))
        return d[:, offset:]

    def __call__(self, x: torch.Tensor, key: torch.Tensor,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Augment ``x`` (n, H, W, C) with the draws of ``key`` (a key of
        :mod:`tpu_dist_torch.random`, on the host).  ``rows=(offset,
        total)``: ``x`` is rows ``[offset, offset + n)`` of a global batch of
        ``total`` (default ``(0, n)``).  The draws are made on the host and
        reach the card in one pinned, non-blocking copy; the images never
        leave their device."""
        n, h, w, _ = x.shape
        offset, total = (0, n) if rows is None else rows
        if not 0 <= offset <= total - n:
            raise ValueError(f"rows {rows} do not hold a batch of {n}")
        dev = x.device
        oh, ow = self.size
        if self.mode == "pad_crop" and (oh > h + 2 * self.padding
                                        or ow > w + 2 * self.padding):
            raise ValueError(f"crop {self.size} larger than padded input "
                             f"({h + 2 * self.padding}, "
                             f"{w + 2 * self.padding})")
        d = self.draws(key.cpu(), h, w, (offset, total))
        if d is not None:
            d = d[:, :n]
            d = (d.pin_memory().to(dev, non_blocking=True)
                 if dev.type == "cuda" else d)
        raw_uint8 = x.dtype == torch.uint8
        x = x.float()
        if raw_uint8:  # the host loader's ToTensor scaling, by a tensor:
            # CUDA divides by a Python number as a multiply by its
            # reciprocal, which rounds otherwise than the CPU's division
            x = x / torch.full((), 255.0, device=dev)
        if self.mode == "resized_crop":
            x = bilinear_crop_resize(x, d[0], d[1], d[2], d[3], (oh, ow))
        elif self.mode == "center_crop":
            short = float(min(h, w))
            ch_c, cw_c = short * oh / self.resize, short * ow / self.resize
            full = lambda v: torch.full((n,), v, dtype=torch.float32,
                                        device=dev)
            x = bilinear_crop_resize(x, full((h - ch_c) / 2.0),
                                     full((w - cw_c) / 2.0), full(ch_c),
                                     full(cw_c), (oh, ow))
        elif self.mode == "pad_crop":
            pad = self.padding
            if pad:
                x = F.pad(x, (0, 0, pad, pad, pad, pad))
            # an integer crop is the resample at integer coordinates with
            # the crop's size equal to the output's (the weights are 0)
            full = torch.full((n,), float(oh), device=dev)
            x = bilinear_crop_resize(x, d[0], d[1], full,
                                     torch.full_like(full, ow), (oh, ow))
        if self.flip_p > 0:
            flipped = x.flip(2)
            if self.flip_p >= 1.0:
                x = flipped
            else:
                m = d[-1] < self.flip_p
                x = torch.where(m[:, None, None, None], flipped, x)
        if dev not in self._norm:  # copied once a device: a copy waits
            self._norm[dev] = tuple(torch.tensor(v, device=dev)
                                    for v in (self.mean, self.std))
        mean, std = self._norm[dev]
        x = (x - mean) / std
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
