"""VGG family — counterpart of ``tpu_dist/models/vgg.py``: torchvision's
configurations A/B/D/E (vgg11/13/16/19), plain and with BatchNorm, the 7x7
adaptive pool and the 4096-4096 classifier head, with torchvision's
initialization: kaiming_normal(fan_out, relu) for the convolutions,
BatchNorm weight 1 and bias 0, the classifier's Linears N(0, 0.01) with a
zero bias.  Parameter counts are torchvision's (132,863,336 for vgg11).

Input is NCHW, (batch, 3, H, W).  The feature map flattens in torch's
``(c, h, w)`` order, where the JAX package flattens NHWC in ``(h, w, c)``
order: the first classifier Linear's input columns are permuted between the
two (:attr:`VGG.flattened_inputs`, which ``interop.load_jax_params``
reads).  On 32x32 inputs the features end at 1x1 and the 7x7 pool repeats
that value over its 49 cells, as the JAX layer does.  BatchNorm is
per-replica; the DDP wrapper's ``sync_batchnorm=True`` makes it
cross-replica."""

from __future__ import annotations

from typing import List, Union

import torch

from .. import nn
from ..nn import init as init_lib
from ..ops._build import resolve_device
from .resnet import _KaimingConv2d

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class _ClassifierLinear(nn.Linear):
    """Linear with torchvision's VGG classifier init: N(0, 0.01), zero
    bias."""

    def reset_parameters(self, generator=None):
        init_lib.normal(self.weight, 0.01, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class VGG(torch.nn.Module):
    # Linear layers whose input is a flattened (c, h, w) feature map
    flattened_inputs = {"classifier.0": (512, 7, 7)}

    def __init__(self, cfg: Union[str, List], num_classes: int = 1000,
                 batch_norm: bool = False, dropout: float = 0.5,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        layers: List[torch.nn.Module] = []
        in_ch = 3
        for v in (_CFGS[cfg] if isinstance(cfg, str) else cfg):
            if v == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
                continue
            # torchvision keeps the convolution's bias in the BatchNorm
            # variants too (its parameter counts count it)
            layers.append(_KaimingConv2d(in_ch, v, kernel_size=3, padding=1,
                                         bias=True, device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2d(v, device=device))
            layers.append(nn.ReLU())
            in_ch = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        self.flatten = nn.Flatten()
        self.classifier = nn.Sequential(
            _ClassifierLinear(512 * 7 * 7, 4096, device=device), nn.ReLU(),
            nn.Dropout(dropout),
            _ClassifierLinear(4096, 4096, device=device), nn.ReLU(),
            nn.Dropout(dropout),
            _ClassifierLinear(4096, num_classes, device=device))

    def forward(self, x):
        return self.classifier(self.flatten(self.avgpool(self.features(x))))


def vgg11(**kw) -> VGG:
    return VGG("A", **kw)


def vgg13(**kw) -> VGG:
    return VGG("B", **kw)


def vgg16(**kw) -> VGG:
    return VGG("D", **kw)


def vgg19(**kw) -> VGG:
    return VGG("E", **kw)


def vgg11_bn(**kw) -> VGG:
    return VGG("A", batch_norm=True, **kw)


def vgg13_bn(**kw) -> VGG:
    return VGG("B", batch_norm=True, **kw)


def vgg16_bn(**kw) -> VGG:
    return VGG("D", batch_norm=True, **kw)


def vgg19_bn(**kw) -> VGG:
    return VGG("E", batch_norm=True, **kw)
