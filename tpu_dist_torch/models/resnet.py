"""ResNet family — counterpart of ``tpu_dist/models/resnet.py``:
torchvision's architecture (BasicBlock [2, 2, 2, 2] for ResNet-18,
Bottleneck [3, 4, 6, 3] for ResNet-50) with its ImageNet stem (7x7 stride-2
conv, 3x3 stride-2 max-pool), as the reference trains it on 32x32 CIFAR-10.

Initialization follows torchvision: kaiming_normal(fan_out, relu) for the
convolutions, BatchNorm weight 1 and bias 0, the default Linear init for
the head.  Module paths are the JAX package's (``layer1.0.downsample.0``),
so ``interop.load_jax_params`` keys match.  BatchNorm is per-replica; the
DDP wrapper's ``sync_batchnorm=True`` makes it cross-replica.  Input NCHW,
(batch, 3, H, W)."""

from __future__ import annotations

from typing import List, Optional, Type, Union

import torch

from .. import nn
from ..nn import init as init_lib
from ..ops._build import resolve_device

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50"]


class _KaimingConv2d(nn.Conv2d):
    """Conv2d with torchvision's ResNet init (kaiming_normal fan_out, relu;
    zero bias)."""

    def reset_parameters(self, generator=None):
        kh, kw = self.kernel_size
        init_lib.kaiming_normal(self.weight, self.out_channels * kh * kw,
                                nonlinearity="relu", generator=generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, device=None):
    return _KaimingConv2d(in_ch, out_ch, kernel_size=3, stride=stride,
                          padding=1, bias=False, device=device)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1, device=None):
    return _KaimingConv2d(in_ch, out_ch, kernel_size=1, stride=stride,
                          bias=False, device=device)


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: Optional[torch.nn.Module] = None, device=None):
        super().__init__()
        self.conv1 = conv3x3(in_ch, planes, stride, device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.relu = nn.ReLU()
        self.conv2 = conv3x3(planes, planes, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.downsample = downsample if downsample is not None \
            else nn.Identity()

    def forward(self, x):
        identity = self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(torch.nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: Optional[torch.nn.Module] = None, device=None):
        super().__init__()
        self.conv1 = conv1x1(in_ch, planes, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = conv3x3(planes, planes, stride, device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = conv1x1(planes, planes * self.expansion, device=device)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion, device=device)
        self.relu = nn.ReLU()
        self.downsample = downsample if downsample is not None \
            else nn.Identity()

    def forward(self, x):
        identity = self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block: Type[Union[BasicBlock, Bottleneck]],
                 layers: List[int], num_classes: int = 1000, device=None):
        super().__init__()
        device = resolve_device(device)
        self.inplanes = 64
        self.conv1 = _KaimingConv2d(3, 64, kernel_size=7, stride=2, padding=3,
                                    bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, device)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, device)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, device)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, device)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512 * block.expansion, num_classes, device=device)

    def _make_layer(self, block, planes: int, blocks: int, stride: int,
                    device) -> torch.nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride,
                        device),
                nn.BatchNorm2d(planes * block.expansion, device=device))
        layers = [block(self.inplanes, planes, stride, downsample, device)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, device=device))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        return self.fc(x.reshape(x.shape[0], -1))


def resnet18(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, device)


def resnet34(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, device)


def resnet50(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, device)
