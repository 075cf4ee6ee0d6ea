"""MNIST ConvNet — counterpart of ``tpu_dist/models/convnet.py``: the
reference tutorial's ConvNet layer by layer, with its quirks:

- conv1: 5x5, stride 1, padding **1** (not 2) → 28x28 → 26x26;
- maxpool1: 2x2 stride 2 → 13x13;
- conv2: 3x3, no padding → 11x11; maxpool2: 2x2 **stride 1** → 10x10;
- conv3: 3x3, no padding → 8x8; maxpool3: 2x2 stride 2 → 4x4;
- fc1: 128*4*4 → 10;
- a Dropout(0.5) layer is defined and never called in ``forward``.

Input is NCHW, (batch, 1, 28, 28), and the feature map flattens in torch's
``(c, h, w)`` order, so this is the reference's torch ConvNet.  The JAX
package flattens NHWC in ``(h, w, c)`` order: ``fc1``'s input columns are
permuted between the two (:attr:`ConvNet.flattened_inputs`, which
``interop.load_jax_params`` reads)."""

from __future__ import annotations

import torch

from .. import nn
from ..ops._build import resolve_device

__all__ = ["ConvNet"]


class ConvNet(torch.nn.Module):
    # Linear layers whose input is a flattened (c, h, w) feature map
    flattened_inputs = {"fc1": (128, 4, 4)}

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2d(1, 32, kernel_size=5, stride=1, padding=1,
                               device=device)
        self.maxpool1 = nn.MaxPool2d(kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(32, 64, kernel_size=3, stride=1, device=device)
        self.maxpool2 = nn.MaxPool2d(kernel_size=2, stride=1)
        self.conv3 = nn.Conv2d(64, 128, kernel_size=3, stride=1,
                               device=device)
        self.maxpool3 = nn.MaxPool2d(kernel_size=2, stride=2)
        self.dropout = nn.Dropout(p=0.5)  # defined, never called (as in ref)
        self.fc1 = nn.Linear(128 * 4 * 4, 10, device=device)

    def forward(self, x):
        x = self.maxpool1(self.relu(self.conv1(x)))
        x = self.maxpool2(self.relu(self.conv2(x)))
        x = self.maxpool3(self.relu(self.conv3(x)))
        x = x.reshape(x.shape[0], -1)
        return self.fc1(x)
