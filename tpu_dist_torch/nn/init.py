"""Parameter initializers with torch-default distributions.

Counterpart of ``tpu_dist/nn/init.py``: the same distributions, not the same
random streams.  Each fills a tensor in place from an explicit
``torch.Generator`` (``None`` = the global one)."""

from __future__ import annotations

import math

import torch

__all__ = ["torch_default_uniform", "normal"]


@torch.no_grad()
def torch_default_uniform(tensor, fan_in: int, generator=None):
    """torch's default Conv/Linear weight+bias init: U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal(tensor, std: float, generator=None):
    return tensor.normal_(0.0, std, generator=generator)
