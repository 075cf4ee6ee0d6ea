"""Parameter initializers with torch-default distributions.

Counterpart of ``tpu_dist/nn/init.py``: the same distributions, not the same
random streams.  Each fills a tensor in place from an explicit
``torch.Generator`` (``None`` = the global one)."""

from __future__ import annotations

import math

import torch

__all__ = ["torch_default_uniform", "normal", "uniform", "kaiming_uniform",
           "kaiming_normal", "xavier_uniform", "trunc_normal"]


@torch.no_grad()
def torch_default_uniform(tensor, fan_in: int, generator=None):
    """torch's default Conv/Linear weight+bias init: U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal(tensor, std: float, generator=None):
    return tensor.normal_(0.0, std, generator=generator)


@torch.no_grad()
def uniform(tensor, minval: float, maxval: float, generator=None):
    """U(minval, maxval)."""
    return tensor.uniform_(minval, maxval, generator=generator)


def _gain(nonlinearity: str, a: float) -> float:
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + a * a))
    if nonlinearity == "linear":
        return 1.0
    raise ValueError(f"Unsupported nonlinearity {nonlinearity!r}")


@torch.no_grad()
def kaiming_uniform(tensor, fan: int, a: float = 0.0,
                    nonlinearity: str = "leaky_relu", generator=None):
    """torch's ``kaiming_uniform_``: U(±gain·sqrt(3/fan)).  ``fan`` is
    passed in, since the port's layouts differ by module (the JAX package
    reads it from an (in, out) or HWIO shape)."""
    bound = _gain(nonlinearity, a) * math.sqrt(3.0 / fan)
    return uniform(tensor, -bound, bound, generator)


@torch.no_grad()
def kaiming_normal(tensor, fan: int, a: float = 0.0,
                   nonlinearity: str = "leaky_relu", generator=None):
    """torch's ``kaiming_normal_``: N(0, gain/sqrt(fan)).  ``fan`` is passed
    in: torchvision's ResNet convolutions take ``mode="fan_out"``, which is
    ``out_channels * kh * kw`` of an OIHW weight (the JAX package reads it
    from HWIO)."""
    return normal(tensor, _gain(nonlinearity, a) / math.sqrt(fan), generator)


@torch.no_grad()
def xavier_uniform(tensor, gain: float = 1.0, generator=None):
    """torch's ``xavier_uniform_``: U(±gain·sqrt(6/(fan_in + fan_out)))
    over a 2-D weight, whose bound is the same in the (out, in) and the
    JAX package's (in, out) layout."""
    if tensor.dim() != 2:
        raise ValueError(f"xavier_uniform takes a 2-D weight, got shape "
                         f"{tuple(tensor.shape)}")
    limit = gain * math.sqrt(6.0 / sum(tensor.shape))
    return uniform(tensor, -limit, limit, generator)


@torch.no_grad()
def trunc_normal(tensor, std: float = 1.0, mean: float = 0.0,
                 a: float = -2.0, b: float = 2.0, generator=None):
    """torch's ``trunc_normal_``: N(mean, std) truncated to [a, b], with
    ``a`` and ``b`` in value units, not standard deviations (the defaults
    ±2 leave the small stds torchvision passes untruncated in effect)."""
    return torch.nn.init.trunc_normal_(tensor, mean, std, a, b,
                                       generator=generator)
