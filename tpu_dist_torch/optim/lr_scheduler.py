"""Learning-rate schedules — counterpart of ``tpu_dist/optim/lr_scheduler.py``
(torch.optim.lr_scheduler parity).

A schedule is a pure function of the update count, ``f(step) -> lr``,
passed *as* an optimizer's ``lr``.  The JAX package evaluates it in float32
on the device inside the jitted step; the port evaluates it on the host from
the optimizer's host counter, so a step never waits for the card.  Every
schedule computes in numpy float32 with the JAX package's order of
operations (its ``_f32``, ``jnp.cos``, ``gamma ** floor(...)``), the cosine
rounded from float64 (XLA's float32 cosine is within an ulp of that, numpy's
is not), where Python's float64 would drift from the JAX sequence.  A
schedule returns a ``numpy.float32``.

As in the JAX package, these are functions of whatever counter the
optimizer keeps (one tick per ``update``) and match their torch namesakes
as sequences: ``schedule(i) == torch_scheduler_lr_after_i_steps``.

Usage::

    sched = optim.warmup_cosine(peak_lr=3e-4, warmup_steps=1000,
                                total_steps=100_000)
    opt = optim.AdamW(lr=sched)
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["step_lr", "multistep_lr", "exponential_lr", "linear_lr",
           "cosine_annealing_lr", "constant_lr", "warmup_cosine",
           "sequential_lr"]

Schedule = Callable[[int], np.float32]

_F = np.float32
_PI = _F(np.pi)


def _f32(step) -> np.float32:
    return _F(float(step))


def _cos(x: np.float32) -> np.float32:
    # the float32 cosine rounded from float64: XLA's float32 cos is within
    # an ulp of it, numpy's own float32 cos often is not
    return _F(np.cos(np.float64(x)))


def step_lr(lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """``torch.optim.lr_scheduler.StepLR``: decay by ``gamma`` every
    ``step_size`` steps."""
    return lambda step: _F(lr) * _F(gamma) ** np.floor(
        _f32(step) / _F(step_size))


def multistep_lr(lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Schedule:
    """``MultiStepLR``: decay by ``gamma`` at each milestone step."""
    ms = np.asarray(sorted(milestones), np.float32)
    return lambda step: _F(lr) * _F(gamma) ** _F(np.sum(_f32(step) >= ms))


def exponential_lr(lr: float, gamma: float) -> Schedule:
    """``ExponentialLR``: multiply by ``gamma`` every step."""
    return lambda step: _F(lr) * _F(gamma) ** _f32(step)


def linear_lr(lr: float, start_factor: float = 1.0 / 3,
              end_factor: float = 1.0, total_iters: int = 5) -> Schedule:
    """``LinearLR``: interpolate the lr factor from ``start_factor`` to
    ``end_factor`` over ``total_iters`` steps (constant after)."""
    def f(step):
        t = np.clip(_f32(step) / _F(total_iters), _F(0.0), _F(1.0))
        return _F(lr) * (_F(start_factor) + _F(end_factor - start_factor) * t)
    return f


def cosine_annealing_lr(lr: float, t_max: int,
                        eta_min: float = 0.0) -> Schedule:
    """``CosineAnnealingLR``: cosine from ``lr`` to ``eta_min`` over
    ``t_max`` steps (continues the cosine past t_max, like torch)."""
    def f(step):
        return _F(eta_min) + _F(0.5 * (lr - eta_min)) * (
            _F(1.0) + _cos(_PI * _f32(step) / _F(t_max)))
    return f


def constant_lr(lr: float, factor: float = 1.0 / 3,
                total_iters: int = 5) -> Schedule:
    """``ConstantLR``: ``lr * factor`` for the first ``total_iters`` steps,
    then ``lr``."""
    return lambda step: _F(lr) * (_F(factor) if _f32(step) < total_iters
                                  else _F(1.0))


def sequential_lr(schedules: Sequence[Schedule],
                  milestones: Sequence[int]) -> Schedule:
    """``SequentialLR``: switch between schedules at the milestone steps;
    each schedule sees a counter restarted at its milestone."""
    if len(schedules) != len(milestones) + 1:
        raise ValueError(f"{len(schedules)} schedules need "
                         f"{len(schedules) - 1} milestones, got "
                         f"{len(milestones)}")
    bounds = [0] + list(milestones)

    def f(step):
        s = _f32(step)
        out = schedules[0](s)
        for sched, b in zip(schedules[1:], bounds[1:]):
            if s >= b:
                out = sched(s - _F(b))
        return _F(out)
    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup 0 → ``peak_lr`` then cosine decay to ``end_lr`` — the
    standard LM recipe (no single torch class; equals SequentialLR of
    LinearLR + CosineAnnealingLR)."""
    def f(step):
        s = _f32(step)
        if s < warmup_steps:
            return _F(peak_lr) * s / _F(max(warmup_steps, 1))
        t = np.clip((s - _F(warmup_steps)) / _F(
            max(total_steps - warmup_steps, 1)), _F(0.0), _F(1.0))
        return _F(end_lr) + _F(0.5 * (peak_lr - end_lr)) * (
            _F(1.0) + _cos(_PI * t))
    return f
