"""Profiling — ``torch.profiler`` hooks + step timing; counterpart of
``tpu_dist/utils/profiler.py`` (the reference only has rank-0 wall-clock
prints)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str, host_only_on_rank0: bool = True):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, plus
    CUDA when a card is present) and write it into ``logdir`` as a
    Chrome/Perfetto JSON file (``trace_r{rank}_{pid}_{ns}.json``; open it
    in ``chrome://tracing`` or ui.perfetto.dev).  Yields the
    ``torch.profiler.profile`` (``key_averages()`` after the block).

    With ``host_only_on_rank0`` (the default) only rank 0 of an
    initialized process group traces; the other ranks run the block
    untraced and get None.  The ``NCCL_DEBUG=INFO`` analogue for "what is
    the hardware doing": kernels and NCCL collectives show up on the
    card's stream rows of the trace."""
    import torch
    from .. import dist as _dist

    rank = _dist.get_rank() if _dist.is_initialized() else 0
    if host_only_on_rank0 and rank != 0:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_r{rank}_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timing with warmup exclusion and percentile summary.

    NOTE on async launches: a step's wall time only reflects the card's
    time if the loop waits for the step's output (reads the loss, or
    ``torch.cuda.synchronize()``).  For throughput prefer CUDA events over
    many chained steps, which cancel launch and read-back overhead.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._times: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    @property
    def steps(self) -> int:
        return len(self._times)

    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def percentile(self, q: float) -> float:
        if not self._times:
            return 0.0
        s = sorted(self._times)
        idx = min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))
        return s[idx]

    def summary(self) -> str:
        return (f"steps={self.steps} mean={self.mean()*1e3:.2f}ms "
                f"p50={self.percentile(50)*1e3:.2f}ms "
                f"p95={self.percentile(95)*1e3:.2f}ms")
