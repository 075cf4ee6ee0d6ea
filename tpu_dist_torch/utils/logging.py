"""Rank-gated logging — counterpart of ``tpu_dist/utils/logging.py``.

The reference gates prints on rank 0 and tracks running loss/accuracy
windows by hand; these helpers do that without a device sync every step.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

__all__ = ["rank_zero_print", "MetricLogger", "log_event"]


def rank_zero_print(*args, **kwargs) -> None:
    """print() only on rank 0 (a single process before init)."""
    from .. import dist as _dist
    if not _dist.is_initialized() or _dist.get_rank() == 0:
        print(*args, **kwargs)


def log_event(event: str, **fields) -> None:
    """One structured line to stderr, from EVERY rank (``[tpu_dist]
    chaos-kill rank=1 step=5``): failure, restart and chaos events are never
    rank-gated — the rank that would have printed may be the one that died.
    Flushed, so the line survives an ``os._exit`` right after."""
    parts = [f"[tpu_dist] {event}"]
    rank = os.environ.get("RANK")
    if rank is not None and "rank" not in fields:
        parts.append(f"rank={rank}")
    parts.extend(f"{k}={v}" for k, v in fields.items())
    print(" ".join(parts), file=sys.stderr, flush=True)


class MetricLogger:
    """Windowed metric averaging with rank-0 printing.  Takes device
    scalars and reads them only when it prints (every ``every`` pushes)::

        log = MetricLogger(every=25, fmt="step {step} loss {loss:.3f}")
        log.push(step=i, loss=m["loss"], acc=(m["correct"], batch))
    """

    def __init__(self, every: int = 25, fmt: Optional[str] = None):
        self.every = every
        self.fmt = fmt
        self._buf: Dict[str, list] = {}
        self._count = 0

    def push(self, step: int, **metrics) -> Optional[Dict[str, float]]:
        self._count += 1
        for k, v in metrics.items():
            self._buf.setdefault(k, []).append(v)
        if self._count % self.every:
            return None
        out: Dict[str, float] = {}
        for k, vals in self._buf.items():
            if isinstance(vals[0], tuple):  # (numerator, denominator) pairs
                num = sum(float(n) for n, _ in vals)
                den = sum(float(d) for _, d in vals)
                out[k] = num / den if den else 0.0
            else:
                try:
                    out[k] = sum(float(v) for v in vals) / len(vals)
                except (TypeError, ValueError):
                    out[k] = vals[-1]  # non-numeric: keep the last
        self._buf.clear()
        if self.fmt is not None:
            rank_zero_print(self.fmt.format(step=step, **out))
        return out
