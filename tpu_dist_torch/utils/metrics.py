"""Evaluation metrics, latency percentiles and per-collective transport
counters — counterpart of ``tpu_dist/utils/metrics.py``.

The reference computes accuracy host-side per batch (argmax + eq + sum);
these helpers keep the computation on the tensors' device (one scalar
out) and add the standard top-k form, with the JAX package's results.
:class:`LatencyHistogram` has the JAX package's buckets and ``summary()``
keys, so the port's serving stats read like the JAX package's.

The collective counters aggregate bytes/latency per (op, transport) for
the eager host collectives.  They live in :mod:`tpu_dist_torch.obs.recorder`
— the collectives record into ONE ingestion point (``record_transport``)
that feeds both the aggregates and the armed event stream, so the counters
and the flight recorder can never disagree; the three functions below are
the stable public API over it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence

import torch

__all__ = ["topk_accuracy", "accuracy", "confusion_matrix",
           "record_collective", "collective_counters",
           "reset_collective_counters", "LatencyHistogram"]


class LatencyHistogram:
    """Streaming latency percentiles without storing samples.

    Geometric buckets: bucket 0 is the underflow bucket (values below
    ``min_value``); bucket ``i >= 1`` covers
    ``[min_value*(1+resolution)^(i-1), min_value*(1+resolution)^i)`` and
    reports its upper edge, so any reported percentile is within a
    ``resolution`` relative error of the true sample — at a few KB of
    counts however many million observations arrive.  The final bucket is
    the unbounded overflow bucket and reports the observed max.  The serving
    engine's per-request queue/prefill/TTFT/token latencies
    (:mod:`tpu_dist_torch.serve`) and the serving benchmark read it.
    Thread-safe; ``merge`` combines histograms from concurrent recorders.
    """

    def __init__(self, min_value: float = 1e-6, max_value: float = 3600.0,
                 resolution: float = 0.02):
        if not 0 < min_value < max_value:
            raise ValueError(f"need 0 < min_value < max_value, got "
                             f"{min_value}/{max_value}")
        if not 0 < resolution < 1:
            raise ValueError(f"resolution must be in (0, 1), got "
                             f"{resolution}")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.resolution = float(resolution)
        self._log1p = math.log1p(resolution)
        self._nbuckets = self._index(max_value) + 2  # + under/overflow slot
        self._counts = [0] * self._nbuckets
        self._mu = threading.Lock()
        self._n = 0
        self._sum = 0.0
        self._max = 0.0

    def _index(self, value: float) -> int:
        if value < self.min_value:
            return 0
        return 1 + int(math.log(value / self.min_value) / self._log1p)

    def observe(self, seconds: float) -> None:
        """Record one latency sample (negative values clamp to 0)."""
        v = max(0.0, float(seconds))
        i = min(self._index(v), self._nbuckets - 1)
        with self._mu:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            self._max = max(self._max, v)

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other``'s counts into this histogram (must share the
        bucket geometry)."""
        if (other.min_value, other.max_value, other.resolution) != \
                (self.min_value, self.max_value, self.resolution):
            raise ValueError("histograms have different bucket geometry")
        with other._mu:
            counts = list(other._counts)
            n, s, mx = other._n, other._sum, other._max
        with self._mu:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._n += n
            self._sum += s
            self._max = max(self._max, mx)

    @property
    def count(self) -> int:
        return self._n

    def percentile(self, p: float) -> Optional[float]:
        """The ``p``-th percentile (0 < p <= 100), or None when empty.
        Returns the upper edge of the bucket holding the rank-``ceil(p/100
        * n)`` sample — within ``resolution`` relative error, clamped to
        the observed max."""
        if not 0 < p <= 100:
            raise ValueError(f"percentile must be in (0, 100], got {p}")
        with self._mu:
            if self._n == 0:
                return None
            rank = max(1, math.ceil(p / 100.0 * self._n))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    if i >= self._nbuckets - 1:
                        # overflow bucket is unbounded above: the observed
                        # max is the only honest answer
                        return self._max
                    upper = (self.min_value * (1 + self.resolution) ** i
                             if i else self.min_value)
                    return min(upper, self._max)
            return self._max

    def summary(self) -> Dict[str, float]:
        """``{count, mean, max, p50, p95, p99}`` (zeros when empty)."""
        with self._mu:
            n, s, mx = self._n, self._sum, self._max
        if n == 0:
            return {"count": 0, "mean": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": n, "mean": s / n, "max": mx,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


# -- host-collective transport counters (shims over tpu_dist_torch.obs) -------


def record_collective(op: str, transport: str, nbytes: int,
                      seconds: float) -> None:
    """Account one eager collective: ``op`` (all_reduce, send, ...) over
    ``transport`` ('dataplane' | 'store' | 'mesh') moving ``nbytes`` of
    array payload in ``seconds`` of wall time.  Shim over
    :func:`tpu_dist_torch.obs.recorder.record_transport` — the flight
    recorder's ingestion point."""
    from ..obs import recorder as _obs
    _obs.record_transport(op, transport, nbytes, seconds)


def collective_counters(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Snapshot of the per-``op/transport`` counters, each entry
    ``{calls, bytes, seconds, mb_per_s, ...}``.  ``reset=True`` atomically
    clears after reading (per-step deltas).  Reads the obs event-stream
    aggregates (:func:`tpu_dist_torch.obs.recorder.transport_counters`)."""
    from ..obs import recorder as _obs
    return _obs.transport_counters(reset=reset)


def reset_collective_counters() -> None:
    from ..obs import recorder as _obs
    _obs.reset_transport_counters()


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  ks: Sequence[int] = (1, 5)):
    """Fraction of rows whose target is within the top-k logits, for each
    ``k`` — the torchvision ``accuracy(output, target, topk=(1, 5))``
    recipe, one ``torch.topk`` shared across ks.

    ``logits``: (..., C); ``targets``: (...) int.  Returns a tuple of
    float32 0-d tensors in [0, 1], one per k, in the order given.
    """
    ks = tuple(int(k) for k in ks)
    c = logits.shape[-1]
    if not ks or any(k < 1 or k > c for k in ks):
        raise ValueError(f"every k must be in [1, {c}] and ks non-empty, "
                         f"got {ks}")
    flat = logits.reshape(-1, c)
    tgt = targets.reshape(-1)
    top = torch.topk(flat, max(ks), dim=-1).indices     # (N, max_k)
    hit = top == tgt[:, None]                            # (N, max_k) bool
    return tuple(hit[:, :k].any(dim=1).float().mean() for k in ks)


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy as a float32 0-d tensor in [0, 1]."""
    return (logits.reshape(-1, logits.shape[-1]).argmax(-1)
            == targets.reshape(-1)).float().mean()


def confusion_matrix(predictions, targets,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int32 count matrix, rows = true class,
    cols = predicted (sklearn orientation).  Scatter-add on the inputs'
    device; out-of-range entries are dropped (not clamped into a real
    class)."""
    preds = torch.as_tensor(predictions).reshape(-1).long()
    tgt = torch.as_tensor(targets, device=preds.device).reshape(-1).long()
    valid = ((preds >= 0) & (preds < num_classes)
             & (tgt >= 0) & (tgt < num_classes))
    idx = torch.where(valid, tgt * num_classes + preds,
                      torch.zeros_like(preds))
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int32,
                         device=preds.device)
    counts.index_add_(0, idx, valid.to(torch.int32))
    return counts.reshape(num_classes, num_classes)
