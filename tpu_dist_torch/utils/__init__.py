"""tpu_dist_torch.utils — counterpart of ``tpu_dist.utils`` (the part the
serving path uses)."""

from .metrics import LatencyHistogram

__all__ = ["LatencyHistogram"]
