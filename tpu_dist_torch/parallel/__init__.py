"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import (DistributedDataParallel, Placement, TrainState,
                  convert_sync_batchnorm)
from .ring_attention import ring_self_attention, ulysses_self_attention
from .rules import (DEFAULT_RULES, SERVING_RULES, TRANSFORMER_LAYOUTS,
                    LeafLayout, ShardLayoutError, chunk_bounds, chunk_span,
                    layout_for, mapped_axes, model_axes, shard_leaf,
                    spans_for)
from .zero import ZeroOptimizer, ZeroParams, ZeroStateError

__all__ = ["DistributedDataParallel", "TrainState", "Placement",
           "convert_sync_batchnorm", "ring_self_attention",
           "ulysses_self_attention", "ZeroOptimizer", "ZeroParams",
           "ZeroStateError", "DEFAULT_RULES", "SERVING_RULES",
           "TRANSFORMER_LAYOUTS", "LeafLayout", "ShardLayoutError",
           "chunk_bounds", "chunk_span", "layout_for", "mapped_axes",
           "model_axes", "shard_leaf", "spans_for"]
