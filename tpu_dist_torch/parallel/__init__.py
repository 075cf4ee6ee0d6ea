"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import (DistributedDataParallel, Placement, TrainState,
                  convert_sync_batchnorm)
from .gspmd import (MOE_EP_RULES, TRANSFORMER_TP_RULES, PartitionRules,
                    make_gspmd_train_step, shard_pytree)
from .ring_attention import ring_self_attention, ulysses_self_attention
from .rules import (DEFAULT_RULES, SERVING_RULES, TRANSFORMER_LAYOUTS,
                    LeafLayout, ShardLayoutError, chunk_bounds, chunk_span,
                    layout_for, mapped_axes, model_axes, partition_pairs,
                    shard_leaf, spans_for, spec_for, spec_for_key)
from .zero import ZeroOptimizer, ZeroParams, ZeroStateError

__all__ = ["DistributedDataParallel", "TrainState", "Placement",
           "convert_sync_batchnorm", "ring_self_attention",
           "ulysses_self_attention", "ZeroOptimizer", "ZeroParams",
           "ZeroStateError", "DEFAULT_RULES", "SERVING_RULES",
           "TRANSFORMER_LAYOUTS", "LeafLayout", "ShardLayoutError",
           "chunk_bounds", "chunk_span", "layout_for", "mapped_axes",
           "model_axes", "shard_leaf", "spans_for", "spec_for",
           "spec_for_key", "partition_pairs", "PartitionRules",
           "shard_pytree", "make_gspmd_train_step", "TRANSFORMER_TP_RULES",
           "MOE_EP_RULES"]
