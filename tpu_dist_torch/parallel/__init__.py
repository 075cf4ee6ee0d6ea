"""tpu_dist_torch.parallel — counterpart of ``tpu_dist.parallel``."""

from .ddp import (DistributedDataParallel, Placement, TrainState,
                  convert_sync_batchnorm)
from .fsdp import fsdp_shard, fsdp_specs
from .gspmd import (MOE_EP_RULES, TRANSFORMER_TP_RULES, PartitionRules,
                    make_gspmd_train_step, shard_pytree)
from .mesh import get_mesh, mesh_shape_for
from .pipeline import PipelineParallel, PipeTrainState
from .ring_attention import ring_self_attention, ulysses_self_attention
from .rules import (DEFAULT_RULES, SERVING_RULES, TRANSFORMER_LAYOUTS,
                    LeafLayout, ShardLayoutError, chunk_bounds, chunk_span,
                    layout_for, mapped_axes, model_axes, partition_pairs,
                    shard_leaf, spans_for, spec_for, spec_for_key)
from .tensor import (SerialTPRunner, TPConfigError, TPTrainer,
                     build_tp_stage_fns, tp_shard_params)
from .zero import ZeroOptimizer, ZeroParams, ZeroStateError

# torch-style alias, as in the JAX package
DDP = DistributedDataParallel

__all__ = ["DistributedDataParallel", "DDP", "TrainState", "Placement",
           "convert_sync_batchnorm", "ring_self_attention",
           "ulysses_self_attention", "ZeroOptimizer", "ZeroParams",
           "ZeroStateError", "DEFAULT_RULES", "SERVING_RULES",
           "TRANSFORMER_LAYOUTS", "LeafLayout", "ShardLayoutError",
           "chunk_bounds", "chunk_span", "layout_for", "mapped_axes",
           "model_axes", "shard_leaf", "spans_for", "spec_for",
           "spec_for_key", "partition_pairs", "PartitionRules",
           "shard_pytree", "make_gspmd_train_step", "TRANSFORMER_TP_RULES",
           "MOE_EP_RULES", "fsdp_shard", "fsdp_specs", "get_mesh",
           "mesh_shape_for", "TPTrainer", "SerialTPRunner", "TPConfigError",
           "tp_shard_params", "build_tp_stage_fns", "PipelineParallel",
           "PipeTrainState"]
