"""Host-path pipeline parallelism over stage roles — counterpart of
``tpu_dist.pipeline``.

The eager twin of the mesh pipeline (``tpu_dist_torch/parallel/
pipeline.py``): each pipeline **stage is a role** (``stage0..stage{S-1}``),
microbatch activations and gradients flow through bounded
:class:`~tpu_dist_torch.roles.Channel` queues, and the schedule's flow
control IS the channels' depth + claim ordering — GPipe and 1F1B differ
only in each stage's op sequence and the act-edge depth/credit bound
(``warmup = depth``).  Data parallelism composes per stage: role
sub-groups run the existing bucketed/ZeRO grad sync unchanged within a
stage (dp × pp).

Layout:

- :mod:`~tpu_dist_torch.pipeline.partition` — layer-span partitioner over
  TransformerLM/ConvNet parameter trees (the JAX package's keys, mergeable
  shards).
- :mod:`~tpu_dist_torch.pipeline.schedule` — GPipe/1F1B op sequences,
  stash bounds, credit math, and :func:`build_pipeline_graph`.
- :mod:`~tpu_dist_torch.pipeline.stage` — the per-role runtime: channel
  claims, recompute-based backward, asserted stash accounting, async
  sends, opt-in int8_block activation compression.
- :mod:`~tpu_dist_torch.pipeline.train` — :class:`PipelineTrainer` (dp ×
  pp, step handles, checkpoint shards) and the serial bitwise oracle.
"""

from .partition import (ConvNetPartition, ModelPartition,
                        PipelinePartitionError, TransformerPartition,
                        partition_model)
from .schedule import (SCHEDULES, Op, act_channel, act_credits,
                       bubble_fraction, build_pipeline_graph, grad_channel,
                       grad_credits, parse_stage_role, schedule_ops,
                       stage_role, stash_bound)
from .stage import (PendingSend, PipelineScheduleError, PipelineStage,
                    StageFns, StageResult)
from .train import (PipelineTrainer, SerialPipelineRunner, StepHandle,
                    build_stage_fns, split_microbatches)

__all__ = [
    "ModelPartition", "TransformerPartition", "ConvNetPartition",
    "partition_model", "PipelinePartitionError",
    "Op", "SCHEDULES", "schedule_ops", "stash_bound", "act_credits",
    "grad_credits", "bubble_fraction", "build_pipeline_graph",
    "stage_role", "parse_stage_role", "act_channel", "grad_channel",
    "PipelineStage", "StageFns", "StageResult", "PendingSend",
    "PipelineScheduleError",
    "PipelineTrainer", "StepHandle", "SerialPipelineRunner",
    "build_stage_fns", "split_microbatches",
]
