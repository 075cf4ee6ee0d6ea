"""tpu_dist_torch — the PyTorch/CUDA port of :mod:`tpu_dist` for an NVIDIA
H100.

The package mirrors ``tpu_dist``'s module layout and names, so each module's
counterpart is easy to find, and uses PyTorch idiom inside.  It imports
``torch``, ``numpy`` and the standard library, and nothing of ``jax`` or
``tpu_dist``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no ``device`` they raise.

Ported so far (slice 1): the GPT-2-small-shaped ``TransformerLM`` trained
through ``DistributedDataParallel`` with bf16 compute, the fused
cross-entropy and flash attention as hand-written kernels.
"""

from . import dist, models, nn, ops, optim, parallel

__all__ = ["dist", "models", "nn", "ops", "optim", "parallel"]
