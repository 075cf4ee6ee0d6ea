"""tpu_dist_torch — the PyTorch/CUDA port of :mod:`tpu_dist` for an NVIDIA
H100.

The package mirrors ``tpu_dist``'s module layout and names, so each module's
counterpart is easy to find, and uses PyTorch idiom inside.  It imports
``torch``, ``numpy`` and the standard library, and nothing of ``jax`` or
``tpu_dist``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no ``device`` they raise.

Ported so far: the GPT-2-small-shaped ``TransformerLM`` trained through
``DistributedDataParallel`` with bf16 compute (dense, and with a dropless
MoE), its kernels hand-written (fused cross-entropy, flash attention,
grouped matmuls); and serving it with continuous batching (``serve``: KV
slot cache, engine, scheduler, socket frontend and client, int8 weights
and caches), with ``random``, the JAX package's sampling stream (the
counterpart of ``jax.random``) that generation and the engine draw from;
and the reference tutorial's own workload: the MNIST ``ConvNet`` and the
CIFAR-10 ``resnet18`` trained through DDP with per-replica (or synced)
BatchNorm and evaluated (``nn`` vision layers on cuDNN, ``models``), the
data path (``data``: samplers, synthetic datasets, transforms, a threaded
loader, a device loader), ``launch.spawn``, and ``examples``, the twins of
the two ``mp.spawn`` scripts; and the training recipe: every optimizer of
``optim`` (multi-tensor, in place), lr schedules, clipping, EMA, gradient
accumulation in the DDP, ``checkpoint`` in the JAX package's format with
``collectives.broadcast_object_list`` for resuming, and the
``examples.train_lm`` twin; and sequence parallelism: process groups with
mesh axes, ring attention and Ulysses (``parallel``), the sequence axis of
the attention layer and the model, ``train_lm --parallel sp``, and flash
attention's ``causal="offdiag"`` mode and ``split_diag`` variant; and
ImageNet-class training: the dataset readers, ``ImageFolder`` and
``SyntheticImageNet``, the resize transforms, augmentation on the card
(``data.DeviceAugment``), ``models.vit_b_16`` and the
``examples.example_imagenet`` twin.
"""

from . import (checkpoint, collectives, data, dist, examples, launch, models,
               nn, ops, optim, parallel, random, serve, utils)

__all__ = ["checkpoint", "collectives", "data", "dist", "examples", "launch",
           "models", "nn", "ops", "optim", "parallel", "random", "serve",
           "utils"]
