"""tpu_dist_torch.ops — the port's hand-written Hopper kernels.

Counterpart of ``tpu_dist.ops``.  Each kernel wrapper launches its kernel on
a CUDA tensor (or raises) and takes its plain PyTorch version on a CPU
tensor; ``wrapper.launches`` counts the kernel's launches."""

from .cross_entropy import (cross_entropy_bwd, cross_entropy_fwd,
                            fused_cross_entropy)
from .flash_attention import (flash_attention, flash_attention_with_lse,
                              flash_bwd, flash_fwd)
from .gmm import gmm, grouped_linear, tgmm

# every kernel wrapper of the port, in the order K1f, K1b, K2f, K2b, K3, K4
KERNELS = (cross_entropy_fwd, cross_entropy_bwd, flash_fwd, flash_bwd, gmm,
           tgmm)

__all__ = ["fused_cross_entropy", "flash_attention",
           "flash_attention_with_lse", "gmm", "tgmm", "grouped_linear",
           "KERNELS"]
