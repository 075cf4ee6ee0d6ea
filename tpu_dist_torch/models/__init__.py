"""tpu_dist_torch.models — counterpart of ``tpu_dist.models``."""

from .transformer import TransformerBlock, TransformerLM

__all__ = ["TransformerLM", "TransformerBlock"]
