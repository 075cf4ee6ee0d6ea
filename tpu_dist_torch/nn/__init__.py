"""tpu_dist_torch.nn — counterpart of ``tpu_dist.nn`` (the TransformerLM
training path, dense and dropless-MoE, and its int8 inference layers)."""

from . import functional, init
from .attention import (MultiheadSelfAttention, attention_impl,
                        scaled_dot_product_attention)
from .layers import GELU, Embedding, LayerNorm, Linear
from .loss import CrossEntropyLoss
from .module import Module, Sequential, reset_parameters
from .moe import MoELayer
from .quant import (QuantEmbedding, QuantLinear, QuantMultiheadSelfAttention,
                    quantize_linear_weights)

__all__ = ["functional", "init", "Module", "Sequential", "reset_parameters",
           "Linear", "Embedding", "LayerNorm", "GELU", "CrossEntropyLoss",
           "MultiheadSelfAttention", "attention_impl",
           "scaled_dot_product_attention", "MoELayer", "QuantLinear",
           "QuantMultiheadSelfAttention", "QuantEmbedding",
           "quantize_linear_weights"]
