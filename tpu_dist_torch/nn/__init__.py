"""tpu_dist_torch.nn — counterpart of ``tpu_dist.nn`` (the TransformerLM
training path, dense and dropless-MoE, its int8 inference layers, and the
vision layers of the ConvNet and ResNet)."""

from . import functional, init
from .attention import (MultiheadSelfAttention, attention_impl,
                        scaled_dot_product_attention)
from .layers import (GELU, AdaptiveAvgPool2d, AvgPool2d, BatchNorm2d, Conv2d,
                     Dropout, Embedding, Flatten, Identity, LayerNorm, Linear,
                     MaxPool2d, ReLU)
from .loss import CrossEntropyLoss
from .module import Module, Sequential, next_rng, reset_parameters, rng_scope
from .moe import MoELayer
from .quant import (QuantEmbedding, QuantLinear, QuantMultiheadSelfAttention,
                    quantize_linear_weights)

__all__ = ["functional", "init", "Module", "Sequential", "reset_parameters",
           "rng_scope", "next_rng", "Linear", "Conv2d", "MaxPool2d",
           "AvgPool2d", "AdaptiveAvgPool2d", "ReLU", "Identity", "Flatten",
           "Dropout", "BatchNorm2d", "Embedding", "LayerNorm", "GELU",
           "CrossEntropyLoss",
           "MultiheadSelfAttention", "attention_impl",
           "scaled_dot_product_attention", "MoELayer", "QuantLinear",
           "QuantMultiheadSelfAttention", "QuantEmbedding",
           "quantize_linear_weights"]
