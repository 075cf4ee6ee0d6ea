"""tpu_dist_torch.models — counterpart of ``tpu_dist.models``."""

from .convnet import ConvNet
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50)
from .transformer import TransformerBlock, TransformerLM
from .vit import VisionTransformer, vit_b_16, vit_b_32, vit_l_16, vit_l_32

__all__ = ["TransformerLM", "TransformerBlock", "ConvNet", "ResNet",
           "BasicBlock", "Bottleneck", "resnet18", "resnet34", "resnet50",
           "VisionTransformer", "vit_b_16", "vit_b_32", "vit_l_16",
           "vit_l_32"]
