"""tpu_dist_torch.models — counterpart of ``tpu_dist.models``."""

from .convnet import ConvNet
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50)
from .transformer import TransformerBlock, TransformerLM
from .vgg import (VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16, vgg16_bn,
                  vgg19, vgg19_bn)
from .vit import VisionTransformer, vit_b_16, vit_b_32, vit_l_16, vit_l_32

__all__ = ["TransformerLM", "TransformerBlock", "ConvNet", "ResNet",
           "BasicBlock", "Bottleneck", "resnet18", "resnet34", "resnet50",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "VisionTransformer", "vit_b_16", "vit_b_32", "vit_l_16",
           "vit_l_32"]
