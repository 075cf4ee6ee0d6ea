"""Vision Transformer — counterpart of ``tpu_dist/models/vit.py``
(torchvision's ``vit_b_16`` family).

The patch embedding is a stride-``patch`` :class:`~tpu_dist_torch.nn.Conv2d`
over NCHW images, the encoder the LM's pre-LN
:class:`~tpu_dist_torch.models.TransformerBlock` (LayerNorm eps 1e-6,
non-causal), the head a :class:`~tpu_dist_torch.nn.Linear` on the class
token after a final LayerNorm.  The conv's (B, d, H/p, W/p) map flattens
over (h, w), row-major, which is the JAX package's NHWC reshape order; the
class token goes first.  Module paths are the JAX package's (``conv_proj``,
``tokens.class_token``, ``tokens.pos_embedding``, ``block0.attn``,
``block0.mlp.0``, ``ln``, ``head``), so ``interop.load_jax_params`` loads a
JAX ViT's parameters.

Initialization follows torchvision, each rule the ``reset_parameters`` of
the module it applies to (drawn from the caller's generator, not the JAX
package's ``fold_in`` streams): zero head and class token, N(0, 0.02)
position embeddings, ``trunc_normal(std=sqrt(1/fan_in))`` patch projection
with a zero bias, xavier-uniform MLP weights with N(0, 1e-6) biases, and
xavier-uniform ``qkv_weight`` with zero ``qkv_bias`` and ``out_bias`` (the
out-projection weight keeps torch's default, as in the JAX package)."""

from __future__ import annotations

import math

import torch

from .. import nn
from ..nn import init as init_lib
from ..ops._build import resolve_device
from .transformer import TransformerBlock

__all__ = ["VisionTransformer", "vit_b_16", "vit_b_32", "vit_l_16",
           "vit_l_32"]


class _PatchProjection(nn.Conv2d):
    """The patch embedding: trunc_normal(std=sqrt(1/fan_in)), zero bias."""

    def reset_parameters(self, generator=None):
        init_lib.trunc_normal(self.weight, std=math.sqrt(1.0 / self.fan_in),
                              generator=generator)
        with torch.no_grad():
            self.bias.zero_()


class _MLPLinear(nn.Linear):
    """An encoder MLP Linear: xavier-uniform weight, N(0, 1e-6) bias."""

    def reset_parameters(self, generator=None):
        init_lib.xavier_uniform(self.weight, generator=generator)
        init_lib.normal(self.bias, 1e-6, generator)


class _ZeroLinear(nn.Linear):
    """The classification head, zero-initialized."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.zero_()
            self.bias.zero_()


class _EncoderAttention(nn.MultiheadSelfAttention):
    """``nn.MultiheadAttention``'s reset: xavier-uniform in-projection, zero
    biases; the out-projection weight keeps torch's default."""

    def reset_parameters(self, generator=None):
        init_lib.xavier_uniform(self.qkv_weight, generator=generator)
        init_lib.torch_default_uniform(self.out_weight, self.embed_dim,
                                       generator)
        with torch.no_grad():
            self.qkv_bias.zero_()
            self.out_bias.zero_()


class _TokenEmbeddings(torch.nn.Module):
    """Class token (zeros) prepended to the patch tokens, plus a learned
    position table over ``seq_len`` positions (N(0, 0.02))."""

    def __init__(self, seq_len: int, dim: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.class_token = torch.nn.Parameter(
            torch.empty(1, 1, dim, device=device))
        self.pos_embedding = torch.nn.Parameter(
            torch.empty(1, seq_len, dim, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.class_token.zero_()
        init_lib.normal(self.pos_embedding, 0.02, generator)

    def forward(self, x):
        cls = self.class_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)


class VisionTransformer(torch.nn.Module):
    """ViT encoder classifier: images (B, 3, H, W) → logits (B, classes).

    ``image_size`` must be divisible by ``patch_size``; the MLP's hidden
    width is ``4 * hidden_dim``, as in every standard ViT (B, L, H)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_layers: int = 12, num_heads: int = 12,
                 hidden_dim: int = 768, num_classes: int = 1000,
                 device=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} not divisible by "
                             f"patch_size {patch_size}")
        device = resolve_device(device)
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        n_patches = (image_size // patch_size) ** 2
        self.conv_proj = _PatchProjection(3, hidden_dim, patch_size,
                                          stride=patch_size, device=device)
        self.tokens = _TokenEmbeddings(n_patches + 1, hidden_dim, device)
        for i in range(num_layers):
            block = TransformerBlock(
                hidden_dim, num_heads, causal=False, device=device,
                norm_eps=1e-6, mlp=nn.Sequential(
                    _MLPLinear(hidden_dim, 4 * hidden_dim, device=device),
                    nn.GELU(),
                    _MLPLinear(4 * hidden_dim, hidden_dim, device=device)))
            block.attn = _EncoderAttention(hidden_dim, num_heads,
                                           causal=False, device=device)
            setattr(self, f"block{i}", block)
        self.ln = nn.LayerNorm(hidden_dim, eps=1e-6, device=device)
        self.head = _ZeroLinear(hidden_dim, num_classes, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        if (c, h, w) != (3, self.image_size, self.image_size):
            raise ValueError(f"expected (B, 3, {self.image_size}, "
                             f"{self.image_size}) NCHW images, got "
                             f"{tuple(x.shape)}")
        x = self.conv_proj(x)                       # (B, d, H/p, W/p)
        x = x.flatten(2).transpose(1, 2)            # (B, N, d), (h, w) order
        x = self.tokens(x)                          # (B, N + 1, d)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.ln(x)[:, 0])          # class token only


def vit_b_16(num_classes: int = 1000, image_size: int = 224, device=None):
    """ViT-Base/16 (torchvision ``vit_b_16``: 86,567,656 parameters at 1000
    classes)."""
    return VisionTransformer(image_size, 16, 12, 12, 768, num_classes,
                             device)


def vit_b_32(num_classes: int = 1000, image_size: int = 224, device=None):
    """ViT-Base/32 (88,224,232 parameters at 1000 classes)."""
    return VisionTransformer(image_size, 32, 12, 12, 768, num_classes,
                             device)


def vit_l_16(num_classes: int = 1000, image_size: int = 224, device=None):
    """ViT-Large/16 (304,326,632 parameters at 1000 classes)."""
    return VisionTransformer(image_size, 16, 24, 16, 1024, num_classes,
                             device)


def vit_l_32(num_classes: int = 1000, image_size: int = 224, device=None):
    """ViT-Large/32 (306,535,400 parameters at 1000 classes)."""
    return VisionTransformer(image_size, 32, 24, 16, 1024, num_classes,
                             device)
