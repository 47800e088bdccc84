"""ViT-B/16 frame tagger (counterpart of ``video_edge_ai_proxy_tpu/models/vit.py``).

Patchify is one strided conv; a class token and learned position
embeddings go in front of the shared encoder, and a float32 classifier
reads the class token. Input is NHWC, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..ops.preprocess import pad_channels
from .common import Conv2d, lecun_normal_, normal_
from .transformer import AttnFn, Encoder, EncoderConfig, init_encoder_weights


@dataclass(frozen=True)
class ViTConfig:
    num_classes: int = 1000
    image_size: int = 224
    patch_size: int = 16
    encoder: EncoderConfig = field(default_factory=EncoderConfig)  # B/16 defaults
    # Zero input channels appended before the patchify conv (0 = off), as
    # in the JAX package.
    patch_pad_c: int = 0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def tiny_vit_config(num_classes: int = 10) -> ViTConfig:
    return ViTConfig(
        num_classes=num_classes,
        image_size=32,
        patch_size=8,
        encoder=EncoderConfig(num_layers=2, dim=64, num_heads=4, mlp_dim=128),
    )


class ViT(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` (default: ``dtype``)
    that of the patch conv and the encoder's Dense layers, cast at use.
    ``cls_token``, ``pos_embed``, the LayerNorms and the classifier are
    float32, as in the JAX package."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dim, p = cfg.encoder.dim, cfg.patch_size
        self.patch_embed = Conv2d(max(3, cfg.patch_pad_c), dim, p, p, dtype, param_dtype)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, dim), dtype=torch.float32))
        self.pos_embed = nn.Parameter(
            torch.zeros((1, cfg.num_patches + 1, dim), dtype=torch.float32))
        self.encoder = Encoder(cfg.encoder, dtype, attn_fn, param_dtype)
        self.classifier = nn.Linear(dim, cfg.num_classes, dtype=torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU generator; the model may be
        on any device) with the JAX package's schemes: lecun-normal conv and
        classifier kernels, zero ``cls_token``, normal(0.02) ``pos_embed``,
        the encoder's xavier-uniform Dense kernels, zero biases."""
        with torch.no_grad():
            for layer in (self.patch_embed, self.classifier):
                w = torch.empty(layer.weight.shape, dtype=torch.float32)
                layer.weight.copy_(lecun_normal_(w, generator))
                layer.bias.zero_()
            self.cls_token.zero_()
            self.pos_embed.copy_(normal_(self.pos_embed.shape, 0.02, generator))
        init_encoder_weights(self.encoder, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalised RGB -> [B, num_classes] float32 logits."""
        x = pad_channels(x.to(self.dtype), self.cfg.patch_pad_c)
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.encoder(x)
        return self.classifier(x[:, 0].float())
