"""VideoMAE action recognizer (counterpart of ``video_edge_ai_proxy_tpu/models/videomae.py``), inference path.

Tubelet embedding (2x16x16) is a strided Conv3d; its tokens flatten in
(t', h', w') order, as flax's channels-last conv output does, and flow
through the shared encoder: T/2 * (224/16)^2 = 784 tokens for 8-frame
clips, 6272 for 64-frame clips (``videomae_b_long``), where the encoder's
``auto_attention`` goes to the flash kernel. A mean-pool float32
classification head follows. The MAE pretraining path (``encode_visible``,
the decoder and ``masked_pretrain_loss``) belongs to training and is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..ops.preprocess import pad_channels
from .common import lecun_normal_
from .transformer import AttnFn, Encoder, EncoderConfig, init_encoder_weights


@dataclass(frozen=True)
class VideoMAEConfig:
    num_classes: int = 400            # Kinetics-400
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 8
    tubelet_size: int = 2
    # Zero input channels appended before the tubelet conv (0 = off), as
    # in the JAX package: the kernel grows to pad_c input channels.
    patch_pad_c: int = 0
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # The MAE pretraining decoder's shape (not ported; kept so the two
    # packages' configs compare equal).
    decoder_layers: int = 4
    decoder_dim: int = 384

    @property
    def tokens_per_frame_group(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return (self.num_frames // self.tubelet_size) * self.tokens_per_frame_group

    @property
    def pixels_per_token(self) -> int:
        return self.tubelet_size * self.patch_size * self.patch_size * 3


def tiny_videomae_config(num_classes: int = 5) -> VideoMAEConfig:
    return VideoMAEConfig(
        num_classes=num_classes,
        image_size=32,
        patch_size=8,
        num_frames=4,
        tubelet_size=2,
        encoder=EncoderConfig(num_layers=2, dim=64, num_heads=4, mlp_dim=128),
        decoder_layers=1,
        decoder_dim=32,
    )


class TubeletEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int, tubelet_size: int,
                 dtype: torch.dtype = torch.bfloat16, pad_c: int = 0):
        super().__init__()
        self.dtype = dtype
        self.pad_c = pad_c
        p, ts = patch_size, tubelet_size
        self.proj = nn.Conv3d(max(3, pad_c), dim, (ts, p, p), stride=(ts, p, p), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B, tokens, dim], tokens in (t', h', w') order."""
        x = pad_channels(x.to(self.dtype), self.pad_c)
        y = self.proj(x.permute(0, 4, 1, 2, 3))          # [B, dim, T', H', W']
        return y.flatten(2).transpose(1, 2)


class VideoMAE(nn.Module):
    def __init__(self, cfg: VideoMAEConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dim = cfg.encoder.dim
        self.tubelet = TubeletEmbed(dim, cfg.patch_size, cfg.tubelet_size, dtype,
                                    pad_c=cfg.patch_pad_c)
        self.pos_embed = nn.Parameter(torch.zeros((1, cfg.num_tokens, dim), dtype=torch.float32))
        self.encoder = Encoder(cfg.encoder, dtype, attn_fn)
        self.head = nn.Linear(dim, cfg.num_classes, dtype=torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU generator, on a model still
        on the CPU) with the JAX package's schemes: lecun-normal conv and
        head kernels, normal(0.02) ``pos_embed``, the encoder's
        xavier-uniform Dense kernels, zero biases."""
        with torch.no_grad():
            for layer in (self.tubelet.proj, self.head):
                w = torch.empty(layer.weight.shape, dtype=torch.float32)
                layer.weight.copy_(lecun_normal_(w, generator))
                layer.bias.zero_()
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        init_encoder_weights(self.encoder, generator)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """Inference path: [B, T, H, W, 3] -> [B, num_classes] float32 logits."""
        x = self.tubelet(clips) + self.pos_embed.to(self.dtype)
        x = self.encoder(x)
        return self.head(x.float().mean(dim=1))
