"""VideoMAE action recognizer and its MAE pretraining objective
(counterpart of ``video_edge_ai_proxy_tpu/models/videomae.py``).

Tubelet embedding (2x16x16) is a strided Conv3d; its tokens flatten in
(t', h', w') order, as flax's channels-last conv output does, and flow
through the shared encoder: T/2 * (224/16)^2 = 784 tokens for 8-frame
clips, 6272 for 64-frame clips (``videomae_b_long``), where the encoder's
``auto_attention`` goes to the flash kernels. A mean-pool float32
classification head follows.

The pretraining path: ``VideoMAE.encode_visible`` runs the encoder over
ALL tokens with the masked ones zeroed (the JAX package's static-shape
variant of token dropping), ``VideoMAEDecoder`` (a narrow encoder of its
own, ``max(1, decoder_dim // 64)`` heads, float32 pixel head)
reconstructs each token's pixels, and ``masked_pretrain_loss`` is the MSE
on normalized pixels of the masked tokens. ``VideoMAEPretrain`` holds the
two halves under the names of the JAX pretraining tree
(``{"encoder": ..., "decoder": ...}``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..ops.preprocess import pad_channels
from .common import Conv3d, Linear, lecun_normal_, normal_
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
    # The MAE pretraining decoder: a narrow 4-layer encoder of its own.
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


def _init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax Dense/Conv default init: lecun-normal kernel, zero bias."""
    w = torch.empty(layer.weight.shape, dtype=torch.float32)
    layer.weight.copy_(lecun_normal_(w, generator))
    layer.bias.zero_()


class TubeletEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int, tubelet_size: int,
                 dtype: torch.dtype = torch.bfloat16, pad_c: int = 0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.pad_c = pad_c
        p, ts = patch_size, tubelet_size
        self.proj = Conv3d(max(3, pad_c), dim, (ts, p, p), (ts, p, p), dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B, tokens, dim], tokens in (t', h', w') order."""
        x = pad_channels(x.to(self.dtype), self.pad_c)
        y = self.proj(x.permute(0, 4, 1, 2, 3))          # [B, dim, T', H', W']
        return y.flatten(2).transpose(1, 2)


class VideoMAE(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` (default: ``dtype``)
    that of the tubelet conv and the encoder's Dense layers, cast at use.
    ``pos_embed``, the LayerNorms and the head are float32. ``head=False``
    leaves the classification head out, as in the JAX pretraining tree
    (initialised through ``encode_visible``, which never reaches it)."""

    def __init__(self, cfg: VideoMAEConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None,
                 head: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dim = cfg.encoder.dim
        self.tubelet = TubeletEmbed(dim, cfg.patch_size, cfg.tubelet_size, dtype,
                                    pad_c=cfg.patch_pad_c, param_dtype=param_dtype)
        self.pos_embed = nn.Parameter(torch.zeros((1, cfg.num_tokens, dim), dtype=torch.float32))
        self.encoder = Encoder(cfg.encoder, dtype, attn_fn, param_dtype)
        self.head = nn.Linear(dim, cfg.num_classes, dtype=torch.float32) if head else None

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU generator; the model may be
        on any device) with the JAX package's schemes: lecun-normal conv and
        head kernels, normal(0.02) ``pos_embed``, the encoder's
        xavier-uniform Dense kernels, zero biases."""
        with torch.no_grad():
            for layer in (self.tubelet.proj, self.head):
                if layer is not None:
                    _init_linear(layer, generator)
            self.pos_embed.copy_(normal_(self.pos_embed.shape, 0.02, generator))
        init_encoder_weights(self.encoder, generator)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """Fine-tune / inference path: [B, T, H, W, 3] -> [B, num_classes]
        float32 logits."""
        x = self.tubelet(clips) + self.pos_embed.to(self.dtype)
        x = self.encoder(x)
        return self.head(x.float().mean(dim=1))

    def encode_visible(self, clips: torch.Tensor, keep_mask: torch.Tensor) -> torch.Tensor:
        """MAE pretraining encoder pass over ALL tokens with the masked
        ones zeroed (a fixed shape, as in the JAX package): [B, T, H, W, 3]
        clips and a [B, tokens] bool ``keep_mask`` (True = visible) ->
        [B, tokens, dim] in the compute dtype."""
        x = self.tubelet(clips) + self.pos_embed.to(self.dtype)
        x = torch.where(keep_mask[..., None], x, torch.zeros_like(x))
        return self.encoder(x)


class VideoMAEDecoder(nn.Module):
    """Narrow decoder reconstructing the tubelet pixels of every token:
    ``dec_embed`` to ``decoder_dim``, ``dec_pos`` (float32), an encoder of
    ``decoder_layers`` blocks with ``max(1, decoder_dim // 64)`` heads and a
    4x MLP, and the float32 pixel head ``dec_pred``."""

    def __init__(self, cfg: VideoMAEConfig, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.decoder_dim
        dec_cfg = EncoderConfig(num_layers=cfg.decoder_layers, dim=d,
                                num_heads=max(1, d // 64), mlp_dim=d * 4)
        self.dec_embed = Linear(cfg.encoder.dim, d, dtype, param_dtype)
        self.dec_pos = nn.Parameter(torch.zeros((1, cfg.num_tokens, d), dtype=torch.float32))
        self.decoder = Encoder(dec_cfg, dtype, param_dtype=param_dtype)
        self.dec_pred = nn.Linear(d, cfg.pixels_per_token, dtype=torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: lecun-normal ``dec_embed`` and
        ``dec_pred`` kernels, normal(0.02) ``dec_pos``, the encoder's
        xavier-uniform Dense kernels, zero biases."""
        with torch.no_grad():
            for layer in (self.dec_embed, self.dec_pred):
                _init_linear(layer, generator)
            self.dec_pos.copy_(normal_(self.dec_pos.shape, 0.02, generator))
        init_encoder_weights(self.decoder, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, tokens, dim] -> [B, tokens, pixels_per_token] float32."""
        x = self.dec_embed(tokens) + self.dec_pos.to(self.dtype)
        return self.dec_pred(self.decoder(x).float())


def tubelet_pixels(clips: torch.Tensor, cfg: VideoMAEConfig) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, tokens, pixels_per_token] ground-truth targets,
    ordered to match the tubelet conv's tokens (t-group, h, w)."""
    b, t, h, w, _ = clips.shape
    p, ts = cfg.patch_size, cfg.tubelet_size
    x = clips.reshape(b, t // ts, ts, h // p, p, w // p, p, 3)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # b, tg, hh, ww, ts, p, p, c
    return x.reshape(b, (t // ts) * (h // p) * (w // p), ts * p * p * 3)


def masked_pretrain_loss(model: VideoMAE, decoder: VideoMAEDecoder, clips: torch.Tensor,
                         keep_mask: torch.Tensor) -> torch.Tensor:
    """VideoMAE objective: MSE on per-token normalized pixels of the MASKED
    tokens only (a float32 scalar). Dropout follows the modules'
    ``train()`` mode; the JAX function runs them in training mode."""
    pred = decoder(model.encode_visible(clips, keep_mask))
    target = tubelet_pixels(clips.float(), model.cfg)
    mu = target.mean(dim=-1, keepdim=True)
    sd = target.std(dim=-1, keepdim=True, correction=0) + 1e-6   # jnp.std: ddof 0
    err = ((pred - (target - mu) / sd) ** 2).mean(dim=-1)         # [B, tokens]
    masked = ~keep_mask
    return (err * masked).sum() / masked.sum().clamp(min=1)


def tube_keep_mask(batch: int, cfg: VideoMAEConfig, mask_ratio: float,
                   generator: torch.Generator) -> torch.Tensor:
    """VideoMAE's tube masking: per clip, ``round(mask_ratio * positions)``
    of the ``tokens_per_frame_group`` spatial positions, drawn from
    ``generator`` (CPU), are masked in every frame group. -> [B, tokens]
    bool on the CPU, True = visible."""
    n = cfg.tokens_per_frame_group
    n_masked = round(mask_ratio * n)
    ranks = torch.rand((batch, n), generator=generator).argsort(dim=-1).argsort(dim=-1)
    keep = ranks >= n_masked
    return keep.repeat(1, cfg.num_tokens // n)


class VideoMAEPretrain(nn.Module):
    """The pretraining pair under the JAX tree's names: ``encoder`` (a
    ``VideoMAE`` without head) and ``decoder``. ``forward(clips, keep_mask)``
    is ``masked_pretrain_loss``."""

    def __init__(self, cfg: VideoMAEConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoMAE(cfg, dtype, attn_fn, param_dtype, head=False)
        self.decoder = VideoMAEDecoder(cfg, dtype, param_dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)

    def forward(self, clips: torch.Tensor, keep_mask: torch.Tensor) -> torch.Tensor:
        return masked_pretrain_loss(self.encoder, self.decoder, clips, keep_mask)
