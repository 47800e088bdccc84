"""ResNet-50 feature extractor and classifier (counterpart of
``video_edge_ai_proxy_tpu/models/resnet.py``).

Bottleneck v1.5 (the stride on the 3x3) in NCHW, with torchvision's
BatchNorm epsilon of 1e-5. ``forward(x, features_only=True)`` returns the
pooled embedding (2048 wide for ResNet-50) instead of logits: the re-ID
streams take embeddings, a classifier the logits, from one set of
weights. Submodules carry the flax scope names (``stem``,
``stage{si}_block{bi}.conv1``/``conv2``/``conv3``/``downsample``,
``classifier``), so ``models/carry.py`` maps weights across mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.preprocess import pad_channels
from .common import ConvBN, adaptive_avg_pool, init_convnet_weights

# torchvision's ResNets train with BatchNorm eps 1e-5; imported
# checkpoints reproduce their source only with it.
_BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    # Zero-pad the input from 3 to this many channels before the stem conv,
    # whose kernel is [W, pad, 7, 7]; the extra planes are zeros. 0 = off.
    stem_pad_c: int = 0


def tiny_resnet_config(num_classes: int = 10) -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes, stage_sizes=(1, 1), width=16)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to 4x ``features``, with a projected
    shortcut where the width or the stride changes."""

    def __init__(self, c_in: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out_ch = features * 4
        self.conv1 = ConvBN(c_in, features, 1, eps=_BN_EPS, dtype=dtype, act="relu")
        self.conv2 = ConvBN(features, features, 3, stride, eps=_BN_EPS, dtype=dtype, act="relu")
        self.conv3 = ConvBN(features, out_ch, 1, eps=_BN_EPS, dtype=dtype, act="identity")
        if c_in != out_ch or stride != 1:
            self.downsample = ConvBN(c_in, out_ch, 1, stride, eps=_BN_EPS, dtype=dtype,
                                     act="identity")
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class ResNet(nn.Module):
    # Its conv weights take channels_last on the card (registry.place).
    channels_last = True

    def __init__(self, cfg: ResNetConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.stem = ConvBN(max(3, cfg.stem_pad_c), cfg.width, 7, 2, eps=_BN_EPS, dtype=dtype,
                           act="relu")
        c_in = cfg.width
        self.blocks = []
        for si, n_blocks in enumerate(cfg.stage_sizes):
            feats = cfg.width * (2 ** si)
            for bi in range(n_blocks):
                name = f"stage{si}_block{bi}"
                setattr(self, name, Bottleneck(c_in, feats, 2 if (bi == 0 and si > 0) else 1,
                                               dtype))
                self.blocks.append(name)
                c_in = feats * 4
        self.features = c_in
        self.classifier = nn.Linear(c_in, cfg.num_classes, dtype=torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with flax's schemes
        (``common.init_convnet_weights``)."""
        init_convnet_weights(self, generator)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        """[B, H, W, 3] normalised RGB -> [B, num_classes] float32 logits,
        or with ``features_only`` the [B, features] float32 pooled
        embedding."""
        x = pad_channels(x.to(self.dtype), self.cfg.stem_pad_c)
        x = self.stem(x.permute(0, 3, 1, 2))
        # Explicit (1, 1) padding, as the JAX package pads (torch's
        # MaxPool2d(3, 2, padding=1); padding reads as -inf).
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = adaptive_avg_pool(x)
        if features_only:
            return x
        return self.classifier(x)
