"""MobileNetV2 classifier (counterpart of
``video_edge_ai_proxy_tpu/models/mobilenet_v2.py``).

The inverted-residual network of Sandler et al. (2018) in NCHW: a 1x1
expansion, a 3x3 depthwise conv (a grouped cuDNN conv on the card) and a
1x1 linear projection per block, ReLU6 activations and ultralytics'
BatchNorm epsilon of 1e-3, as in the JAX package. Submodules carry the
flax scope names (``stem``, ``stage{si}_block{bi}.expand``/``depthwise``
/``project``, ``head``, ``classifier``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch
from torch import nn

from ..ops.preprocess import pad_channels
from .common import ConvBN, adaptive_avg_pool, init_convnet_weights, make_divisible

# (expansion t, out channels c, repeats n, first stride s)
_MNV2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@dataclass(frozen=True)
class MobileNetV2Config:
    num_classes: int = 1000
    width_mult: float = 1.0
    stages: Sequence[tuple] = field(default=_MNV2_STAGES)
    stem_features: int = 32
    head_features: int = 1280
    # Zero-pad the input from 3 to this many channels before the stem conv;
    # the extra planes are zeros. 0 = off.
    stem_pad_c: int = 0


def tiny_mobilenet_v2_config(num_classes: int = 10) -> MobileNetV2Config:
    """Small config for CPU tests: 2 stages, thin channels."""
    return MobileNetV2Config(
        num_classes=num_classes,
        stages=((1, 16, 1, 1), (6, 24, 2, 2)),
        stem_features=16,
        head_features=64,
    )


class InvertedResidual(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int, expand: int,
                 dtype: torch.dtype):
        super().__init__()
        hidden = c_in * expand
        self.expand = (ConvBN(c_in, hidden, 1, dtype=dtype, act="relu6")
                       if expand != 1 else None)
        self.depthwise = ConvBN(hidden, hidden, 3, stride, dtype=dtype, groups=hidden,
                                act="relu6")
        self.project = ConvBN(hidden, features, 1, dtype=dtype, act="identity")
        self.residual = stride == 1 and c_in == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.depthwise(h))
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    # Its conv weights take channels_last on the card (registry.place).
    channels_last = True

    def __init__(self, cfg: MobileNetV2Config, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c_in = make_divisible(cfg.stem_features * cfg.width_mult)
        self.stem = ConvBN(max(3, cfg.stem_pad_c), c_in, 3, 2, dtype=dtype, act="relu6")
        self.blocks = []
        for si, (t, ch, n, s) in enumerate(cfg.stages):
            out_ch = make_divisible(ch * cfg.width_mult)
            for bi in range(n):
                name = f"stage{si}_block{bi}"
                setattr(self, name, InvertedResidual(c_in, out_ch, s if bi == 0 else 1, t,
                                                     dtype))
                self.blocks.append(name)
                c_in = out_ch
        head = make_divisible(cfg.head_features * max(1.0, cfg.width_mult))
        self.head = ConvBN(c_in, head, 1, dtype=dtype, act="relu6")
        self.classifier = nn.Linear(head, cfg.num_classes, dtype=torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with flax's schemes
        (``common.init_convnet_weights``)."""
        init_convnet_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalised RGB -> [B, num_classes] float32 logits."""
        x = pad_channels(x.to(self.dtype), self.cfg.stem_pad_c)
        x = self.stem(x.permute(0, 3, 1, 2))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.classifier(adaptive_avg_pool(self.head(x)))
