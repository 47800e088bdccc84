"""Shared building blocks (counterpart of ``video_edge_ai_proxy_tpu/models/common.py``).

NCHW modules. Precision follows the JAX package's "mixed" policy: the conv
runs in the module's compute dtype (bf16 for serving), BatchNorm in
float32 on frozen statistics, the activation back in the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init: truncated normal (+-2 std) with
    variance 1/fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3, frozen statistics) -> SiLU.

    Padding is explicit symmetric k//2, as in the JAX package (not SAME,
    which at stride 2 pads (0, 1) on even inputs)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1,
                 eps: float = 1e-3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, padding=kernel // 2,
                              bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(c_out, eps=eps, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        y = F.batch_norm(y.float(), self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, training=False,
                         eps=self.bn.eps)
        return F.silu(y.to(self.conv.weight.dtype))


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding used by the width multiplier."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_depth(n: int, depth_multiple: float) -> int:
    """YOLO-family per-stage block-count scaling."""
    return max(1, round(n * depth_multiple))
