"""Shared building blocks (counterpart of ``video_edge_ai_proxy_tpu/models/common.py``).

NCHW modules. Precision follows the JAX package's "mixed" policy: the conv
runs in the module's compute dtype (bf16 for serving), BatchNorm in
float32 on frozen statistics, the activation back in the compute dtype.
``Linear``, ``Conv2d`` and ``Conv3d`` keep their parameters in a
``param_dtype`` of their own and cast them at use, as flax layers do.
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


def normal_(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """A float32 CPU tensor of normal(0, ``std``) draws from ``generator``
    (flax ``initializers.normal``), to be copied onto a parameter on any
    device."""
    return torch.empty(shape, dtype=torch.float32).normal_(0.0, std, generator=generator)


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense(dtype, param_dtype)`` precision: the
    weight and bias are kept in ``param_dtype`` (default: ``dtype``) and
    cast, with the input, to the compute ``dtype`` at use. With float32
    parameters and bf16 compute, an optimizer updates float32 master
    weights, as optax does in the JAX package."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 param_dtype: "torch.dtype | None" = None):
        super().__init__(in_features, out_features, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _CastConv:
    """Convolution (with bias) whose parameters are kept in ``param_dtype``
    and cast, with the input, to the compute ``dtype`` at use (see
    ``Linear``); mixed into ``nn.Conv2d`` and ``nn.Conv3d``."""

    def __init__(self, c_in: int, c_out: int, kernel, stride, dtype: torch.dtype,
                 param_dtype: "torch.dtype | None" = None):
        super().__init__(c_in, c_out, kernel, stride=stride, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


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
