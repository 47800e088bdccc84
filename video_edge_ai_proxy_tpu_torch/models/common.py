"""Shared building blocks (counterpart of ``video_edge_ai_proxy_tpu/models/common.py``).

NCHW modules. Precision follows the JAX package's "mixed" policy: the conv
runs in the module's compute dtype (bf16 for serving), BatchNorm in
float32, the activation back in the compute dtype. ``Linear``, ``Conv2d``
and ``Conv3d`` (the conv of ``ConvBN`` too) keep their parameters in a
``param_dtype`` of their own and cast them at use, as flax layers do.

BatchNorm runs on its frozen statistics unless ``batch_statistics(model)``
is entered: then every ``ConvBN`` of the model normalises by the batch's
statistics and updates its running ones as flax's ``BatchNorm(train=True,
momentum=0.97)`` does (``flax_batch_norm``). The mode follows that switch,
not ``module.training``: the JAX package passes ``train=`` explicitly.

``Int8Conv2d`` is the int8 activation path of ``ConvBN(act_int8=True)``
(the JAX ``_Int8Conv``): int8 x int8 products accumulated in int32, as an
explicit im2col and ``torch._int_mm`` on the card (torch has no int8
convolution there) and an int32 ``torch.mm`` on the CPU.
"""

from __future__ import annotations

import contextlib
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
    """Convolution whose parameters are kept in ``param_dtype`` and cast,
    with the input, to the compute ``dtype`` at use (see ``Linear``); mixed
    into ``nn.Conv2d`` and ``nn.Conv3d``. ``bias=False`` and ``groups`` as
    in torch; ``padding`` as ``nn.Conv2d`` takes it."""

    def __init__(self, c_in: int, c_out: int, kernel, stride, dtype: torch.dtype,
                 param_dtype: "torch.dtype | None" = None, **kw):
        super().__init__(c_in, c_out, kernel, stride=stride, dtype=param_dtype or dtype, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


def _pads(padding) -> tuple:
    """((top, bottom), (left, right)) -> F.pad's (left, right, top, bottom)."""
    (top, bottom), (left, right) = padding
    return (left, right, top, bottom)


def _mult8(n: int) -> int:
    return -(-n // 8) * 8


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [m, k] int8 times ``b`` [n, k] int8 transposed -> [m, n] int32
    through ``torch._int_mm``, zero-padded to its shape rules (m > 16, k
    and n multiples of 8): the padding adds nothing to any sum."""
    m, k = a.shape
    n = b.shape[0]
    m_pad, k_pad, n_pad = max(m, 17) - m, _mult8(k) - k, _mult8(n) - n
    if m_pad or k_pad:
        a = F.pad(a, (0, k_pad, 0, m_pad))
    if k_pad or n_pad:
        b = F.pad(b, (0, k_pad, 0, n_pad))
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding) -> torch.Tensor:
    """int8 convolution with int32 accumulation, exact: ``xq`` [B, Ci, H, W]
    int8, ``wq`` [Co, Ci, kh, kw] int8, ``padding`` ((top, bottom), (left,
    right)) -> [B, Co, Ho, Wo] int32 (an NHWC-ordered view).

    The im2col is strided views over the zero-padded NHWC plane, copied to
    [B*Ho*Wo, kh*kw*Ci] rows in (kh, kw, Ci) order, the order of the
    kernel's rows. On the card the product is ``torch._int_mm``, whose
    shape rules (more than 16 rows, a reduction and a width that are
    multiples of 8) are met by zero padding, which adds nothing to the
    sums; it raises for anything else. On the CPU (only for CPU tensors)
    the plain version is an int32 ``torch.mm`` of the same operands."""
    b, ci, h, w = xq.shape
    co, _, kh, kw = wq.shape
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0) + _pads(padding))
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    sb, sh, sw, sc = xp.stride()
    cols = xp.as_strided((b, ho, wo, kh, kw, ci),
                         (sb, stride * sh, stride * sw, sh, sw, sc)).reshape(b * ho * wo, -1)
    wmat = wq.permute(0, 2, 3, 1).reshape(co, -1)
    if xq.device.type == "cuda":
        y = _int_mm_padded(cols, wmat)
    elif xq.device.type == "cpu":
        y = torch.mm(cols.to(torch.int32), wmat.to(torch.int32).t())
    else:
        raise RuntimeError(f"int8_conv2d has no path for {xq.device.type} tensors")
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2)


class Int8Conv2d(nn.Conv2d):
    """The conv of ``ConvBN(act_int8=True)`` (the JAX ``_Int8Conv``): its
    ``weight`` is kept in float32 (flax's param dtype), so weight trees
    move between the fp and the int8 activation variants unchanged, and
    the buffer ``in_absmax`` (flax: ``quant/<scope>/conv/in_absmax``) holds
    the calibrated max-abs of its input.

    With ``calibrating`` set (``models/quantize.py`` ``calibrate_serving``)
    it records the running max-abs of its input and runs the fp conv in
    the compute dtype. Serving, the input quantizes against the static
    per-tensor scale ``s_in = max(in_absmax, 1e-8) / 127``, the kernel per
    output channel against ``s_w = max(|w|, 1e-12) / 127`` (round half to
    even, clip to +-127), the products accumulate in int32
    (``int8_conv2d``), and the result dequantizes as ``y * (s_in * s_w)``
    into the compute dtype. Served from a ``QuantizedTree``
    (``models/quantize.py`` ``QuantizedModel``), ``weight`` is the stored
    int8 kernel and the non-persistent ``weight_scale`` its per-channel
    scale, taken as they are: that kernel is the one requantizing its
    dequantized values would give."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, padding,
                 dtype: torch.dtype):
        super().__init__(c_in, c_out, kernel, stride, padding=0, bias=False,
                         dtype=torch.float32)
        self.pad = padding
        self.compute_dtype = dtype
        self.calibrating = False
        self.register_buffer("in_absmax", torch.zeros((), dtype=torch.float32))
        self.register_buffer("weight_scale", torch.zeros((0,), dtype=torch.float32),
                             persistent=False)

    def quantized(self, x: torch.Tensor) -> tuple:
        """(xq, wq, s_in, s_w): the int8 operands and their scales."""
        s_in = torch.clamp(self.in_absmax, min=1e-8) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(x.float() / s_in), -127, 127).to(torch.int8)
        if self.weight.dtype == torch.int8:
            return xq, self.weight, s_in, self.weight_scale
        w = self.weight.float()
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) * (1.0 / 127.0)
        wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
        return xq, wq, s_in, s_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.calibrating:
            self.in_absmax.copy_(torch.maximum(self.in_absmax, x.float().abs().amax()))
            return F.conv2d(F.pad(x.to(dt), _pads(self.pad)), self.weight.to(dt),
                            stride=self.stride)
        xq, wq, s_in, s_w = self.quantized(x)
        y = int8_conv2d(xq, wq, self.stride[0], self.pad)
        return (y.float() * (s_in * s_w)[None, :, None, None]).to(dt)


# The convnets' activations by the JAX package's names (``ACT``), applied
# in the compute dtype.
ACT = {
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "identity": lambda x: x,
}


# flax BatchNorm's momentum as the JAX package's ConvBN sets it: the running
# statistics keep 0.97 of themselves a training step.
BN_MOMENTUM = 0.97


def flax_batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False, momentum=0.97,
    dtype=float32)`` over NCHW ``y``: the batch mean and the biased
    variance ``max(E[x^2] - E[x]^2, 0)`` over (N, H, W) in float32 (flax's
    ``use_fast_variance``), ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, and the running update ``0.97 * running + 0.03 * batch`` of
    both statistics, the variance biased. (``F.batch_norm(training=True)``
    updates with the unbiased variance and weighs the new value by its
    ``momentum``.) Gradients flow through the batch statistics, as under
    ``jax.grad``. The normalisation is written out, not
    ``F.batch_norm(training=True)`` without buffers: that one's two-pass
    variance and fused backward round otherwise, and the stem's gradient of
    ``tiny_yolov8`` then misses flax's by 2.8e-4 (7.7e-4 relative)."""
    x = y.float()
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        running = [bn.running_mean, bn.running_var]
        torch._foreach_mul_(running, BN_MOMENTUM)
        torch._foreach_add_(running, [mean, var], alpha=1.0 - BN_MOMENTUM)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bn.bias.float()[None, :, None, None]


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm -> activation.

    Padding is explicit symmetric k//2, as in the JAX package (not SAME,
    which at stride 2 pads (0, 1) on even inputs), unless ``padding``
    ((top, bottom), (left, right)) says otherwise (the ``s2d`` stem's
    ((1, 0), (1, 0))). ``act`` is one of ``ACT`` (SiLU, the YOLO family's,
    by default; the ResNets take ReLU, MobileNetV2 ReLU6), ``eps`` the
    BatchNorm epsilon (1e-3, ultralytics'; torchvision's convnets train
    with 1e-5), ``groups`` the conv's feature groups (MobileNetV2's
    depthwise convs). The conv casts its weight to the compute ``dtype`` at
    use, so a model may keep it in float32 for training, as flax does
    (YOLOv8's ``param_dtype``); BatchNorm's terms are float32. BatchNorm
    runs on its running statistics unless ``update_stats`` is set
    (``batch_statistics``).
    ``act_int8`` swaps the conv for ``Int8Conv2d`` (serving only)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1,
                 eps: float = 1e-3, dtype: torch.dtype = torch.bfloat16,
                 padding=None, act_int8: bool = False, groups: int = 1, act: str = "silu"):
        super().__init__()
        pads = padding or ((kernel // 2,) * 2,) * 2
        self.pad = None
        self.compute_dtype = dtype
        self.update_stats = False
        if act_int8:
            if groups != 1:
                raise NotImplementedError("act_int8 with grouped convs")
            self.conv = Int8Conv2d(c_in, c_out, kernel, stride, pads, dtype)
        elif padding is None:
            self.conv = Conv2d(c_in, c_out, kernel, stride, dtype, padding=kernel // 2,
                               groups=groups, bias=False)
        else:
            self.pad = _pads(padding)
            self.conv = Conv2d(c_in, c_out, kernel, stride, dtype, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=eps, dtype=torch.float32)
        self.act = ACT[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x if self.pad is None else F.pad(x, self.pad))
        if self.update_stats:
            if isinstance(self.conv, Int8Conv2d):
                raise NotImplementedError("act_int8 is a serving-path quantization; train the "
                                          "fp variant and re-calibrate")
            y = flax_batch_norm(y, self.bn)
        else:
            y = F.batch_norm(y.float(), self.bn.running_mean, self.bn.running_var,
                             self.bn.weight, self.bn.bias, training=False, eps=self.bn.eps)
        return self.act(y.to(self.compute_dtype))


@contextlib.contextmanager
def batch_statistics(model: nn.Module, on: bool = True):
    """While entered, every ``ConvBN`` of ``model`` normalises by batch
    statistics and updates its running ones (``on``), as flax's
    ``apply(..., train=True, mutable=["batch_stats"])``; the previous modes
    come back at exit."""
    convbns = [m for m in model.modules() if isinstance(m, ConvBN)]
    before = [m.update_stats for m in convbns]
    for m in convbns:
        m.update_stats = on
    try:
        yield
    finally:
        for m, was in zip(convbns, before):
            m.update_stats = was


def init_convnet_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's init of a convnet, from ``generator`` (a CPU generator, on a
    model still on the CPU): lecun-normal conv and Dense kernels, zero
    biases, unit BatchNorm."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(lecun_normal_(w, generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool [N, C, H, W] -> [N, C] in float32."""
    return x.float().mean(dim=(2, 3))


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding used by the width multiplier."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_depth(n: int, depth_multiple: float) -> int:
    """YOLO-family per-stage block-count scaling."""
    return max(1, round(n * depth_multiple))
