"""YOLOv8 detector (counterpart of ``video_edge_ai_proxy_tpu/models/yolov8.py``).

Anchor-free YOLOv8: CSP backbone with C2f blocks, SPPF, PAN-FPN neck and a
decoupled DFL head, in NCHW. Submodules are named after the flax scopes
(``stem``, ``down2``, ``c2f_2.m0.cv1``, ``detect.box0_cv1``, ...), so
``models/carry.py`` maps weights across mechanically.

Precision: the backbone, neck and head ConvBNs run in the model's compute
dtype (bf16 for serving); the head's 1x1 output convs, the DFL softmax and
the class reduction run in float32, as in the JAX package. ``param_dtype``
(default: the compute dtype) is the dtype the ConvBN conv kernels are kept
in: float32 for bf16 training, where the optimizer updates float32 master
weights as optax does (the head's output convs are float32 either way).
``decode=False`` returns the raw per-level head output the detection loss
reads (``models/detect_loss.py``); under ``common.batch_statistics`` its
BatchNorms run in train mode.

Variant axes of the config, as in JAX: ``stem="s2d"`` folds 2x2 pixel
blocks into channels (3 -> 12) and runs a stride-1 2x2 stem conv over
the half-size plane, the lossless fold of the classic stride-2 3x3 stem
(``models/carry.py`` ``s2d_fold_kernel``); ``act_int8`` runs every ConvBN
but the stem through ``common.Int8Conv2d`` (serving only).

Where the JAX package flattens NHWC maps ``[b, h, w, C] -> [b, h*w, C]``,
this module permutes NCHW to NHWC first, so anchors come out in the same
order; DFL logits reshape as ``(..., 4, reg_max)`` with the bins innermost.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import dist_to_bbox
from ..ops.preprocess import pad_channels, space_to_depth
from .common import ConvBN, Int8Conv2d, init_convnet_weights, make_divisible, round_depth


@dataclass(frozen=True)
class YOLOv8Config:
    num_classes: int = 80
    depth_mult: float = 0.33      # n
    width_mult: float = 0.25      # n
    max_channels: int = 1024
    reg_max: int = 16             # DFL bins
    strides: Sequence[int] = (8, 16, 32)
    # "classic": stride-2 3x3 stem on [B, 3, S, S]; "s2d": stride-1 2x2
    # stem, padding ((1, 0), (1, 0)), on the [B, 12, S/2, S/2] plane.
    stem: str = "classic"
    # int8 x int8 convs with calibrated input scales in every ConvBN but
    # the stem (the head's 1x1 output convs stay float32).
    act_int8: bool = False
    # Zero-pad the input from 3 to this many channels before the stem conv,
    # whose kernel is [C, pad, 3, 3]; the extra planes are zeros. 0 = off;
    # no-op under the 12-channel s2d plane when pad <= 12.
    stem_pad_c: int = 0

    def ch(self, c: int) -> int:
        return make_divisible(min(c, self.max_channels) * self.width_mult)

    def depth(self, n: int) -> int:
        return round_depth(n, self.depth_mult)


def yolov8n_config(num_classes: int = 80) -> YOLOv8Config:
    return YOLOv8Config(num_classes=num_classes, stem_pad_c=8)


def yolov8s_config(num_classes: int = 80) -> YOLOv8Config:
    return YOLOv8Config(num_classes=num_classes, depth_mult=0.33, width_mult=0.5,
                        stem_pad_c=8)


def tiny_yolov8_config(num_classes: int = 4) -> YOLOv8Config:
    """Test config: 1/8 width, input 64² -> 84 anchors."""
    return YOLOv8Config(num_classes=num_classes, depth_mult=0.33, width_mult=0.125)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, shortcut: bool, dtype, q: bool = False):
        super().__init__()
        self.cv1 = ConvBN(c_in, features, 3, dtype=dtype, act_int8=q)
        self.cv2 = ConvBN(features, features, 3, dtype=dtype, act_int8=q)
        self.add = shortcut and c_in == features

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return h + x if self.add else h


class C2f(nn.Module):
    """Cross-stage partial block: split, n bottlenecks, dense concat."""

    def __init__(self, c_in: int, features: int, n: int, shortcut: bool, dtype,
                 q: bool = False):
        super().__init__()
        hidden = features // 2
        self.hidden = hidden
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1, dtype=dtype, act_int8=q)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, dtype, q))
        self.cv2 = ConvBN((2 + n) * hidden, features, 1, dtype=dtype, act_int8=q)

    def forward(self, x):
        h = self.cv1(x)
        parts = [h[:, :self.hidden], h[:, self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max pools, concat.
    Max pooling pads with -inf, like flax's SAME max_pool."""

    def __init__(self, c_in: int, features: int, dtype, q: bool = False):
        super().__init__()
        hidden = features // 2
        self.cv1 = ConvBN(c_in, hidden, 1, dtype=dtype, act_int8=q)
        self.cv2 = ConvBN(4 * hidden, features, 1, dtype=dtype, act_int8=q)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 (output pixel (y, x) reads input (y // 2, x // 2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DetectHead(nn.Module):
    """Decoupled per-level head: box branch (4*reg_max DFL logits) and
    class branch (num_classes logits); the 1x1 output convs are float32."""

    def __init__(self, cfg: YOLOv8Config, level_ch: Sequence[int], dtype):
        super().__init__()
        self.cfg = cfg
        c_box = max(16, level_ch[0] // 4, cfg.reg_max * 4)
        c_cls = max(level_ch[0], min(cfg.num_classes, 100))
        q = cfg.act_int8
        for i, lc in enumerate(level_ch):
            setattr(self, f"box{i}_cv1", ConvBN(lc, c_box, 3, dtype=dtype, act_int8=q))
            setattr(self, f"box{i}_cv2", ConvBN(c_box, c_box, 3, dtype=dtype, act_int8=q))
            setattr(self, f"box{i}_out", nn.Conv2d(c_box, 4 * cfg.reg_max, 1,
                                                   dtype=torch.float32))
            setattr(self, f"cls{i}_cv1", ConvBN(lc, c_cls, 3, dtype=dtype, act_int8=q))
            setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3, dtype=dtype, act_int8=q))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, cfg.num_classes, 1,
                                                   dtype=torch.float32))
        self.levels = len(level_ch)

    def prior_biases(self):
        """(module, bias) pairs of the two init priors: the DFL bin prior
        (expected ltrb distance ~1.5 strides) and the class prior (~5
        objects per 640-px image per level)."""
        c = self.cfg
        dfl = (-0.5 * torch.arange(c.reg_max, dtype=torch.float32)).repeat(4)
        for i in range(self.levels):
            prior = math.log(5 / c.num_classes / (640 / c.strides[i]) ** 2)
            yield getattr(self, f"box{i}_out"), dfl
            yield (getattr(self, f"cls{i}_out"),
                   torch.full((c.num_classes,), prior, dtype=torch.float32))

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            box = getattr(self, f"box{i}_cv2")(getattr(self, f"box{i}_cv1")(f))
            box = getattr(self, f"box{i}_out")(box.float())
            cls = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            cls = getattr(self, f"cls{i}_out")(cls.float())
            outs.append((box, cls))
        return outs


def _anchor_points(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """Cell-centre anchor points in input pixels, [h*w, 2] (x, y), row-major
    over (y, x)."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def decode_level(box_logits: torch.Tensor, stride: int, reg_max: int) -> torch.Tensor:
    """DFL decode one level: [B, 4*reg_max, h, w] -> xyxy [B, h*w, 4] px."""
    b, _, h, w = box_logits.shape
    logits = box_logits.permute(0, 2, 3, 1).reshape(b, h * w, 4, reg_max)
    probs = torch.softmax(logits.float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    dist = torch.matmul(probs, bins) * stride          # ltrb, px
    return dist_to_bbox(dist, _anchor_points(h, w, stride, box_logits.device))


class YOLOv8(nn.Module):
    # Its conv weights take channels_last on the card (registry.place).
    channels_last = True

    def __init__(self, cfg: YOLOv8Config, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: "torch.dtype | None" = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        ch, d, q = cfg.ch, cfg.depth, cfg.act_int8
        if cfg.stem == "s2d":
            # The lossless fold of the classic stem onto the s2d plane:
            # classic output pixel p reads input rows 2p-1..2p+1, which lie
            # in s2d rows p-1 (offset 1) and p (offsets 0, 1); the leading
            # pad gives row -1. Kept fp under act_int8.
            self.stem = ConvBN(max(12, cfg.stem_pad_c), ch(64), 2, 1, dtype=dtype,
                               padding=((1, 0), (1, 0)))                     # P1
        elif cfg.stem == "classic":
            self.stem = ConvBN(max(3, cfg.stem_pad_c), ch(64), 3, 2, dtype=dtype)  # P1
        else:
            raise ValueError(f"stem={cfg.stem!r} unsupported ('classic' or 's2d')")
        self.down2 = ConvBN(ch(64), ch(128), 3, 2, dtype=dtype, act_int8=q)  # P2
        self.c2f_2 = C2f(ch(128), ch(128), d(3), True, dtype, q)
        self.down3 = ConvBN(ch(128), ch(256), 3, 2, dtype=dtype, act_int8=q)  # P3
        self.c2f_3 = C2f(ch(256), ch(256), d(6), True, dtype, q)
        self.down4 = ConvBN(ch(256), ch(512), 3, 2, dtype=dtype, act_int8=q)  # P4
        self.c2f_4 = C2f(ch(512), ch(512), d(6), True, dtype, q)
        self.down5 = ConvBN(ch(512), ch(1024), 3, 2, dtype=dtype, act_int8=q)  # P5
        self.c2f_5 = C2f(ch(1024), ch(1024), d(3), True, dtype, q)
        self.sppf = SPPF(ch(1024), ch(1024), dtype, q)
        self.neck_up4 = C2f(ch(1024) + ch(512), ch(512), d(3), False, dtype, q)
        self.neck_up3 = C2f(ch(512) + ch(256), ch(256), d(3), False, dtype, q)
        self.neck_down4 = ConvBN(ch(256), ch(256), 3, 2, dtype=dtype, act_int8=q)
        self.neck_out4 = C2f(ch(256) + ch(512), ch(512), d(3), False, dtype, q)
        self.neck_down5 = ConvBN(ch(512), ch(512), 3, 2, dtype=dtype, act_int8=q)
        self.neck_out5 = C2f(ch(512) + ch(1024), ch(1024), d(3), False, dtype, q)
        self.detect = DetectHead(cfg, [ch(256), ch(512), ch(1024)], dtype)
        if param_dtype is not None:
            for m in self.modules():
                if isinstance(m, ConvBN) and not isinstance(m.conv, Int8Conv2d):
                    m.conv.to(param_dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU generator, on a model that
        is still on the CPU): flax's schemes -- lecun-normal conv kernels,
        unit BatchNorm, and the head's two bias priors."""
        init_convnet_weights(self, generator)
        with torch.no_grad():
            for conv, bias in self.detect.prior_biases():
                conv.bias.copy_(bias)

    def forward(self, x: torch.Tensor, decode=True):
        """[B, 3, S, S] normalised RGB (the ``s2d`` stem also takes the folded
        [B, 12, S/2, S/2] plane) -> head output, by ``decode`` mode:

        - ``True``: ``(boxes [B, A, 4], scores [B, A, C])``, per-class
          sigmoid probabilities.
        - ``False``: raw per-level ``(box_logits, cls_logits)`` NCHW pairs.
        - ``"serving"``: ``(boxes [B, A, 4], max_logit [B, A], cls_ids
          [B, A] int32)`` -- the class reduction in logit space; argmax
          takes the first maximum.
        """
        c = self.cfg
        x = x.to(self.dtype)
        if c.stem == "s2d" and x.shape[1] == 3:
            x = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = pad_channels(x, c.stem_pad_c, dim=1)
        x = self.down2(self.stem(x))
        x = self.c2f_2(x)
        p3 = self.c2f_3(self.down3(x))
        p4 = self.c2f_4(self.down4(p3))
        p5 = self.sppf(self.c2f_5(self.down5(p4)))

        n4 = self.neck_up4(torch.cat([_upsample2(p5), p4], dim=1))
        n3 = self.neck_up3(torch.cat([_upsample2(n4), p3], dim=1))
        o4 = self.neck_out4(torch.cat([self.neck_down4(n3), n4], dim=1))
        o5 = self.neck_out5(torch.cat([self.neck_down5(o4), p5], dim=1))

        head_out = self.detect([n3, o4, o5])
        if decode is False:
            return head_out

        boxes, cls_flat = [], []
        for (box_l, cls_l), stride in zip(head_out, c.strides):
            boxes.append(decode_level(box_l, stride, c.reg_max))
            b_, _, h_, w_ = cls_l.shape
            cls_flat.append(cls_l.permute(0, 2, 3, 1).reshape(b_, h_ * w_, c.num_classes))
        boxes = torch.cat(boxes, dim=1)
        cls_flat = torch.cat(cls_flat, dim=1)
        if decode == "serving":
            return (boxes, cls_flat.amax(dim=-1),
                    cls_flat.argmax(dim=-1).to(torch.int32))
        return boxes, torch.sigmoid(cls_flat)
