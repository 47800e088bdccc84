"""Preprocessing on the device: uint8 frames in, model input out.

Counterpart of the serving subset of
``video_edge_ai_proxy_tpu/ops/preprocess.py``: the detector's letterbox,
its fused space-to-depth form for the ``s2d`` stem, the classifier's
stretch-resize + ImageNet normalisation, and the video clip path. Frames cross to the card as
uint8 NHWC BGR24 exactly as they sit on the frame bus; the cast, /255,
resize, BGR->RGB flip and letterbox pad all happen on the card. The
public functions keep the JAX package's NHWC layout, so the two compare
like with like; the serving step hands the result to the NCHW model as a
permuted view (which is channels_last memory, free on the card).

The resize is the antialiased triangle filter with half-pixel centres of
``jax.image.resize(method="bilinear")``, as two dense matrix products
against ``_resize_matrix`` -- not ``F.interpolate``, whose bilinear mode
has no antialias.

Every constant a call needs (the resize matrices, 1/255, the ImageNet
mean and 1/std, the unletterbox shift, the luma weights) is built once per
(device, dtype, geometry) by ``_constant`` and kept on the device, so a
call on the card makes no host-to-device copy and never waits for the
device: a CUDA graph captures it as it is.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# Standard ImageNet statistics (RGB order), used by every classifier.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=64)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] bilinear resize matrix (antialiased triangle filter for
    downscaling, half-pixel centres, per-row weight normalisation)."""
    scale = src / dst
    s = max(1.0, scale)                 # antialias: widen kernel when shrinking
    out = np.zeros((dst, src), np.float32)
    for o in range(dst):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - s)) + 1
        hi = int(np.ceil(center + s))
        idx = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(idx - center) / s)
        valid = (idx >= 0) & (idx < src)
        idx, w = idx[valid], w[valid]
        out[o, idx] = w / w.sum()
    return out


# Unbounded on purpose: a captured CUDA graph reads a constant by its
# address, so a constant must live as long as the process. The keys are
# the few (device, dtype, geometry) combinations a server meets.
@functools.lru_cache(maxsize=None)
def _constant(kind: str, key: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The device tensor of constant ``kind`` for ``key``, built on first
    use by the same expression as an uncached call would use, and cached.
    Built outside inference mode, so that a tensor first made by a serving
    step can also enter a computation that records gradients."""
    with torch.inference_mode(False):
        if kind == "resize":
            return torch.from_numpy(_resize_matrix(*key)).to(device=device, dtype=dtype)
        if kind == "fused":
            return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                         for a in _fused_letterbox_arrays(*key))
        if kind == "inv255":
            values = 1.0 / 255.0
        elif kind == "mean":
            values = list(key)
        elif kind == "inv_std":
            values = [1.0 / s for s in key]
        elif kind == "shift":
            values = [key.pad_x, key.pad_y, key.pad_x, key.pad_y]
        elif kind == "luma":
            values = _LUMA_BGR
        else:
            raise ValueError(f"unknown constant {kind!r}")
        return torch.tensor(values, dtype=dtype, device=device)


def _matrix(src: int, dst: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _constant("resize", (src, dst), dtype, torch.device(device))


def resize_bilinear(x: torch.Tensor, dst_hw: tuple) -> torch.Tensor:
    """Separable bilinear resize as two matrix products.

    [N, H, W, C] float -> [N, h, w, C] in ``x.dtype``."""
    if not x.is_floating_point():
        raise TypeError(f"resize_bilinear needs a float input, got {x.dtype}; "
                        "scale uint8 frames first")
    h, w = x.shape[1], x.shape[2]
    th, tw = dst_hw
    if (h, w) == (th, tw):
        return x
    rh = _matrix(h, th, x.dtype, x.device)
    rw = _matrix(w, tw, x.dtype, x.device)
    y = torch.einsum("hH,nHWc->nhWc", rh, x)
    return torch.einsum("wW,nhWc->nhwc", rw, y)


def pad_channels(x: torch.Tensor, pad_c: int, dim: int = -1) -> torch.Tensor:
    """Zero-pad channel axis ``dim`` up to ``pad_c``; no-op when it already
    has that many channels."""
    c = x.shape[dim]
    if pad_c <= c:
        return x
    shape = list(x.shape)
    shape[dim] = pad_c - c
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _scaled(frames_u8: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> [0, 1] in ``out_dtype``. The 1/255 constant is rounded to
    ``out_dtype`` first, as JAX does with its weakly typed Python float (a
    Python float here would multiply in float32)."""
    inv = _constant("inv255", (), out_dtype, frames_u8.device)
    return frames_u8.to(out_dtype) * inv


def preprocess_classify(
    frames_u8: torch.Tensor,
    size: tuple = (224, 224),
    mean: tuple = IMAGENET_MEAN,
    std: tuple = IMAGENET_STD,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Classifier path: [N, H, W, 3] uint8 BGR -> [N, h, w, 3] RGB,
    normalised in float32, returned in ``out_dtype``. The resize stretches
    (no aspect preservation)."""
    x = resize_bilinear(_scaled(frames_u8, out_dtype), size).flip(-1)
    mean_a = _constant("mean", tuple(mean), torch.float32, x.device)
    inv_std = _constant("inv_std", tuple(std), torch.float32, x.device)
    return ((x.float() - mean_a) * inv_std).to(out_dtype)


def preprocess_clip(
    clips_u8: torch.Tensor,
    size: tuple = (224, 224),
    mean: tuple = IMAGENET_MEAN,
    std: tuple = IMAGENET_STD,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Video path: [N, T, H, W, 3] uint8 -> [N, T, h, w, 3], the classifier
    path with the time axis folded into the batch."""
    n, t = clips_u8.shape[:2]
    out = preprocess_classify(clips_u8.reshape((n * t,) + tuple(clips_u8.shape[2:])),
                              size=size, mean=mean, std=std, out_dtype=out_dtype)
    return out.reshape((n, t) + tuple(out.shape[1:]))


class LetterboxParams(NamedTuple):
    """Static geometry of a letterbox resize."""

    scale: float      # source px * scale = letterboxed px
    pad_x: float      # left padding in letterboxed px
    pad_y: float      # top padding in letterboxed px
    new_w: int
    new_h: int


def letterbox_params(src_hw: tuple, dst: int) -> LetterboxParams:
    """Letterbox geometry for a source shape. Python ``round`` (half to
    even), exactly as the JAX package computes it."""
    h, w = src_hw
    scale = min(dst / h, dst / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    pad_y = (dst - new_h) / 2.0
    pad_x = (dst - new_w) / 2.0
    return LetterboxParams(scale, pad_x, pad_y, new_w, new_h)


def preprocess_letterbox(
    frames_u8: torch.Tensor,
    dst: int = 640,
    pad_value: float = 114.0 / 255.0,
    out_dtype: torch.dtype = torch.bfloat16,
) -> tuple:
    """[N, H, W, 3] uint8 BGR -> ([N, dst, dst, 3] letterboxed RGB in
    [0, 1] of ``out_dtype``, LetterboxParams)."""
    params = letterbox_params(tuple(frames_u8.shape[1:3]), dst)
    x = resize_bilinear(_scaled(frames_u8, out_dtype), (params.new_h, params.new_w)).flip(-1)
    top = int(round(params.pad_y))
    left = int(round(params.pad_x))
    x = torch.nn.functional.pad(
        x,
        (0, 0, left, dst - params.new_w - left, top, dst - params.new_h - top),
        value=pad_value,
    )
    return x, params


@functools.lru_cache(maxsize=64)
def _letterbox_axis_matrix(src: int, new: int, dst: int, offset: int,
                           scale: float = 1.0) -> np.ndarray:
    """[dst, src] matrix of one letterbox axis: the [new, src] resize
    matrix placed at row ``offset``, zero rows in the padding band, times
    ``scale``. One product with it resizes and places the image."""
    m = np.zeros((dst, src), np.float32)
    m[offset:offset + new] = _resize_matrix(src, new)
    return m * scale


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/2, W/2, 4C]: 2x2 spatial blocks folded into
    channels, channel slot ``(2a + b) * C + c`` for row offset ``a`` and
    column offset ``b`` (the layout of the ``s2d`` stem and of
    ``models/carry.py`` ``s2d_fold_kernel``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _fused_letterbox_arrays(src_h: int, src_w: int, dst: int, pad_value: float) -> tuple:
    """The fused letterbox's constants for one (geometry, dst): the row
    and column letterbox matrices split by output parity ([2, dst/2,
    src], 1/255 in the row matrix) and the pad band's additive mask in
    the blocked layout ([dst/2, dst/2, 2, 2])."""
    params = letterbox_params((src_h, src_w), dst)
    top = int(round(params.pad_y))
    left = int(round(params.pad_x))
    half = dst // 2
    rh = _letterbox_axis_matrix(src_h, params.new_h, dst, top, 1.0 / 255.0)
    rw = _letterbox_axis_matrix(src_w, params.new_w, dst, left)
    inside_r = np.zeros((dst,), np.float32)
    inside_r[top:top + params.new_h] = 1.0
    inside_c = np.zeros((dst,), np.float32)
    inside_c[left:left + params.new_w] = 1.0
    outside = (1.0 - np.outer(inside_r, inside_c)) * pad_value
    outside = outside.reshape(half, 2, half, 2).transpose(0, 2, 1, 3)
    return (np.stack([rh[0::2], rh[1::2]]), np.stack([rw[0::2], rw[1::2]]),
            np.ascontiguousarray(outside))


def preprocess_letterbox_fused(
    frames_u8: torch.Tensor,
    dst: int = 640,
    pad_value: float = 114.0 / 255.0,
    out_dtype: torch.dtype = torch.bfloat16,
) -> tuple:
    """[N, H, W, 3] uint8 BGR -> ([N, dst/2, dst/2, 12] letterboxed RGB in
    [0, 1], folded into the ``space_to_depth`` layout the ``s2d`` stem
    reads, LetterboxParams).

    The two resize products take the parity-split letterbox matrices, so
    they write the [n, h, w, a, b, c] blocked layout directly; the source
    plane is read once (1/255 rides the row matrix); the pad value is an
    additive mask on the small plane; BGR -> RGB flips the 3-channel
    groups. The same linear map as ``space_to_depth(preprocess_letterbox
    (...))`` with other rounding points: equal to a tolerance, not bit for
    bit."""
    if dst % 2:
        raise ValueError(f"preprocess_letterbox_fused needs an even dst, got {dst}")
    params = letterbox_params(tuple(frames_u8.shape[1:3]), dst)
    rh2, rw2, outside = _constant(
        "fused", (int(frames_u8.shape[1]), int(frames_u8.shape[2]), dst, float(pad_value)),
        out_dtype, frames_u8.device)
    x = frames_u8.to(out_dtype)
    y = torch.einsum("ahH,nHWc->nahWc", rh2, x)
    y = torch.einsum("bwW,nahWc->nhwabc", rw2, y)
    y = (y + outside[None, :, :, :, :, None]).flip(-1)
    half = dst // 2
    return y.reshape(y.shape[0], half, half, 12), params


def unletterbox_boxes(boxes_xyxy: torch.Tensor, params: LetterboxParams) -> torch.Tensor:
    """Map detector-output xyxy boxes (letterboxed px) back to source px."""
    shift = _constant("shift", params, boxes_xyxy.dtype, boxes_xyxy.device)
    return (boxes_xyxy - shift) / params.scale


# BT.601 luma weights in the bus frame's BGR plane order.
_LUMA_BGR = (0.114, 0.587, 0.299)


def frame_quality_stats(
    frames_u8: torch.Tensor,
    prev_thumbs: torch.Tensor,
    thumb_hw: tuple,
) -> tuple:
    """[N, H, W, 3] uint8 BGR + previous [N, th, tw] f32 luma thumbnails ->
    (stats [N, 3] f32 of (luma_mean, luma_var, diff_energy), thumbs
    [N, th, tw] f32). The variance is the population variance."""
    w = _constant("luma", (), torch.float32, frames_u8.device)
    y = torch.matmul(frames_u8.to(torch.float32), w) * (1.0 / 255.0)
    thumbs = resize_bilinear(y[..., None], thumb_hw)[..., 0]
    mean = thumbs.mean(dim=(1, 2))
    var = thumbs.var(dim=(1, 2), correction=0)
    diff = (thumbs - prev_thumbs.to(torch.float32)).square().mean(dim=(1, 2))
    return torch.stack([mean, var, diff], dim=-1), thumbs
