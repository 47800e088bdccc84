"""Device-side training augmentations (counterpart of ``video_edge_ai_proxy_tpu/ops/augment.py``):
static-shape, batched, on the tensors' device.

Images are NHWC float in [0, 1], as the JAX package's are (the trainer
permutes to the model's NCHW after augmenting); detection boxes ride along
as [B, N, 4] xyxy pixels with a [B, N] validity mask (padded slots), the
target format of ``models/detect_loss.py``. Every shape is static:
flips, crops of a static size at drawn offsets, masks from index compares,
arithmetic on box coordinates.

Randomness: ``jax.random`` and ``torch.Generator`` streams cannot match, so
each transform is two halves. ``*_params(generator, ...)`` draws its
parameters from an explicit CPU ``torch.Generator`` (small host tensors;
the crop offsets stay on the host, where slicing needs them), and
``apply_*`` applies given parameters, deterministically. The public
``random_hflip``/``color_jitter``/``cutout``/``mosaic4``/
``augment_detection_batch`` compose the two. The tests hold the apply
halves against JAX on the parameters JAX's own keys draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# -- horizontal flip ----------------------------------------------------------


def hflip_params(generator: torch.Generator, b: int) -> torch.Tensor:
    """[B] bool: which samples mirror (a fair coin each)."""
    return torch.rand(b, generator=generator) < 0.5


def apply_hflip(images: torch.Tensor, flip: torch.Tensor,
                boxes: Optional[torch.Tensor] = None):
    """Mirror the samples ``flip`` marks: images [B, H, W, C]; boxes
    [B, N, 4] xyxy px (optional, mirrored alike). -> (images, boxes)."""
    w = images.shape[2]
    flip = flip.to(images.device)
    out = torch.where(flip[:, None, None, None], images.flip(2), images)
    if boxes is None:
        return out, None
    x1, y1, x2, y2 = boxes.unbind(-1)
    fb = torch.stack([w - x2, y1, w - x1, y2], dim=-1)
    return out, torch.where(flip[:, None, None], fb, boxes)


def random_hflip(generator: torch.Generator, images: torch.Tensor,
                 boxes: Optional[torch.Tensor] = None):
    """Per-sample coin-flip horizontal mirror."""
    return apply_hflip(images, hflip_params(generator, images.shape[0]), boxes)


# -- photometric jitter -------------------------------------------------------


def jitter_params(generator: torch.Generator, b: int, brightness: float = 0.2,
                  contrast: float = 0.2, saturation: float = 0.4) -> Tuple[torch.Tensor, ...]:
    """Per-sample (brightness, contrast, saturation) gains [B, 1, 1, 1],
    each uniform in ``1 +- strength``."""
    def gains(s: float) -> torch.Tensor:
        return torch.rand((b, 1, 1, 1), generator=generator) * (2 * s) + (1.0 - s)
    return gains(brightness), gains(contrast), gains(saturation)


def apply_color_jitter(images: torch.Tensor, gains: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """YOLO-style photometric jitter with the given gains on float images in
    [0, 1]; the saturation's grey axis is the channel mean."""
    gb, gc, gs = (g.to(images.device) for g in gains)
    x = images.float() * gb
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * gc + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * gs + gray
    return x.clamp(0.0, 1.0).to(images.dtype)


def color_jitter(generator: torch.Generator, images: torch.Tensor, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.4) -> torch.Tensor:
    """Per-sample brightness/contrast/saturation jitter."""
    return apply_color_jitter(images, jitter_params(generator, images.shape[0], brightness,
                                                    contrast, saturation))


# -- cutout -------------------------------------------------------------------


def _cut_size(h: int, w: int, size_frac: float) -> Tuple[int, int]:
    return max(1, int(h * size_frac)), max(1, int(w * size_frac))


def cutout_params(generator: torch.Generator, b: int, h: int, w: int,
                  size_frac: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (y0, x0) [B] int64 of the erased square's corner."""
    ch, cw = _cut_size(h, w, size_frac)
    y0 = torch.randint(0, h - ch + 1, (b,), generator=generator)
    x0 = torch.randint(0, w - cw + 1, (b,), generator=generator)
    return y0, x0


def apply_cutout(images: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 size_frac: float = 0.25, fill: float = 0.5) -> torch.Tensor:
    """Fill one ``size_frac``-sized square a sample, at (y0, x0), with
    ``fill`` (index compares: no scatter, static shapes)."""
    _, h, w, _ = images.shape
    ch, cw = _cut_size(h, w, size_frac)
    dev = images.device
    y0, x0 = y0.to(dev), x0.to(dev)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + ch)[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < (x0 + cw)[:, None, None]))
    return torch.where(inside[..., None], images.new_tensor(fill), images)


def cutout(generator: torch.Generator, images: torch.Tensor, size_frac: float = 0.25,
           fill: float = 0.5) -> torch.Tensor:
    """Random erasing: one square a sample."""
    b, h, w, _ = images.shape
    y0, x0 = cutout_params(generator, b, h, w, size_frac)
    return apply_cutout(images, y0, x0, size_frac, fill)


# -- mosaic -------------------------------------------------------------------


def mosaic_params(generator: torch.Generator, b: int, h: int,
                  w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample crop origin (y0, x0) [B] int64 in the [2H, 2W] collage."""
    y0 = torch.randint(0, h + 1, (b,), generator=generator)
    x0 = torch.randint(0, w + 1, (b,), generator=generator)
    return y0, x0


def apply_mosaic4(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  y0: torch.Tensor, x0: torch.Tensor, labels: Optional[torch.Tensor] = None):
    """YOLO mosaic with given crop origins: sample i's output is the
    [H, W] window at (y0[i], x0[i]) of the 2x2 collage of samples i, i+1,
    i+2, i+3 (a batch roll: every sample is used 3 more times). Boxes
    [B, N, 4] are translated per quadrant, shifted by the crop, clipped,
    and re-validated by area (> 4 px^2; slivers are masked, not removed):
    N' = 4N slots, labels [B, N] ride along through the same roll. ->
    (images, boxes, valid[, labels])."""
    b, h, w, _ = images.shape
    rolls = range(4)
    quad_imgs = [torch.roll(images, -i, 0) for i in rolls]
    top = torch.cat([quad_imgs[0], quad_imgs[1]], dim=2)
    bot = torch.cat([quad_imgs[2], quad_imgs[3]], dim=2)
    collage = torch.cat([top, bot], dim=1)                           # [B, 2H, 2W, C]
    offsets = ((0, 0), (0, w), (h, 0), (h, w))                        # per quadrant (y, x)
    all_boxes = torch.cat([
        torch.roll(boxes, -i, 0) + boxes.new_tensor([ox, oy, ox, oy])
        for i, (oy, ox) in zip(rolls, offsets)], dim=1)              # [B, 4N, 4]
    all_valid = torch.cat([torch.roll(valid, -i, 0) for i in rolls], dim=1)
    ys, xs = y0.tolist(), x0.tolist()
    out = torch.stack([collage[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w] for i in range(b)])

    shift = torch.stack([x0, y0, x0, y0], dim=-1).to(boxes)
    bx = all_boxes - shift[:, None, :]
    zero = bx.new_tensor(0.0)
    bx = torch.stack([
        torch.minimum(torch.maximum(bx[..., 0], zero), bx.new_tensor(float(w))),
        torch.minimum(torch.maximum(bx[..., 1], zero), bx.new_tensor(float(h))),
        torch.minimum(torch.maximum(bx[..., 2], zero), bx.new_tensor(float(w))),
        torch.minimum(torch.maximum(bx[..., 3], zero), bx.new_tensor(float(h))),
    ], dim=-1)
    area = (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    ok = all_valid.bool() & (area > 4.0)
    if labels is not None:
        all_labels = torch.cat([torch.roll(labels, -i, 0) for i in rolls], dim=1)
        return out, bx, ok, all_labels
    return out, bx, ok


def mosaic4(generator: torch.Generator, images: torch.Tensor, boxes: torch.Tensor,
            valid: torch.Tensor, labels: Optional[torch.Tensor] = None):
    """YOLO mosaic at drawn crop origins (see ``apply_mosaic4``)."""
    b, h, w, _ = images.shape
    y0, x0 = mosaic_params(generator, b, h, w)
    return apply_mosaic4(images, boxes, valid, y0, x0, labels)


# -- the recipe ---------------------------------------------------------------


def augment_params(generator: torch.Generator, b: int, h: int, w: int,
                   use_mosaic: bool = True) -> Dict[str, tuple]:
    """Every draw of ``augment_detection_batch``, in one place: mosaic
    origins (when on), flips, jitter gains, cutout corners."""
    params = {}
    if use_mosaic:
        params["mosaic"] = mosaic_params(generator, b, h, w)
    params["hflip"] = (hflip_params(generator, b),)
    params["jitter"] = jitter_params(generator, b)
    params["cutout"] = cutout_params(generator, b, h, w)
    return params


def apply_augment(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  params: Dict[str, tuple], labels: Optional[torch.Tensor] = None):
    """The detection recipe with given parameters: mosaic (when
    ``params`` has it) -> hflip -> colour jitter -> cutout. -> (images,
    boxes, valid[, labels])."""
    if "mosaic" in params:
        res = apply_mosaic4(images, boxes, valid, *params["mosaic"], labels=labels)
        images, boxes, valid = res[:3]
        if labels is not None:
            labels = res[3]
    images, boxes = apply_hflip(images, params["hflip"][0], boxes)
    images = apply_color_jitter(images, params["jitter"])
    images = apply_cutout(images, *params["cutout"])
    if labels is not None:
        return images, boxes, valid, labels
    return images, boxes, valid


def augment_detection_batch(generator: torch.Generator, images: torch.Tensor,
                            boxes: torch.Tensor, valid: torch.Tensor,
                            labels: Optional[torch.Tensor] = None, *, use_mosaic: bool = True):
    """The standard detection-training recipe: mosaic -> hflip -> colour
    jitter -> cutout, on the tensors' device. images NHWC float [0, 1].
    Returns (images, boxes, valid), with labels appended when given (they
    must go through here when mosaic is on: the box slots quadruple through
    a batch roll)."""
    b, h, w, _ = images.shape
    return apply_augment(images, boxes, valid,
                         augment_params(generator, b, h, w, use_mosaic), labels)
