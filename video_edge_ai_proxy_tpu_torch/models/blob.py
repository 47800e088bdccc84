"""Detect-identity "blob gauge" (counterpart of ``video_edge_ai_proxy_tpu/models/blob.py``).

Not a learned model: a measurement instrument that returns the exact
pixel bounding box of color-keyed blobs, so the ROI path (pack -> detect
-> scatter-back) is checked with array equality, not an IoU tolerance: a
coordinate bug in a crop's placement or its inverse shows up as an exact
mismatch, with no model noise in the loop.

Scene contract: frames are background gray (114, the letterbox pad value)
with axis-aligned blobs painted in one of ``BINS`` color keys, BGR ``(64,
255, key * BIN_WIDTH + BIN_WIDTH // 2)``. Anchor ``k`` of the output is the
bounding box of every pixel whose red channel lies within ``_BIN_TOL``
levels of bin ``k``'s center and whose green channel is bright (gray
padding fails the green test, so the gray bin never fires on it). The bin
centers are 32 levels apart and the window is +-12 levels: bf16
preprocessing moves a level by less than 1, so it never flips a bin.

The registry's detect contract, as ``build_serving_step`` calls it:
``model(x, decode="serving")`` on the letterboxed [N, 3, S, S] RGB plane ->
``(boxes [N, BINS, 4] xyxy letterbox px, max_logit [N, BINS], cls_ids
[N, BINS] int32)``, class id = color bin, so ``batched_nms`` and the
keep-mask kernel run on it like on a detector's. Computed in float32
whatever the input dtype. One dummy ``bias`` parameter (zero, unused but
for ``+ 0 * bias``) carries over from flax (``models/carry.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

# 8 red-channel bins of 32 u8 levels each; bin 3 holds the 114-gray
# background and is excluded by the green test, not by index.
BINS = 8
BIN_WIDTH = 32
_BIN_TOL = 12.0      # acceptance half-window around a bin center, u8 levels
_LOGIT_HIT = 8.0     # sigmoid(8) ~ 0.99966: far above the NMS floor
_LOGIT_MISS = -8.0


def blob_color(key: int) -> tuple:
    """BGR fill color of color bin ``key``: the gauge's anchor ``key``
    reports the bounding box of blobs painted with it."""
    return (64, 255, key * BIN_WIDTH + BIN_WIDTH // 2)


@dataclass(frozen=True)
class BlobGaugeConfig:
    num_classes: int = BINS


class BlobGauge(nn.Module):
    """See the module docstring. ``dtype`` is accepted for the registry's
    build signature; the gauge computes in float32."""

    def __init__(self, cfg: BlobGaugeConfig = BlobGaugeConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.bias = nn.Parameter(torch.zeros(1))

    def init_weights(self, generator: torch.Generator) -> None:
        """The dummy bias starts at zero, as flax's ``zeros`` init."""
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, decode=True):
        bins = self.cfg.num_classes
        x = x.to(torch.float32) + self.bias[0] * 0.0
        n, _, h, w = x.shape
        # The letterbox flips BGR -> RGB: channel 0 is the red key.
        red = x[:, 0] * 255.0
        green = x[:, 1]
        centers = (torch.arange(bins, dtype=torch.float32, device=x.device) * BIN_WIDTH
                   + BIN_WIDTH / 2.0)
        mask = ((red[..., None] - centers).abs() < _BIN_TOL) & (green[..., None] > 0.75)
        cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, :, None]
        rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
        any_col = mask.any(dim=1)                    # [N, W, BINS]
        any_row = mask.any(dim=2)                    # [N, H, BINS]
        big = 1e9
        x0 = torch.where(any_col, cols, big).amin(dim=1)
        x1 = torch.where(any_col, cols + 1.0, -big).amax(dim=1)
        y0 = torch.where(any_row, rows, big).amin(dim=1)
        y1 = torch.where(any_row, rows + 1.0, -big).amax(dim=1)
        present = any_col.any(dim=1)                 # [N, BINS]
        boxes = torch.stack([x0, y0, x1, y1], dim=-1)
        boxes = torch.where(present[..., None], boxes, 0.0)
        logits = torch.where(present, _LOGIT_HIT, _LOGIT_MISS)
        cls_ids = torch.arange(bins, dtype=torch.int32, device=x.device)[None, :].expand(n, bins)
        if decode == "serving":
            return boxes, logits, cls_ids
        # decode=True: (boxes, per-anchor class probabilities).
        probs = torch.sigmoid(logits)[..., None] * nn.functional.one_hot(
            cls_ids.long(), bins).to(torch.float32)
        return boxes, probs
