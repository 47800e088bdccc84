"""Content-derived result checksum (counterpart of
``video_edge_ai_proxy_tpu/replay/checksum.py``).

An integer hash of the serving step's numbers, the same as the JAX
package's bit for bit on the same outputs:

    detect:   sum over valid detections of
                  1*x1 + 3*y1 + 5*x2 + 7*y2          (boxes rounded to px)
                + 11*class_id + 13*round(score*1000)
    embed:    sum of round(embedding * 100)
    classify: sum of top_ids + round(top_probs * 1000)

accumulated with int32 wraparound (two's complement) and masked to mod
2^31 when folded, so it fits every JSON consumer. Rounding is half to even
in float32, as ``jnp.round``. Identical frames and weights reproduce it
exactly; a one-element weight perturbation moves it.

Goldens live in the port's own ``replay/goldens.json`` keyed
``<tool>:<program>:<backend>``; a missing key is record-only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

CHECKSUM_MASK = 0x7FFFFFFF  # mod 2^31
GOLDENS_PATH = os.path.join(os.path.dirname(__file__), "goldens.json")

_BOX_W = (1, 3, 5, 7)
_CLS_W = 11
_SCORE_W = 13


def _round_i64(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    x = x.to(torch.float32)
    if scale != 1.0:
        x = x * scale
    return torch.round(x).to(torch.int64)


def _wrap_int32(total: torch.Tensor) -> torch.Tensor:
    """An int64 sum -> the int32 an int32 accumulator would hold."""
    s = torch.remainder(total, 2 ** 32)
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def device_checksum(out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Serving-step output dict -> 0-d int32 tensor on the outputs' device
    (detect ``{boxes, scores, classes, valid}``, embed ``{embedding}``,
    classify/video ``{top_probs, top_ids}``)."""
    if "boxes" in out:
        v = out["valid"].to(torch.int64)
        w = torch.tensor(_BOX_W, dtype=torch.int64, device=v.device)
        s = (_round_i64(out["boxes"]) * w * v[..., None]).sum()
        s = s + ((_CLS_W * out["classes"].to(torch.int64)
                  + _SCORE_W * _round_i64(out["scores"], 1000.0)) * v).sum()
        return _wrap_int32(s)
    if "embedding" in out:
        return _wrap_int32(_round_i64(out["embedding"], 100.0).sum())
    return _wrap_int32(out["top_ids"].to(torch.int64).sum()
                       + _round_i64(out["top_probs"], 1000.0).sum())


def fold_checksum(carry, out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Accumulator step: carry (int or 0-d tensor) -> new masked carry, a
    0-d int64 tensor in [0, 2^31)."""
    return (device_checksum(out).to(torch.int64) + carry) & CHECKSUM_MASK


def finalize_checksum(total) -> int:
    """Device or host accumulator -> committed int in [0, 2^31)."""
    return int(total) & CHECKSUM_MASK


def host_slot_checksum(host: Mapping[str, np.ndarray], i: int) -> int:
    """One batch slot of an already-fetched detect output -> masked int:
    the host (numpy) twin of the detect branch of ``device_checksum``,
    accumulated in Python ints."""
    valid = np.asarray(host["valid"][i]).astype(bool)
    boxes = np.round(np.asarray(host["boxes"][i], np.float64)[valid]).astype(np.int64)
    cls = np.asarray(host["classes"][i], np.int64)[valid]
    scores = np.round(np.asarray(host["scores"][i], np.float64)[valid] * 1000.0).astype(np.int64)
    s = int((boxes * np.asarray(_BOX_W, np.int64)).sum()
            + (_CLS_W * cls + _SCORE_W * scores).sum())
    return s & CHECKSUM_MASK


def zero_class_prior(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero the detection head's class-prior biases of a ``state_dict``.

    The from-scratch prior (``cls{i}_out`` bias ~= -11.5) puts every
    random-init score near 1e-5, below the NMS score threshold, so a
    random-weight run would feed NMS empty candidate sets and its checksum
    would be 0. With these biases at zero the scores sit near sigmoid(0) =
    0.5 and NMS does real work. Nothing else changes."""
    def is_cls_out(name: str) -> bool:
        return any(p.startswith("cls") and p.endswith("_out") for p in name.split("."))

    return {
        name: torch.zeros_like(t) if is_cls_out(name) and t.ndim == 1 else t
        for name, t in state_dict.items()
    }


def load_goldens(path: Optional[str] = None) -> dict:
    try:
        with open(path or GOLDENS_PATH, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def golden_lookup(key: str, path: Optional[str] = None) -> Optional[int]:
    """Committed golden for ``key`` (e.g. "lockstep:yolov8n:cuda"), or
    None when none is committed yet: the caller records its value."""
    val = load_goldens(path).get(key)
    return int(val) if isinstance(val, int) else None


def check_golden(key: str, value: int, *, tool: str,
                 path: Optional[str] = None) -> Optional[int]:
    """Compare ``value`` against the committed golden; returns the golden
    (None = not committed). Raises on drift: a pinned program whose
    numbers moved is a correctness bug, not noise."""
    golden = golden_lookup(key, path)
    if golden is not None and golden != value:
        raise RuntimeError(f"{tool} checksum drift: {key} produced {value}, golden is "
                           f"{golden} (replay/goldens.json)")
    return golden
