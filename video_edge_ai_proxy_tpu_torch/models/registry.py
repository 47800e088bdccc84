"""Model registry (counterpart of ``video_edge_ai_proxy_tpu/models/registry.py``).

This slice registers the detection family the serving path runs:
``yolov8n`` (the default model) and its CPU/CI twin ``tiny_yolov8``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .yolov8 import YOLOv8, tiny_yolov8_config, yolov8n_config


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[[torch.dtype], nn.Module]   # dtype -> module on the CPU
    input_size: int                             # square side the model consumes
    kind: str                                   # "detect"
    description: str = ""

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: "str | torch.device" = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> nn.Module:
        """The model with random weights from ``generator`` (a CPU
        generator; default seed 0), in eval mode, on ``device``."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        model = self.build(dtype)
        model.init_weights(generator)
        return place(model, dev)


def place(model: nn.Module, device: torch.device) -> nn.Module:
    """Move ``model`` to ``device`` in eval mode; on the card its conv
    weights take channels_last memory, the layout cuDNN runs fastest."""
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


register(ModelSpec(
    "yolov8n", lambda dtype: YOLOv8(yolov8n_config(), dtype),
    input_size=640, kind="detect",
    description="batched detection, the default serving model",
))
register(ModelSpec(
    "tiny_yolov8", lambda dtype: YOLOv8(tiny_yolov8_config(), dtype),
    input_size=64, kind="detect",
    description="CPU/CI twin of yolov8n",
))
