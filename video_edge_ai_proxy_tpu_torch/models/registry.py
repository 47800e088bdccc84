"""Model registry (counterpart of ``video_edge_ai_proxy_tpu/models/registry.py``).

One name -> everything the engine needs: the module, its input geometry,
which device-side preprocess it takes and what kind of result it gives.
Registered, with the JAX package's geometry: the detection family
(``yolov8n``, the default serving model, ``yolov8s``, the CPU/CI twin
``tiny_yolov8``, and the space-to-depth stem variants ``yolov8n_s2d`` and
``tiny_yolov8_s2d``), the convnet classifier ``mobilenet_v2`` and the
re-ID embedder ``resnet50`` (kind ``embed``) with their twins
``tiny_mobilenet_v2`` and ``tiny_resnet``, the transformer family
(``vit_b16``, ``videomae_b``, ``videomae_b_long`` and the twins
``tiny_vit``, ``tiny_videomae``), and the ROI path's measurement gauges
``blob_gauge`` and ``tiny_blob_gauge`` (``models/blob.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .blob import BlobGauge, BlobGaugeConfig
from .mobilenet_v2 import MobileNetV2, MobileNetV2Config, tiny_mobilenet_v2_config
from .resnet import ResNet, ResNetConfig, tiny_resnet_config
from .videomae import VideoMAE, VideoMAEConfig, tiny_videomae_config
from .vit import ViT, ViTConfig, tiny_vit_config
from .yolov8 import YOLOv8, tiny_yolov8_config, yolov8n_config, yolov8s_config


@dataclass(frozen=True)
class ModelSpec:
    name: str
    # (dtype[, param_dtype]) -> module on the CPU; param_dtype is taken by
    # the transformer family and the YOLOv8 detectors.
    build: Callable[..., nn.Module]
    input_size: int                             # square side the model consumes
    preprocess: str                             # "classify" | "letterbox" | "clip"
    kind: str                                   # "classify" | "detect" | "embed" | "video"
    clip_len: int = 0                           # >0 for video models
    description: str = ""

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: "str | torch.device" = "cuda",
                    dtype: torch.dtype = torch.bfloat16,
                    param_dtype: Optional[torch.dtype] = None) -> nn.Module:
        """The model with random weights from ``generator`` (a CPU
        generator; default seed 0), in eval mode, on ``device``, computing
        in ``dtype``. ``param_dtype`` (default: ``dtype``) is the dtype the
        transformer family keeps its Dense and patch/tubelet conv
        parameters in, and the YOLOv8 detectors their conv kernels: float32
        for bf16 training, as flax does."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if param_dtype is None:
            model = self.build(dtype)
        else:
            model = self.build(dtype, param_dtype)
        model.init_weights(generator)
        return place(model, dev, channels_last=getattr(model, "channels_last", False))


def place(model: nn.Module, device: torch.device, channels_last: bool = False) -> nn.Module:
    """Move ``model`` to ``device`` in eval mode. With ``channels_last`` (the
    conv nets) its conv weights on the card take channels_last memory, the
    layout cuDNN runs fastest."""
    model = model.to(device).eval()
    if channels_last and device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _convnet(cls, cfg, dtype: torch.dtype, param_dtype: Optional[torch.dtype]) -> nn.Module:
    """A model of one dtype: its training is not ported (the detectors'
    is)."""
    if param_dtype is not None:
        raise NotImplementedError("param_dtype: this model keeps one dtype "
                                  "(its training is not ported)")
    return cls(cfg, dtype)


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def names() -> list:
    return sorted(_REGISTRY)


def get(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


register(ModelSpec(
    "yolov8n", lambda dtype, param_dtype=None: YOLOv8(yolov8n_config(), dtype, param_dtype),
    input_size=640, preprocess="letterbox", kind="detect",
    description="batched detection, the default serving model",
))
register(ModelSpec(
    "yolov8n_s2d", lambda dtype, param_dtype=None: YOLOv8(
        dataclasses.replace(yolov8n_config(), stem="s2d"), dtype, param_dtype),
    input_size=640, preprocess="letterbox", kind="detect",
    description="yolov8n with the space-to-depth stem (a stride-1 2x2 stem on the "
                "folded 320x320x12 plane); classic weights fold in losslessly "
                "(models/carry.py s2d_fold_kernel)",
))
register(ModelSpec(
    "yolov8s", lambda dtype, param_dtype=None: YOLOv8(yolov8s_config(), dtype, param_dtype),
    input_size=640, preprocess="letterbox", kind="detect",
    description="small-variant detection",
))
register(ModelSpec(
    "mobilenet_v2", lambda dtype, param_dtype=None: _convnet(MobileNetV2, MobileNetV2Config(),
                                                             dtype, param_dtype),
    input_size=224, preprocess="classify", kind="classify",
    description="single-stream frame classification",
))
register(ModelSpec(
    "resnet50", lambda dtype, param_dtype=None: _convnet(ResNet, ResNetConfig(), dtype, param_dtype),
    input_size=224, preprocess="classify", kind="embed",
    description="16-stream re-ID feature extraction (2048-wide embeddings)",
))
register(ModelSpec(
    "vit_b16", lambda dtype, param_dtype=None: ViT(ViTConfig(), dtype, param_dtype=param_dtype),
    input_size=224, preprocess="classify", kind="classify",
    description="32-stream frame tagging",
))
register(ModelSpec(
    "videomae_b",
    lambda dtype, param_dtype=None: VideoMAE(VideoMAEConfig(), dtype, param_dtype=param_dtype),
    input_size=224, preprocess="clip", kind="video", clip_len=8,
    description="8-frame clip action recognition",
))
register(ModelSpec(
    "videomae_b_long",
    lambda dtype, param_dtype=None: VideoMAE(VideoMAEConfig(num_frames=64), dtype,
                                             param_dtype=param_dtype),
    input_size=224, preprocess="clip", kind="video", clip_len=64,
    description="long-context clips: 64 frames -> 6272 tokens, attention "
                "goes to the flash-attention kernel",
))
register(ModelSpec(
    "blob_gauge", lambda dtype, param_dtype=None: _convnet(BlobGauge, BlobGaugeConfig(), dtype,
                                                            param_dtype),
    input_size=640, preprocess="letterbox", kind="detect",
    description="detect-identity measurement gauge (models/blob.py): exact pixel "
                "bboxes of color-keyed synthetic blobs, served to check that "
                "pack -> detect -> scatter-back preserves geometry",
))
register(ModelSpec(
    "tiny_blob_gauge",
    lambda dtype, param_dtype=None: _convnet(BlobGauge, BlobGaugeConfig(), dtype, param_dtype),
    input_size=64, preprocess="letterbox", kind="detect",
    description="CPU/CI twin of blob_gauge",
))
register(ModelSpec(
    "tiny_yolov8", lambda dtype, param_dtype=None: YOLOv8(tiny_yolov8_config(), dtype, param_dtype),
    input_size=64, preprocess="letterbox", kind="detect",
    description="CPU/CI twin of yolov8n",
))
register(ModelSpec(
    "tiny_yolov8_s2d",
    lambda dtype, param_dtype=None: YOLOv8(
        dataclasses.replace(tiny_yolov8_config(), stem="s2d"), dtype, param_dtype),
    input_size=64, preprocess="letterbox", kind="detect",
    description="CPU/CI twin of yolov8n_s2d",
))
register(ModelSpec(
    "tiny_mobilenet_v2",
    lambda dtype, param_dtype=None: _convnet(MobileNetV2, tiny_mobilenet_v2_config(), dtype,
                                             param_dtype),
    input_size=32, preprocess="classify", kind="classify",
    description="CPU/CI twin of mobilenet_v2",
))
register(ModelSpec(
    "tiny_resnet",
    lambda dtype, param_dtype=None: _convnet(ResNet, tiny_resnet_config(), dtype, param_dtype),
    input_size=32, preprocess="classify", kind="embed",
    description="CPU/CI twin of resnet50",
))
register(ModelSpec(
    "tiny_vit",
    lambda dtype, param_dtype=None: ViT(tiny_vit_config(), dtype, param_dtype=param_dtype),
    input_size=32, preprocess="classify", kind="classify",
    description="CPU/CI twin of vit_b16",
))
register(ModelSpec(
    "tiny_videomae",
    lambda dtype, param_dtype=None: VideoMAE(tiny_videomae_config(), dtype,
                                             param_dtype=param_dtype),
    input_size=32, preprocess="clip", kind="video", clip_len=4,
    description="CPU/CI twin of videomae_b",
))
