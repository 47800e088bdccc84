"""Engine configuration: the subset of ``video_edge_ai_proxy_tpu/utils/config.py``
``EngineConfig`` that the port's serving loop reads, with the same defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EngineConfig:
    model: str = "yolov8n"
    # Bucketed batch sizes: the serving step sees a small closed set of
    # batch shapes as streams come and go.
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32, 64)
    # Collector tick: stack whatever arrived, pad to bucket, go.
    tick_ms: int = 10
    dtype: str = "bfloat16"
    # Luma thumbnail side of the per-frame quality statistics (device
    # state carried per stream across ticks); 0 = off.
    quality_thumb: int = 32
