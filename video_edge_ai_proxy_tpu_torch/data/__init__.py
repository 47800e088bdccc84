"""Training data pipeline (counterpart of ``video_edge_ai_proxy_tpu/data/``):
archived edge footage -> training batches."""

from .segments import (
    Loader, SampleMeta, SegmentDataset, SegmentRef, read_segment, scan_archive,
)

__all__ = ["Loader", "SampleMeta", "SegmentDataset", "SegmentRef",
           "read_segment", "scan_archive"]
