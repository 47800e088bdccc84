"""Ingest of the port: the video-source types, the synthetic pattern source
and ``open_source``, and the per-camera worker process (``worker``) that
publishes frames onto the bus under the lazy-decode gate."""

from .sources import PacketInfo, SyntheticSource, VideoSource, open_source
from .worker import IngestWorker, WorkerConfig

__all__ = ["IngestWorker", "PacketInfo", "SyntheticSource", "VideoSource", "WorkerConfig",
           "open_source"]
