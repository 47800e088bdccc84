"""Ingest of the port: the video sources and ``open_source`` (the synthetic
pattern, recorded traces, and cameras or files through the libav shim or
OpenCV), the GOP archiver, the RTMP pass-through, and the per-camera
worker process (``worker``) that publishes frames onto the bus under the
lazy-decode gate."""

from .archive import GopSegment, PacketGopSegment, SegmentArchiver
from .sources import (OpenCVSource, PacketInfo, PacketSource, SyntheticSource, VideoSource,
                      open_source)
from .worker import IngestWorker, WorkerConfig

__all__ = ["GopSegment", "IngestWorker", "OpenCVSource", "PacketGopSegment", "PacketInfo",
           "PacketSource", "SegmentArchiver", "SyntheticSource", "VideoSource", "WorkerConfig",
           "open_source"]
