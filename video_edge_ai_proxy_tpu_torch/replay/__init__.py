"""Record and replay of the port (counterpart of ``video_edge_ai_proxy_tpu/replay``).

``trace.py`` is the trace file format (the JAX package's, read and written
by both), ``recorder.py`` the taps and the synthetic traffic generator,
``player.py`` the deterministic frame iteration, ``checksum.py`` the
content-derived result checksum, and ``harness.py`` the lockstep replay
that folds it.
"""

from .checksum import (
    CHECKSUM_MASK, device_checksum, finalize_checksum, fold_checksum, golden_lookup,
    host_slot_checksum, zero_class_prior,
)
from .player import TracePlayer, meta_for
from .recorder import RecordingBus, TraceRecorder, record_synthetic_trace
from .trace import TRACE_MAGIC, TRACE_VERSION, TraceError, TraceWriter, read_trace

__all__ = [
    "CHECKSUM_MASK", "device_checksum", "finalize_checksum", "fold_checksum",
    "golden_lookup", "host_slot_checksum", "zero_class_prior", "TracePlayer", "meta_for",
    "RecordingBus", "TraceRecorder", "record_synthetic_trace", "TRACE_MAGIC",
    "TRACE_VERSION", "TraceError", "TraceWriter", "read_trace",
]
