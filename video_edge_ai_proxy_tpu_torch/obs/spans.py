"""Frame lineage ids (counterpart of ``video_edge_ai_proxy_tpu/obs/spans.py``,
its ``trace_id_for`` only).

An ingest worker stamps every frame it publishes with a deterministic trace
id, carried by the bus in ``FrameMeta.trace_id``; the port's worker stamps
the same ids as the JAX package's, so both publish equal metadata. The
stage tracer that records spans against these ids is a later slice.
"""

from __future__ import annotations

# FNV-1a 64-bit, masked to 63 bits so that the id fits every carrier (the
# C int64 of the shm FrameMeta, protobuf int64, JSON) without a sign.
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_TRACE_MASK = 0x7FFF_FFFF_FFFF_FFFF


def trace_id_for(stream: str, frame_id: int) -> int:
    """Deterministic per-frame trace id: FNV-1a over ``stream:frame``.
    Content-derived, so a replayed trace gets the same ids run over run.
    Never 0 (0 means "unstamped")."""
    h = _FNV_OFFSET
    for b in f"{stream}:{int(frame_id)}".encode():
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return (h & _TRACE_MASK) or 1
