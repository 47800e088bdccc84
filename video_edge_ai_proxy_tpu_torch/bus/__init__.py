"""Frame bus of the port: the interface with its control-key contract, the
in-process backend and the native shared-memory backend (``open_bus``)."""

from ..utils.config import BusConfig
from .interface import (
    FIELD_LAST_QUERY,
    FIELD_PROXY_RTMP,
    FIELD_STORE,
    KEY_KEYFRAME_ONLY_PREFIX,
    KEY_LAST_ACCESS_PREFIX,
    Frame,
    FrameBus,
    FrameMeta,
    RingSlotTooSmall,
)
from .memory_bus import MemoryFrameBus


def open_bus(backend: str = BusConfig.backend, shm_dir: str = BusConfig.shm_dir,
             redis_addr: str = "127.0.0.1:6379", redis_password: str = "",
             redis_db: int = 0) -> FrameBus:
    """``shm`` (the native shared-memory rings, one host) or ``memory``
    (in-process). The reference's ``redis`` backend is not ported yet (it
    comes with the Redis annotation queue in a later slice), and asking for
    it raises rather than serving another backend."""
    if backend == "shm":
        from .shm_bus import ShmFrameBus

        return ShmFrameBus(shm_dir)
    if backend == "memory":
        return MemoryFrameBus()
    if backend == "redis":
        raise NotImplementedError(
            "bus backend 'redis' is not ported yet: it comes with the Redis annotation "
            "queue in a later slice; use 'shm' or 'memory'")
    raise ValueError(f"unknown bus backend {backend!r}")


__all__ = [
    "Frame",
    "FrameBus",
    "FrameMeta",
    "MemoryFrameBus",
    "open_bus",
    "KEY_LAST_ACCESS_PREFIX",
    "KEY_KEYFRAME_ONLY_PREFIX",
    "RingSlotTooSmall",
    "FIELD_LAST_QUERY",
    "FIELD_PROXY_RTMP",
    "FIELD_STORE",
]
