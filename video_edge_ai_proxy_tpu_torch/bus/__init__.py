"""Frame bus of the port: the interface with its control-key contract, the
in-process backend, the native shared-memory backend and the
Redis-wire-compatible backend (``open_bus``)."""

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
    """``shm`` (the native shared-memory rings, one host), ``redis`` (the
    reference's Redis wire: interop with reference workers and clients on
    one Redis) or ``memory`` (in-process)."""
    if backend == "shm":
        from .shm_bus import ShmFrameBus

        return ShmFrameBus(shm_dir)
    if backend == "redis":
        from .redis_bus import RedisFrameBus

        return RedisFrameBus(redis_addr, password=redis_password, db=redis_db)
    if backend == "memory":
        return MemoryFrameBus()
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
