"""Record and replay of the port (counterpart of ``video_edge_ai_proxy_tpu/replay``).

``trace.py`` is the trace file format (the JAX package's, read and written
by both), ``recorder.py`` the taps and the synthetic traffic generator,
``player.py`` the deterministic frame iteration and the ``replay://``
source, ``faults.py`` the scripted fault plans, ``checksum.py`` the
content-derived result checksum, and ``harness.py`` the lockstep replay,
the chaos soak, the end-to-end run and the fleet tier's soaks (fleet
telemetry, the router, the autoscaling supervisor).

An ingest worker imports this package for its ``replay://`` source, under
its ``RLIMIT_AS`` and away from the card: the names of ``checksum.py`` and
``harness.py``, which import torch, load on first use only.
"""

from .faults import KINDS, QUALITY_KINDS, RESILIENCE_KINDS, FaultEvent, FaultPlan
from .player import ReplaySource, TracePlayer, meta_for
from .recorder import RecordingBus, TraceRecorder, record_synthetic_trace
from .trace import TRACE_MAGIC, TRACE_VERSION, TraceError, TraceWriter, read_trace

_LAZY = {
    "checksum": ("CHECKSUM_MASK", "device_checksum", "finalize_checksum", "fold_checksum",
                 "golden_lookup", "host_slot_checksum", "zero_class_prior"),
    "harness": ("LoadShape", "lockstep_checksum", "run_autoscale_soak", "run_e2e",
                "run_fleet_obs", "run_fleet_soak", "run_router_soak"),
}


def __getattr__(name):
    for module, names in _LAZY.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(f".{module}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "KINDS", "QUALITY_KINDS", "RESILIENCE_KINDS", "FaultEvent", "FaultPlan", "ReplaySource",
    "TracePlayer", "meta_for", "RecordingBus", "TraceRecorder", "record_synthetic_trace",
    "TRACE_MAGIC", "TRACE_VERSION", "TraceError", "TraceWriter", "read_trace",
    *(n for names in _LAZY.values() for n in names),
]
