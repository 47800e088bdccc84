"""Compile-time attribution of the serving programs (counterpart of the
``note_compile`` part of ``video_edge_ai_proxy_tpu/obs/perf.py``
``PerfTracker``).

On the card a program is a CUDA graph of the serving step, and its
"compile" is the capture: ``note_compile`` records the capture's wall
time per (model, geometry, bucket) into ``vep_compile_seconds`` and
``vep_compile_programs_total``, under the JAX names and labels. The JAX
tracker's FLOPs per program (``vep_compile_program_gflop``) and its MFU
gauges read XLA's cost analysis, which has no counterpart here; they are
not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import metrics


class PerfTracker:
    """Per-engine compile records feeding the metrics registry."""

    def __init__(self, *, registry: Optional[metrics.Registry] = None):
        reg = registry if registry is not None else metrics.registry
        self._lock = threading.Lock()
        # (model, geometry, bucket) -> compile record
        self._compiles: Dict[Tuple[str, str, int], dict] = {}
        self._m_compile_s = reg.histogram(
            "vep_compile_seconds",
            "Program build (CUDA graph capture) wall time per step-cache miss",
            ("model", "geometry", "bucket"))
        self._m_compile_programs = reg.counter(
            "vep_compile_programs_total",
            "Built serving programs per (model, geometry, bucket)",
            ("model", "geometry", "bucket"))

    @staticmethod
    def _geometry(src_hw: Tuple[int, int]) -> str:
        return f"{src_hw[0]}x{src_hw[1]}"

    def note_compile(self, model: str, src_hw: Tuple[int, int], bucket: int,
                     seconds: float) -> None:
        """Record one step-cache-miss program build of ``seconds``."""
        geometry = self._geometry(src_hw)
        key = (model, geometry, bucket)
        with self._lock:
            rec = self._compiles.get(key)
            if rec is None:
                rec = {"model": model, "geometry": geometry, "bucket": bucket,
                       "programs": 0, "compile_s": 0.0}
                self._compiles[key] = rec
            rec["programs"] += 1
            rec["compile_s"] += float(seconds)
        b = str(bucket)
        self._m_compile_s.labels(model, geometry, b).observe(float(seconds))
        self._m_compile_programs.labels(model, geometry, b).inc()

    def compiles(self) -> List[dict]:
        """Copies of the compile records, one per (model, geometry, bucket)."""
        with self._lock:
            return [dict(rec) for rec in self._compiles.values()]
