"""Observability plane of the port: the metrics registry (``metrics``),
the output-quality verdicts (``quality``), the SLO burn-rate engine
(``slo``), the programs' compile records (``perf``) and the frame lineage
ids (``spans``), counterparts of the JAX package's ``obs/`` modules of the
same names."""

from .metrics import Registry, registry
from .spans import trace_id_for

__all__ = ["Registry", "registry", "trace_id_for"]
