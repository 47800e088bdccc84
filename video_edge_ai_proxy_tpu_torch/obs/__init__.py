"""Observability plane of the port: the metrics registry (``metrics``),
the output-quality verdicts (``quality``), the SLO burn-rate engine
(``slo``) and the programs' compile records (``perf``), counterparts of the JAX package's ``obs/`` modules of the same
names."""

from .metrics import Registry, registry

__all__ = ["Registry", "registry"]
