"""Observability plane of the port, counterparts of the JAX package's
``obs/`` modules of the same names: the metrics registry and exposition
linter (``metrics``), the output-quality verdicts and the canary checker
(``quality``), the SLO burn-rate engine (``slo``), the programs' compile
records (``perf``), the frame lineage tracer and its trace ids (``spans``),
the once-per-episode watchdog (``watch``), the decision journal with its
``why`` chains (``journal``) and the triggered torch.profiler captures
(``prof``)."""

from .journal import DecisionJournal, format_event
from .metrics import Registry, lint_exposition, registry
from .prof import Profiler
from .spans import SpanRecorder, stage_breakdown, to_chrome_trace, trace_id_for, tracer
from .watch import Watchdog

__all__ = ["DecisionJournal", "Profiler", "Registry", "SpanRecorder", "Watchdog",
           "format_event", "lint_exposition", "registry", "stage_breakdown",
           "to_chrome_trace", "trace_id_for", "tracer"]
