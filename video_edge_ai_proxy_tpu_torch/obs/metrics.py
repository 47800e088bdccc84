"""Process-wide metrics registry: counters, gauges, log2 histograms.

Counterpart of ``video_edge_ai_proxy_tpu/obs/metrics.py``, the subset the
port's modules record into: families of counters, gauges and fixed log2
histograms (2^-4 ms .. 2^14 ms plus overflow; percentiles derived from
the bucket counts, no samples stored). One lock acquire and an add per
observation; hot paths hold a child handle so no observation looks a name
up. ``render`` writes the Prometheus text exposition (0.0.4) and
``snapshot`` a JSON view, for the server's ``/metrics`` and
``/api/v1/stats``; the exposition linter and the constant labels of the
fleet tier are not ported.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LOG2_LO = -4
LOG2_HI = 14
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    float(2.0 ** k) for k in range(LOG2_LO, LOG2_HI + 1)
)
N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow (+Inf)


def bucket_index(value: float) -> int:
    """Index of the smallest bucket with ``value <= le``; <= 0 maps to
    bucket 0 (a 0.0 ms latency is a legitimate observation)."""
    if value <= BUCKET_BOUNDS[0]:
        return 0
    if value > BUCKET_BOUNDS[-1]:
        return N_BUCKETS - 1
    m, e = math.frexp(value)      # value = m * 2**e, 0.5 <= m < 1
    k = e if m > 0.5 else e - 1   # smallest k with value <= 2**k
    return k - LOG2_LO


class Counter:
    """Monotonic float counter."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        """Scrape-time mirror of a total another object counts (the
        annotation queue's acks); hot paths call inc()."""
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed log2-bucket histogram; percentiles derived, samples never
    stored."""

    __slots__ = ("_lock", "_counts", "_sum", "_count")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * N_BUCKETS
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bucket_index(value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> Optional[float]:
        """Approximate quantile (0 < p <= 100) by linear interpolation
        inside the bucket holding the rank; None when empty."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return None
        rank = p / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(BUCKET_BOUNDS):
                    return BUCKET_BOUNDS[-1]
                hi = BUCKET_BOUNDS[i]
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                return lo + (hi - lo) * (rank - lo_cum) / c
        return BUCKET_BOUNDS[-1]

    def snapshot(self) -> dict:
        with self._lock:
            total = self._count
            s = self._sum
        out = {"count": total, "sum": round(s, 3),
               "avg": round(s / total, 3) if total else None}
        for p in (50, 90, 99):
            q = self.percentile(p)
            out[f"p{p}"] = round(q, 3) if q is not None else None
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: kind, help, label names and children."""

    def __init__(self, name: str, kind: str, help_text: str,
                 labelnames: Tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values: str):
        """Child for one label-value combination (created on first use);
        no label names -> the singleton child."""
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, "
                             f"got {values!r}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = _KINDS[self.kind]()
                self._children[values] = child
            return child

    def set(self, v: float) -> None:
        """An unlabelled family's value: ``registry.gauge("x").set(v)``."""
        self.labels().set(v)

    def clear(self) -> None:
        """Drop every child: a family repopulated at each scrape (per
        worker), where a removed camera must stop exporting."""
        with self._lock:
            self._children.clear()

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    """Named families; one per process by default (``registry``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _family(self, name: str, kind: str, help_text: str,
                labelnames: Iterable[str]) -> Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help_text, labelnames)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != labelnames:
                raise ValueError(f"metric {name!r} re-registered as {kind}{labelnames} "
                                 f"(was {fam.kind}{fam.labelnames})")
            return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Iterable[str] = ()) -> Family:
        return self._family(name, "counter", help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Iterable[str] = ()) -> Family:
        return self._family(name, "gauge", help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Iterable[str] = ()) -> Family:
        return self._family(name, "histogram", help_text, labelnames)


    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    @staticmethod
    def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
        def esc(v: str) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        pairs = [f'{n}="{esc(v)}"' for n, v in zip(names, values)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def render(self) -> str:
        """Prometheus text exposition 0.0.4: HELP and TYPE per family,
        histograms as cumulative _bucket/_sum/_count."""
        lines: List[str] = []
        for fam in self.families():
            children = fam.children()
            if not children:
                continue
            help_text = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {fam.name} {help_text}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in children:
                if fam.kind != "histogram":
                    lines.append(f"{fam.name}{self._labelstr(fam.labelnames, values)} "
                                 f"{child.value:g}")
                    continue
                with child._lock:
                    counts = list(child._counts)
                    total = child._count
                    s = child._sum
                cum = 0
                for i, bound in enumerate(BUCKET_BOUNDS):
                    cum += counts[i]
                    ls = self._labelstr(fam.labelnames, values, f'le="{bound:g}"')
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                ls = self._labelstr(fam.labelnames, values, 'le="+Inf"')
                lines.append(f"{fam.name}_bucket{ls} {total}")
                ls = self._labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}_sum{ls} {s:g}")
                lines.append(f"{fam.name}_count{ls} {total}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON view of every family with a child."""
        out: dict = {}
        for fam in self.families():
            samples = []
            for values, child in fam.children():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    samples.append({"labels": labels, **child.snapshot()})
                else:
                    samples.append({"labels": labels, "value": child.value})
            if samples:
                out[fam.name] = {"kind": fam.kind, "samples": samples}
        return out


# The process-wide registry the port's modules record into.
registry = Registry()
