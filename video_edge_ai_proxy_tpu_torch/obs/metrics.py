"""Process-wide metrics registry: counters, gauges, log2 histograms.

Counterpart of ``video_edge_ai_proxy_tpu/obs/metrics.py``, the subset the
port's modules record into: families of counters, gauges and fixed log2
histograms (2^-4 ms .. 2^14 ms plus overflow; percentiles derived from
the bucket counts, no samples stored). One lock acquire and an add per
observation; hot paths hold a child handle so no observation looks a name
up. ``render`` writes the Prometheus text exposition (0.0.4) and
``snapshot`` a JSON view, for the server's ``/metrics`` and
``/api/v1/stats``; ``set_const_labels`` adds labels to every sample at
render time (a member's ``instance``), and ``lint_exposition`` checks a
rendered page.
"""

from __future__ import annotations

import math
import re
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
        # Constant labels applied to every sample at render time, not
        # stored per child: observation cost is unchanged.
        self._const: Tuple[Tuple[str, str], ...] = ()

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

    def set_const_labels(self, **labels: str) -> None:
        """Set the render-time constant label set (replacing any previous
        one). A family that carries one of these names keeps its own."""
        self._const = tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    @property
    def const_labels(self) -> Dict[str, str]:
        return dict(self._const)

    def _labelstr(self, names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
        def esc(v: str) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        pairs = [f'{n}="{esc(v)}"' for n, v in self._const if n not in names]
        pairs += [f'{n}="{esc(v)}"' for n, v in zip(names, values)]
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


def lint_exposition(text: str) -> List[str]:
    """Validate Prometheus text-format 0.0.4 structure. Returns a list of
    problems (empty = clean). Checks: every sample belongs to an announced
    family, HELP/TYPE precede samples, families are contiguous (no family
    re-opened later), no duplicate (name, labels) samples, label values
    quoted with only valid escapes."""
    problems: List[str] = []
    seen_families: List[str] = []
    closed: set = set()
    current: Optional[str] = None
    current_kind = ""
    seen_samples: set = set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {ln}: malformed comment {line!r}")
                continue
            name = parts[2]
            if name != current:
                if name in closed:
                    problems.append(
                        f"line {ln}: family {name} re-opened (samples must "
                        "be contiguous per family)")
                if current is not None:
                    closed.add(current)
                current = name
                seen_families.append(name)
            if line.startswith("# TYPE "):
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    problems.append(f"line {ln}: bad TYPE {line!r}")
                else:
                    current_kind = parts[3]
            continue
        if line.startswith("#"):
            continue
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            close = line.rfind("}")
            if close < 0:
                problems.append(f"line {ln}: unterminated label set")
                continue
            labels = line[brace + 1:close]
            rest = line[close + 1:].strip()
            # name="value" tokens with escaped quotes
            token = re.compile(
                r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(,|$)')
            pos = 0
            while pos < len(labels):
                m = token.match(labels, pos)
                if m is None:
                    problems.append(
                        f"line {ln}: bad label syntax near {labels[pos:]!r}")
                    break
                pos = m.end()
        else:
            name, _, rest = line.partition(" ")
            labels = ""
            rest = rest.strip()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if current_kind in ("histogram", "summary") and \
                    name.endswith(suffix) and \
                    name[: -len(suffix)] == current:
                base = name[: -len(suffix)]
                break
        if base != current:
            problems.append(
                f"line {ln}: sample {name} outside its family block "
                f"(current family: {current})")
        try:
            float(rest.split()[0])
        except (ValueError, IndexError):
            problems.append(f"line {ln}: non-numeric value {rest!r}")
        key = (name, labels)
        if key in seen_samples:
            problems.append(f"line {ln}: duplicate sample {name}{{{labels}}}")
        seen_samples.add(key)
    return problems
