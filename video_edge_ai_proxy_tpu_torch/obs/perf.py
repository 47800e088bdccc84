"""Live device-performance attribution (counterpart of
``video_edge_ai_proxy_tpu/obs/perf.py``): what each program costs, how
long the device spends per batch, how many batch slots carry padding, the
live MFU against the card's peak, the host-to-device copies and the
aggregate frames/s.

Per (model, geometry, bucket) program: ``note_compile`` records the
program's build (on the card the CUDA graph capture) with its FLOPs,
``note_batch`` each drained batch's device time and occupancy,
``note_h2d`` each placement's bytes and copy time. The families and
labels are the JAX package's (``vep_compile_*``, ``vep_perf_*``,
``vep_h2d_*``); ``snapshot`` is the JAX snapshot's shape. The ROI path's
notes (``note_roi_*``, ``vep_roi_*``; a canvas batch's ``note_batch``
counts the streams it served and its crop-pixel occupancy) and the
cascade's (``note_cascade_*``, ``vep_cascade_*``) add the snapshot's
``roi`` and ``cascade`` sections once their planes serve. The mesh-shard
notes come with the multi-card slice.

Where the numbers come from on the card:

- FLOPs: ``count_flops`` runs the eager step once under
  ``torch.utils.flop_counter.FlopCounterMode`` when a key is built: the
  convolutions (every tap, 2·N·Co·Ho·Wo·Ci·kh·kw, those over the zero
  padding included), the matrix products (``mm``, ``bmm``: the
  letterbox's resize products) and ``aten._int_mm`` (2·m·k·n, registered
  here); not matrix-vector products nor elementwise work. XLA's cost
  analysis, which the JAX tracker reads, counts only a conv's taps inside
  its input and adds elementwise work: on the small tiny_yolov8 planes the
  port's count is 2-20% above XLA's.
- Device time: the step's own span on the compute stream between CUDA
  events. The JAX tracker's is submit -> drained and includes the drain
  queue's wait; the port's does not.
- The peak: ``resolve_peak_tflops`` maps the card's name to its dense
  bf16 tensor-core peak; an unknown card raises. On the CPU there is no
  peak and no MFU (``mfu_pct`` is None), as in JAX without cost analysis.

``note_batch`` and ``note_h2d`` run once per batch on the drain and tick
threads: after a key's first batch they only look up pre-resolved metric
children and do float arithmetic.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from . import metrics

# Dense bf16 tensor-core peak (TFLOP/s) by ``torch.cuda.get_device_name``:
# NVIDIA's data sheet for the H100 SXM part, at its full 700 W limit.
PEAK_TFLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4,
}


def resolve_peak_tflops(configured: float, device) -> float:
    """The peak the MFU gauges divide by: ``configured`` when set (> 0),
    else the table's entry for the card ``device`` is; 0.0 on the CPU (no
    MFU). Raises for a card the table does not know."""
    if configured > 0.0:
        return float(configured)
    if getattr(device, "type", str(device)) != "cuda":
        return 0.0
    import torch

    name = torch.cuda.get_device_name(device)
    if name not in PEAK_TFLOPS_BF16:
        raise ValueError(f"no bf16 peak known for {name!r}; set engine.peak_tflops "
                         f"(known: {sorted(PEAK_TFLOPS_BF16)})")
    return PEAK_TFLOPS_BF16[name]


_FLOP_REGISTRY_LOCK = threading.Lock()


def _register_int_mm_flops() -> None:
    """FlopCounterMode has no formula for ``aten._int_mm`` (int8 x int8 ->
    int32, the int8 activation path's product): register 2·m·k·n once."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    import torch

    with _FLOP_REGISTRY_LOCK:
        if torch.ops.aten._int_mm in flop_registry:
            return

        @register_flop_formula(torch.ops.aten._int_mm)
        def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
            m, k = a_shape
            return 2 * m * k * b_shape[1]


def count_flops(fn, *args):
    """-> (``fn(*args)``, the FLOPs FlopCounterMode counted in the call)."""
    from torch.utils.flop_counter import FlopCounterMode

    _register_int_mm_flops()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, float(counter.get_total_flops())


def mfu_pct(flops: float, device_ms: float, peak_tflops: float) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over peak, percent. None
    when any input is unknown or degenerate."""
    if flops <= 0.0 or device_ms <= 0.0 or peak_tflops <= 0.0:
        return None
    achieved = flops / (device_ms * 1e-3)
    return 100.0 * achieved / (peak_tflops * 1e12)


class _RateWindow:
    """Sliding-window event rate over a bounded deque of (t, n) samples,
    one sample per batch; expired entries pop on every add."""

    __slots__ = ("_window_s", "_samples", "_total")

    def __init__(self, window_s: float = 10.0, maxlen: int = 4096):
        self._window_s = float(window_s)
        self._samples: Deque[Tuple[float, float]] = collections.deque(maxlen=maxlen)
        self._total = 0.0

    def add(self, n: float, now: float) -> None:
        if len(self._samples) == self._samples.maxlen:
            self._total -= self._samples[0][1]   # about to be evicted
        self._samples.append((now, float(n)))
        self._total += n
        self._expire(now)

    def _expire(self, now: float) -> None:
        cutoff = now - self._window_s
        s = self._samples
        while s and s[0][0] < cutoff:
            self._total -= s.popleft()[1]

    def rate(self, now: float) -> float:
        """Events/second over the window (0.0 when empty): the elapsed
        span, at least 0.5 s and at most the window."""
        self._expire(now)
        if not self._samples:
            return 0.0
        span = max(now - self._samples[0][0], 1e-6)
        return self._total / min(max(span, 0.5), self._window_s)


class _H2DCell:
    """Per-(model, bucket) host-to-device accounting."""

    __slots__ = ("bytes_child", "seconds_child", "hidden_child", "bytes",
                 "seconds", "hidden_s", "batches", "slots")

    def __init__(self, bytes_child, seconds_child, hidden_child):
        self.bytes_child = bytes_child
        self.seconds_child = seconds_child
        self.hidden_child = hidden_child
        self.bytes = 0
        self.seconds = 0.0
        self.hidden_s = 0.0
        self.batches = 0
        self.slots = 0


class _BatchCell:
    """Per-(model, geometry, bucket) state of ``note_batch``: its metric
    children and the device-time EMA. The MFU and TFLOP/s children are
    made at the first batch with an MFU (none on the CPU: no gauge)."""

    __slots__ = ("device", "padded", "slots", "occupancy", "mfu", "tflops",
                 "ema_ms", "ema_init", "frames", "padded_total")

    def __init__(self, device, padded, slots, occupancy, mfu, tflops):
        self.device = device
        self.padded = padded
        self.slots = slots
        self.occupancy = occupancy
        self.mfu = mfu
        self.tflops = tflops
        self.ema_ms = 0.0
        self.ema_init = False
        self.frames = 0
        self.padded_total = 0


class PerfTracker:
    """Per-engine device-performance attribution feeding the registry."""

    def __init__(self, *, peak_tflops: float = 0.0,
                 registry: Optional[metrics.Registry] = None,
                 clock=time.monotonic, fps_window_s: float = 10.0):
        reg = registry if registry is not None else metrics.registry
        self.peak_tflops = float(peak_tflops)
        self._clock = clock
        self._lock = threading.Lock()
        # (model, geometry, bucket) -> compile record
        self._compiles: Dict[Tuple[str, str, int], dict] = {}
        # (model, geometry, bucket) -> note_batch cell
        self._cells: Dict[Tuple[str, str, int], _BatchCell] = {}
        # (model, bucket) -> H2D cell
        self._h2d: Dict[Tuple[str, int], _H2DCell] = {}
        self._fps = _RateWindow(window_s=fps_window_s)

        self._m_compile_s = reg.histogram(
            "vep_compile_seconds",
            "Program build (CUDA graph capture) wall time per step-cache miss",
            ("model", "geometry", "bucket"))
        self._m_compile_programs = reg.counter(
            "vep_compile_programs_total",
            "Built serving programs per (model, geometry, bucket)",
            ("model", "geometry", "bucket"))
        self._m_program_gflop = reg.gauge(
            "vep_compile_program_gflop",
            "FLOPs per program execution, counted by FlopCounterMode over the "
            "eager step when the program is built (GFLOP)",
            ("model", "geometry", "bucket"))
        self._m_device = reg.histogram(
            "vep_perf_device_ms",
            "Device batch time per bucket: the step's span on the compute "
            "stream between CUDA events (no drain-queue wait; on the CPU, "
            "submit->drained)", ("model", "bucket"))
        self._m_padded = reg.counter(
            "vep_perf_padded_slots_total",
            "Batch slots filled with padding, not frames",
            ("model", "bucket"))
        self._m_slots = reg.counter(
            "vep_perf_batch_slots_total",
            "Total batch slots dispatched (real frames + padding)",
            ("model", "bucket"))
        self._m_occupancy = reg.gauge(
            "vep_perf_bucket_occupancy_pct",
            "Real frames over bucket size, last batch",
            ("model", "bucket"))
        self._m_mfu = reg.gauge(
            "vep_perf_mfu_pct",
            "Live model-FLOPs utilization against peak_tflops (EMA device "
            "time)", ("model", "bucket"))
        self._m_tflops = reg.gauge(
            "vep_perf_achieved_tflops",
            "Achieved TFLOP/s per batch (EMA device time)",
            ("model", "bucket"))
        self._m_peak = reg.gauge(
            "vep_perf_peak_tflops",
            "Dense bf16 peak TFLOP/s of the card used for MFU")
        if self.peak_tflops > 0.0:
            self._m_peak.set(self.peak_tflops)
        self._m_fps = reg.gauge(
            "vep_perf_fps",
            "Aggregate emitted frames/second (sliding window)")
        self._m_h2d_bytes = reg.counter(
            "vep_h2d_bytes",
            "Host->device bytes shipped per dispatched batch (uint8 frames "
            "incl. bucket padding, plus the thumbnail slot-index vector)",
            ("model", "bucket"))
        self._m_h2d_seconds = reg.counter(
            "vep_h2d_seconds",
            "Seconds of host->device copy per batch (CUDA events on the "
            "transfer stream)", ("model", "bucket"))
        self._m_h2d_hidden = reg.counter(
            "vep_h2d_hidden_seconds",
            "Share of the H2D copy seconds spent while a dispatched batch "
            "was in flight (prefetch stage)", ("model", "bucket"))
        # The ROI path (engine cfg.roi): the gate's verdicts a tick, the
        # packer's output, scatter-back routing failures, and the rate of
        # per-stream results served through the plane (coasted, packed or
        # full): what the fleet would have cost in full frames.
        self._m_roi_states = reg.counter(
            "vep_roi_stream_states_total", "Motion-gate verdicts per detect stream per tick",
            ("state",))
        self._m_roi_crops = reg.counter(
            "vep_roi_crops_total", "Crops packed onto shared canvases").labels()
        self._m_roi_canvases = reg.counter(
            "vep_roi_canvases_total", "Shared canvases dispatched").labels()
        self._m_roi_occupancy = reg.gauge(
            "vep_roi_canvas_occupancy_pct",
            "Crop-pixel share of the packed canvas plane, last batch").labels()
        self._m_roi_unrouted = reg.counter(
            "vep_roi_unrouted_total",
            "Canvas detections that landed outside every crop cell (dropped in "
            "scatter-back)").labels()
        self._m_roi_fps = reg.gauge(
            "vep_roi_equivalent_fps",
            "Per-stream results served through the ROI plane per second "
            "(full-frame-equivalent fps, sliding window)").labels()
        self._roi_fps = _RateWindow(window_s=fps_window_s)
        self._roi = {"idle": 0, "roi": 0, "full": 0, "crops": 0, "canvases": 0,
                     "unrouted": 0, "area_frac": None}
        # The temporal cascade (engine cfg.cascade): detect every tick, the
        # head every N; the cadence gauge is head batches over ticks.
        self._m_cascade_ticks = reg.counter(
            "vep_cascade_ticks_total", "Engine ticks observed by the cascade scheduler").labels()
        self._m_cascade_head = reg.counter(
            "vep_cascade_head_batches_total",
            "Temporal-head batches dispatched (cadence ticks with due tracks)").labels()
        self._m_cascade_events = reg.counter(
            "vep_cascade_events_total", "Track event transitions fired by the hysteresis machine",
            ("kind",))
        self._m_cascade_tracks = reg.gauge(
            "vep_cascade_tracks", "Track slots live in the device-resident state pool").labels()
        self._m_cascade_cadence = reg.gauge(
            "vep_cascade_head_cadence",
            "Cascade ticks per temporal-head batch (target: cascade_every_n)").labels()
        self._cascade = {"ticks": 0, "head_batches": 0, "head_slots": 0, "events": {},
                         "tracks": 0, "high_water": 0}

    def set_peak(self, peak_tflops: float) -> None:
        """Install the peak resolved at warmup (``resolve_peak_tflops``)."""
        self.peak_tflops = float(peak_tflops)
        if self.peak_tflops > 0.0:
            self._m_peak.set(self.peak_tflops)

    # -- program build --------------------------------------------------------

    @staticmethod
    def _geometry(src_hw: Tuple[int, int]) -> str:
        return f"{src_hw[0]}x{src_hw[1]}"

    def note_compile(self, model: str, src_hw: Tuple[int, int], bucket: int,
                     seconds: float, *, cost: Optional[dict] = None) -> None:
        """Record one step-cache-miss program build of ``seconds``; ``cost``
        ({"flops": ...}) gives its FLOPs."""
        cost = cost or {}
        geometry = self._geometry(src_hw)
        key = (model, geometry, bucket)
        with self._lock:
            rec = self._compiles.get(key)
            if rec is None:
                rec = {"model": model, "geometry": geometry, "bucket": bucket,
                       "programs": 0, "compile_s": 0.0, "flops": 0.0,
                       "bytes_accessed": 0.0}
                self._compiles[key] = rec
            rec["programs"] += 1
            rec["compile_s"] += float(seconds)
            if cost.get("flops"):
                rec["flops"] = cost["flops"]
            if cost.get("bytes_accessed"):
                rec["bytes_accessed"] = cost["bytes_accessed"]
        b = str(bucket)
        self._m_compile_s.labels(model, geometry, b).observe(float(seconds))
        self._m_compile_programs.labels(model, geometry, b).inc()
        if cost.get("flops"):
            self._m_program_gflop.labels(model, geometry, b).set(cost["flops"] / 1e9)

    def compiles(self) -> List[dict]:
        """Copies of the compile records, one per (model, geometry, bucket)."""
        with self._lock:
            return [dict(rec) for rec in self._compiles.values()]

    # -- per batch ----------------------------------------------------------------

    def note_batch(self, model: str, src_hw: Tuple[int, int], bucket: int,
                   device_ms: float, frames: int, *, streams: Optional[int] = None,
                   area_frac: Optional[float] = None) -> None:
        """Record one drained batch: ``frames`` real frames in a
        ``bucket``-slot program that ran for ``device_ms``.

        A packed canvas batch (the ROI path): ``frames`` is its canvas
        count, ``streams`` the source streams whose crops rode it (the fps
        window counts results, not canvases; 0 for a program that emits
        none, the cascade head) and ``area_frac`` the crop-pixel share of
        the canvases, which the occupancy gauge then reports: a half-empty
        canvas is not one fully occupied slot."""
        key = (model, self._geometry(src_hw), bucket)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._make_cell(key)
        padded = bucket - frames
        cell.device.observe(device_ms)
        if padded > 0:
            cell.padded.inc(padded)
        cell.slots.inc(bucket)
        if area_frac is not None:
            cell.occupancy.set(100.0 * area_frac)
        else:
            cell.occupancy.set(100.0 * frames / bucket if bucket else 0.0)
        if cell.ema_init:
            cell.ema_ms = 0.9 * cell.ema_ms + 0.1 * device_ms
        else:
            cell.ema_ms = device_ms
            cell.ema_init = True
        cell.frames += frames
        cell.padded_total += max(padded, 0)
        rec = self._compiles.get(key)
        flops = rec["flops"] if rec is not None else 0.0
        util = mfu_pct(flops, cell.ema_ms, self.peak_tflops)
        if util is not None:
            if cell.mfu is None:
                cell.mfu, cell.tflops = (self._m_mfu.labels(model, str(bucket)),
                                         self._m_tflops.labels(model, str(bucket)))
            cell.mfu.set(util)
            cell.tflops.set(flops / (cell.ema_ms * 1e-3) / 1e12)
        now = self._clock()
        self._fps.add(streams if streams is not None else frames, now)
        self._m_fps.set(self._fps.rate(now))

    def note_h2d(self, model: str, bucket: int, nbytes: int, seconds: float, *,
                 hidden_s: float = 0.0) -> None:
        """Record one host->device batch placement: ``nbytes`` copied in
        ``seconds``, ``hidden_s`` of it while a dispatched batch was in
        flight."""
        key = (model, bucket)
        cell = self._h2d.get(key)
        if cell is None:
            cell = self._make_h2d_cell(key)
        cell.bytes_child.inc(nbytes)
        cell.seconds_child.inc(seconds)
        if hidden_s > 0.0:
            cell.hidden_child.inc(hidden_s)
            cell.hidden_s += float(hidden_s)
        cell.bytes += int(nbytes)
        cell.seconds += float(seconds)
        cell.batches += 1
        cell.slots += int(bucket)

    # -- the ROI path (engine cfg.roi) -------------------------------------------

    def note_roi_gate(self, idle: int, roi: int, full: int) -> None:
        """One tick's motion-gate split over detect streams."""
        if idle:
            self._m_roi_states.labels("idle").inc(idle)
        if roi:
            self._m_roi_states.labels("roi").inc(roi)
        if full:
            self._m_roi_states.labels("full").inc(full)
        with self._lock:
            self._roi["idle"] += idle
            self._roi["roi"] += roi
            self._roi["full"] += full

    def note_roi_pack(self, crops: int, canvases: int, area_frac: float) -> None:
        """One packed canvas batch leaving the packer."""
        self._m_roi_crops.inc(crops)
        self._m_roi_canvases.inc(canvases)
        self._m_roi_occupancy.set(100.0 * area_frac)
        with self._lock:
            self._roi["crops"] += crops
            self._roi["canvases"] += canvases
            self._roi["area_frac"] = area_frac

    def note_roi_emit(self, streams: int) -> None:
        """Per-stream results served through the ROI plane (coasted, packed,
        or full frames while it gates): the full-frame-equivalent fps."""
        now = self._clock()
        self._roi_fps.add(streams, now)
        self._m_roi_fps.set(self._roi_fps.rate(now))

    def note_roi_unrouted(self, n: int = 1) -> None:
        self._m_roi_unrouted.inc(n)
        with self._lock:
            self._roi["unrouted"] += n

    def roi_equivalent_fps(self) -> float:
        return self._roi_fps.rate(self._clock())

    # -- the temporal cascade (engine cfg.cascade) -----------------------------

    def note_cascade_tick(self) -> None:
        """One engine tick seen by the cascade scheduler (head tick or not)."""
        self._m_cascade_ticks.inc()
        with self._lock:
            self._cascade["ticks"] += 1
            self._set_cascade_cadence_locked()

    def note_cascade_head(self, slots: int) -> None:
        """One temporal-head batch with ``slots`` live track slots (its
        device time and H2D ride ``note_batch``/``note_h2d`` under the
        ``cascade/<model>`` key)."""
        self._m_cascade_head.inc()
        with self._lock:
            self._cascade["head_batches"] += 1
            self._cascade["head_slots"] += int(slots)
            self._set_cascade_cadence_locked()

    def note_cascade_event(self, kind: str) -> None:
        """One hysteresis transition ("enter"/"exit") of a track."""
        self._m_cascade_events.labels(kind).inc()
        with self._lock:
            ev = self._cascade["events"]
            ev[kind] = ev.get(kind, 0) + 1

    def note_cascade_slots(self, in_use: int, high_water: int) -> None:
        """The state pool's occupancy after a cascade tick."""
        self._m_cascade_tracks.set(float(in_use))
        with self._lock:
            self._cascade["tracks"] = int(in_use)
            self._cascade["high_water"] = max(self._cascade["high_water"], int(high_water))

    def _set_cascade_cadence_locked(self) -> None:
        c = self._cascade
        if c["head_batches"]:
            self._m_cascade_cadence.set(c["ticks"] / c["head_batches"])

    def _make_h2d_cell(self, key: Tuple[str, int]) -> _H2DCell:
        model, bucket = key
        b = str(bucket)
        cell = _H2DCell(bytes_child=self._m_h2d_bytes.labels(model, b),
                        seconds_child=self._m_h2d_seconds.labels(model, b),
                        hidden_child=self._m_h2d_hidden.labels(model, b))
        with self._lock:
            return self._h2d.setdefault(key, cell)

    def _make_cell(self, key: Tuple[str, str, int]) -> _BatchCell:
        model, _geometry, bucket = key
        b = str(bucket)
        cell = _BatchCell(device=self._m_device.labels(model, b),
                          padded=self._m_padded.labels(model, b),
                          slots=self._m_slots.labels(model, b),
                          occupancy=self._m_occupancy.labels(model, b),
                          mfu=None, tflops=None)
        with self._lock:
            return self._cells.setdefault(key, cell)

    def fps(self) -> float:
        """Aggregate emitted frames/second over the sliding window."""
        return self._fps.rate(self._clock())

    # -- snapshot ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able summary for /api/v1/stats and the profiler's bundles."""
        with self._lock:
            compiles = [dict(rec) for rec in self._compiles.values()]
            buckets = []
            for (model, geometry, bucket), cell in sorted(self._cells.items()):
                rec = self._compiles.get((model, geometry, bucket))
                flops = rec["flops"] if rec is not None else 0.0
                util = mfu_pct(flops, cell.ema_ms, self.peak_tflops)
                slots = cell.frames + cell.padded_total
                buckets.append({
                    "model": model, "geometry": geometry, "bucket": bucket,
                    "device_ms_ema": round(cell.ema_ms, 3),
                    "frames": cell.frames,
                    "padded_slots": cell.padded_total,
                    "padded_pct": round(100.0 * cell.padded_total / slots, 2) if slots else 0.0,
                    "mfu_pct": round(util, 3) if util is not None else None,
                })
            h2d = []
            h2d_seconds = 0.0
            h2d_hidden = 0.0
            for (model, bucket), cell in sorted(self._h2d.items()):
                h2d_seconds += cell.seconds
                h2d_hidden += cell.hidden_s
                h2d.append({
                    "model": model, "bucket": bucket,
                    "bytes": cell.bytes,
                    "seconds": round(cell.seconds, 6),
                    "hidden_seconds": round(cell.hidden_s, 6),
                    "hidden_pct": (round(100.0 * cell.hidden_s / cell.seconds, 1)
                                   if cell.seconds > 0 else None),
                    "batches": cell.batches,
                    "bytes_per_frame": cell.bytes // cell.slots if cell.slots else None,
                    "mbps": (round(cell.bytes / 1e6 / cell.seconds, 1)
                             if cell.seconds > 0 else None),
                })
            roi = dict(self._roi)
            casc = dict(self._cascade)
            casc["events"] = dict(casc["events"])
        out = {
            "peak_tflops": self.peak_tflops,
            "fps": round(self.fps(), 1),
            "compiles": sorted(compiles, key=lambda r: (r["model"], r["geometry"],
                                                        r["bucket"])),
            "buckets": buckets,
            "h2d": h2d,
            "h2d_hidden_pct": (round(100.0 * h2d_hidden / h2d_seconds, 1)
                               if h2d_seconds > 0 else None),
        }
        gated = roi["idle"] + roi["roi"] + roi["full"]
        if gated or roi["canvases"]:
            out["roi"] = {
                "stream_ticks": {"idle": roi["idle"], "roi": roi["roi"], "full": roi["full"]},
                "gated_stream_pct": (round(100.0 * (roi["idle"] + roi["roi"]) / gated, 1)
                                     if gated else 0.0),
                "crops": roi["crops"],
                "canvases": roi["canvases"],
                "crops_per_canvas": (round(roi["crops"] / roi["canvases"], 2)
                                     if roi["canvases"] else None),
                "canvas_occupancy_pct": (round(100.0 * roi["area_frac"], 1)
                                         if roi["area_frac"] is not None else None),
                "unrouted": roi["unrouted"],
                "equivalent_fps": round(self.roi_equivalent_fps(), 1),
            }
        if casc["ticks"] or casc["head_batches"]:
            heads = casc["head_batches"]
            out["cascade"] = {
                "ticks": casc["ticks"],
                "head_batches": heads,
                "head_cadence": round(casc["ticks"] / heads, 2) if heads else None,
                "slots_per_head": round(casc["head_slots"] / heads, 2) if heads else None,
                "events": casc["events"],
                "tracks": casc["tracks"],
                "slot_high_water": casc["high_water"],
            }
        return out
