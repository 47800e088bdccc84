"""Serving step and inference engine (counterpart of ``video_edge_ai_proxy_tpu/engine/runner.py``).

``build_serving_step`` is the single source of truth for the per-tick
device program of a model: uint8 frames (or clips) in, postprocessed
results out. Detectors: letterbox -> YOLOv8 ``decode="serving"`` ->
sigmoid of the per-anchor max logit -> batched NMS through the CUDA
keep-mask kernel -> unletterbox. Classifiers and video models: stretch
resize + ImageNet normalisation -> ViT / VideoMAE (long clips through the
CUDA flash-attention kernel) -> float32 softmax -> top-5. Frame models
add the frame-quality statistics. It runs eagerly; ``chip_smoke.py``
times it.

The engine compiles it once per (model, stem, geometry, bucket), the JAX
engine's step-cache key: on the card ``_GraphedStep`` captures it into
one CUDA graph over static input buffers and replays that graph for
every batch of the key (the counterpart of the JAX ``_TimedStep``), with
step-cache hit and miss counters, the capture's time in
``obs/perf.py``, prewarming at ``start()`` from ``cfg.prewarm`` and the
prewarm manifest (``engine/aot_cache.py``), and ``prewarm_status()``. On
the CPU, where the caller asked for it, the step runs eagerly.

``InferenceEngine`` is the serving pipeline around it, on three threads:

- the tick thread: the degradation ladder's rung, collect (the pooled
  fast path of ``collector.py``, filled between ticks by the doorbell-woken
  assembly window), stale-frame shedding, then per group the step queued
  on the compute stream after its input's copy, with the quality
  thumbnails gathered from and scattered to a device pool (``_ThumbPool``);
- the transfer thread (``cfg.prefetch``): H2D of each group from its
  pinned pooled buffer on a side stream, double-buffered
  (``_PrefetchStage``), so the copy of batch t + 1 overlaps the step of
  batch t;
- the drain thread: a depth-2 queue of dispatched batches, read back on
  their own stream once the step's event completes, then per stream the
  tracker, the quality verdicts, the SLO samples and the result.

Results are plain dataclasses with the proto's field names; the server's
gRPC wire converts them to the proto messages.

Per-stream models: with ``model_resolver`` (device_id -> registry name,
"" for the default, "none" for inference off) a stream is served by a
model of its own, built on first use from the port's registry on the
engine's device (``_ensure_model``); its program is one more key of the
step cache. An unknown name, or a model that fails to build, falls back
to the default model behind a failure breaker that half-opens after
``BAD_MODEL_BACKOFF_S``, doubling up to ``BAD_MODEL_BACKOFF_MAX_S``.

The annotation uplink: with ``annotations`` (an ``AnnotationQueue``) every
emitted frame's detections become ``AnnotateRequest`` wire bytes on the
queue (``proto/annotate.py``), thinned by the emit policy
(``cfg.annotation_emit`` or the stream's ``annotation_policy_resolver``
override: all, keyframe, min_interval, on_change), and the quality
verdicts' transitions go out as ``type="quality"`` events. An engine with
an uplink has standing interest in every stream.

The audit and profiling planes: the decision journal (``journal``,
``obs/journal.py``; or one passed in, shared with the server) records the
ladder's transitions, the SLO episodes, the shed excursion
(``shed_open``/``shed_close``) and the watchdog's episodes; the watchdog
(``obs/watch.py``) checks drain backpressure, recompile storms (step-cache
misses on consecutive ticks), the ladder and the SLOs once a tick
(``_watch_tick``); the profiler (``obs/prof.py``, ``cfg.prof``) takes
bounded torch.profiler captures on demand and, with ``cfg.prof_trigger``,
once per SLO episode or escalation; the lineage spans (``obs/spans.py``
``tracer``, when the server turns it on) record submit, device, emit and
dropped; ``stage_records`` (``cfg.stage_trace``) keep each frame's stage
times; and the canary loop (``cfg.quality_canary``) replays a golden trace
through the bus and checks its fold once a loop. All are off the per-frame
path or one poll a tick: a replay is bit-identical with them on and off.

ROI, the cascade, the fault domain and the mesh paths are later slices.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import queue
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..bus.interface import FrameBus
from ..device import resolve_device
from ..models import registry
from ..obs import registry as obs_registry
from ..obs.perf import PerfTracker
from ..obs.prof import Profiler
from ..obs.quality import QualityTracker
from ..obs.slo import SLOEngine, default_slos
from ..obs.spans import trace_id_of, tracer
from ..obs.watch import Watchdog
from ..ops.nms import _top, batched_nms, nms_keep_mask
from ..ops.preprocess import (
    frame_quality_stats, preprocess_classify, preprocess_clip, preprocess_letterbox,
    unletterbox_boxes,
)
from ..proto.annotate import AnnotateRequest, encode as encode_annotation
from ..proto.annotate import BoundingBox as AnnotationBox
from ..replay.checksum import CHECKSUM_MASK, host_slot_checksum
from ..resilience.ladder import RUNGS, DegradationLadder
from ..utils.config import EngineConfig
from . import aot_cache
from .classes import class_name
from .collector import BatchGroup, Collector, bucket_for, host_empty
from .tracker import IoUTracker

log = logging.getLogger("vep.torch.engine.runner")

TOP_K_CLASSES = 5


def build_serving_step(
    model: torch.nn.Module,
    spec,
    *,
    quality_thumb: int = 0,
    preprocess_dtype: torch.dtype = torch.bfloat16,
    keep_mask: Callable[[torch.Tensor, float], torch.Tensor] = nms_keep_mask,
):
    """The per-tick program of ``spec.kind``: ``step(frames_u8)`` on the
    model's device ->

    - ``"detect"``: frames [N, H, W, 3] uint8 -> dict of ``boxes [N, 100,
      4]`` (source px, xyxy), ``scores``, ``classes``, ``valid``;
    - ``"classify"`` / ``"video"``: frames [N, H, W, 3], or clips [N,
      clip_len, H, W, 3], uint8 -> dict of ``top_probs [N, 5]`` f32 and
      ``top_ids [N, 5]`` int32 (``lax.top_k``'s order: ties toward the
      lower class id).

    Preprocessing runs in ``preprocess_dtype`` (bf16, as in the JAX
    package, whatever the model's dtype), the model in its own dtype.
    ``keep_mask`` is the NMS keep-mask function (default: the device's own,
    the CUDA kernel on the card).

    With ``quality_thumb`` > 0 a frame model's step takes an optional
    second argument, the previous tick's [N, th, tw] f32 luma thumbnails
    (omitted -> zeros), and its output gains ``quality_stats`` [N, 3] and
    ``quality_thumbs``. Clip models never take quality statistics.
    """
    size = spec.input_size
    if spec.kind == "detect":
        def raw(frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
            with torch.inference_mode():
                x, lb = preprocess_letterbox(frames_u8, size, out_dtype=preprocess_dtype)
                # decode="serving": class reduction in logit space; sigmoid is
                # monotone, so it is applied to the per-anchor winners only.
                boxes, max_logit, cls_ids = model(x.permute(0, 3, 1, 2), decode="serving")
                b, s, c, valid = batched_nms(boxes, torch.sigmoid(max_logit), cls_ids,
                                             keep_mask=keep_mask)
                b = unletterbox_boxes(b, lb)
            return {"boxes": b, "scores": s, "classes": c, "valid": valid}
    elif spec.kind in ("classify", "video"):
        pre = preprocess_clip if spec.clip_len else preprocess_classify

        def raw(frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
            with torch.inference_mode():
                x = pre(frames_u8, (size, size), out_dtype=preprocess_dtype)
                probs = torch.softmax(model(x).float(), dim=-1)
                top_p, top_i = _top(probs, min(TOP_K_CLASSES, probs.shape[-1]))
            return {"top_probs": top_p, "top_ids": top_i.to(torch.int32)}
    else:
        raise NotImplementedError(f"serving step for kind={spec.kind!r} is not ported yet")

    if not quality_thumb or spec.clip_len:
        return raw

    thumb_hw = (quality_thumb, quality_thumb)

    def with_stats(frames_u8: torch.Tensor,
                   prev_thumbs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out = raw(frames_u8)
        with torch.inference_mode():
            if prev_thumbs is None:
                prev_thumbs = torch.zeros((frames_u8.shape[0],) + thumb_hw,
                                          dtype=torch.float32, device=frames_u8.device)
            stats, thumbs = frame_quality_stats(frames_u8, prev_thumbs, thumb_hw)
        out["quality_stats"] = stats
        out["quality_thumbs"] = thumbs
        return out

    return with_stats


# -- results (the proto messages' field names) ------------------------------


@dataclass
class BoundingBox:
    top: int = 0
    left: int = 0
    width: int = 0
    height: int = 0


@dataclass
class Detection:
    box: BoundingBox = field(default_factory=BoundingBox)
    confidence: float = 0.0
    class_id: int = 0
    class_name: str = ""
    track_id: str = ""            # per-stream tracker id (cfg.track)


@dataclass
class InferenceResult:
    device_id: str = ""
    timestamp: int = 0            # capture timestamp of the source frame (ms)
    model: str = ""
    detections: List[Detection] = field(default_factory=list)
    latency_ms: float = 0.0       # capture -> result latency
    batch_size: int = 0           # device batch this frame rode in
    frame_packet: int = 0         # source packet counter
    trace_id: int = 0             # the source frame's trace context (0 = unstamped)
    parent_span: int = 0


def to_detections(host: Dict[str, np.ndarray], i: int, kind: str,
                  num_classes: int) -> List[Detection]:
    """Row ``i`` of a host-side step output -> wire detections. Detectors:
    int pixel boxes (left/top/width/height), confidence, class id and
    name. Classifiers and video models: one box-less detection per top-5
    entry."""
    out: List[Detection] = []
    if kind != "detect":
        for p, cid in zip(host["top_probs"][i], host["top_ids"][i]):
            out.append(Detection(confidence=float(p), class_id=int(cid),
                                 class_name=class_name(int(cid), num_classes)))
        return out
    for j in np.nonzero(host["valid"][i])[0]:
        x1, y1, x2, y2 = (int(round(float(v))) for v in host["boxes"][i, j])
        cid = int(host["classes"][i, j])
        out.append(Detection(
            box=BoundingBox(left=x1, top=y1, width=x2 - x1, height=y2 - y1),
            confidence=float(host["scores"][i, j]),
            class_id=cid,
            class_name=class_name(cid, num_classes),
        ))
    return out


# -- shedding and admission (degradation-ladder rungs) ------------------------


def admitted_streams(inferred: Sequence[str], deprioritized: Sequence[str] = ()) -> List[str]:
    """Ladder rung ``admission_pause``: admit a deterministic half of the
    streams, the first half of the sorted ids, so the same streams stay
    admitted across ticks. One stream never pauses. ``deprioritized``
    streams (quality-unhealthy: black or frozen) sort behind every healthy
    one, so they are the first to pause."""
    dep = set(deprioritized)
    ids = sorted(inferred, key=lambda d: (d in dep, d))
    if len(ids) <= 1:
        return ids
    return sorted(ids[: (len(ids) + 1) // 2])


def shed_stale(group: BatchGroup, now_ms: float, max_staleness_ms: float,
               buckets: Sequence[int]):
    """Ladder rung ``shed``: drop the frames older than the staleness bound
    from a collected group before dispatch. Fresh rows compact in place
    within the pooled buffer (the lease is untouched) and the view
    re-slices to the smallest covering bucket. Returns ``(group, shed)``;
    group is None when every row was stale (the caller releases the lease).
    Frames without a capture timestamp count as fresh."""
    keep = [i for i, m in enumerate(group.metas)
            if not m.timestamp_ms or now_ms - m.timestamp_ms <= max_staleness_ms]
    shed = len(group.metas) - len(keep)
    if shed == 0:
        return group, 0
    if tracer.enabled:
        kept = set(keep)
        for i, m in enumerate(group.metas):
            if i not in kept and tracer.sampled(m.packet):
                tracer.record(group.device_ids[i], "dropped", m.packet, reason="stale_shed",
                              trace_id=trace_id_of(m, group.device_ids[i]))
    if not keep:
        return None, shed
    for new_i, old_i in enumerate(keep):
        if new_i != old_i:
            group.frames[new_i] = group.frames[old_i]
    group.device_ids = [group.device_ids[i] for i in keep]
    group.metas = [group.metas[i] for i in keep]
    n = len(keep)
    bucket = bucket_for(n, sorted(buckets))
    view = group.frames[:bucket]
    if bucket != n:
        view[n:] = 0
    group.frames = view
    group.bucket = bucket
    return group, shed


# -- per-stream and pipeline accounting ----------------------------------------


@dataclass
class StreamStats:
    frames: int = 0
    last_latency_ms: float = 0.0
    ema_latency_ms: float = 0.0
    last_batch: int = 0
    padded_slots: int = 0          # zero-padded slots of the last batch
    device_ms_ema: float = 0.0
    device_ms_initialized: bool = False
    # Monotonic time of the last emitted result: the availability SLO's
    # signal.
    last_emit_mono: float = 0.0
    # A first frame can measure 0.0 ms; the flag, not the value, seeds
    # the EMA.
    ema_initialized: bool = False

    def note_latency(self, latency_ms: float) -> None:
        self.last_latency_ms = latency_ms
        if self.ema_initialized:
            self.ema_latency_ms = 0.9 * self.ema_latency_ms + 0.1 * latency_ms
        else:
            self.ema_latency_ms = latency_ms
            self.ema_initialized = True

    def note_device(self, device_ms: float, padded_slots: int) -> None:
        self.padded_slots = padded_slots
        if self.device_ms_initialized:
            self.device_ms_ema = 0.9 * self.device_ms_ema + 0.1 * device_ms
        else:
            self.device_ms_ema = device_ms
            self.device_ms_initialized = True


@dataclass(frozen=True)
class StreamStatsView:
    """Immutable point-in-time copy handed out by ``stats()``: the drain
    thread keeps mutating the live StreamStats."""

    frames: int = 0
    last_latency_ms: float = 0.0
    ema_latency_ms: float = 0.0
    last_batch: int = 0
    padded_slots: int = 0
    device_ms_ema: float = 0.0


class _RateWindow:
    """Frames emitted over the last ``window_s`` seconds: the aggregate
    frames/s the fps objective samples each tick."""

    def __init__(self, window_s: float = 2.0):
        self._window_s = window_s
        self._lock = threading.Lock()
        self._events: deque = deque()     # (monotonic, frames)
        self._start = time.monotonic()

    def note(self, frames: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, frames))
            while self._events and now - self._events[0][0] > self._window_s:
                self._events.popleft()

    def fps(self) -> float:
        now = time.monotonic()
        with self._lock:
            span = min(self._window_s, now - self._start)
            n = sum(f for t, f in self._events if now - t <= self._window_s)
        return n / span if span > 0 else 0.0


@dataclass
class PipelineStats:
    """Engine-wide totals, read through ``InferenceEngine.pipeline_stats``.
    Device times come from CUDA events and are 0 on the CPU."""

    batches: int = 0
    frames: int = 0               # emitted results
    shed_frames: int = 0
    h2d_ms: float = 0.0           # copy time on the transfer stream
    h2d_overlapped_ms: float = 0.0  # of it, while a dispatched batch was in flight
    device_ms: float = 0.0        # step spans on the compute stream
    # Capture -> result, by stage, summed over emitted frames (ms):
    capture_to_collect_ms: float = 0.0   # wait for the tick's collect
    collect_to_submit_ms: float = 0.0    # placement wait and step launch
    submit_to_drained_ms: float = 0.0    # device finish and read-back
    drained_to_emitted_ms: float = 0.0   # tracker, quality, publish
    # The drain's host time, summed over batches (ms):
    emit_ms: float = 0.0          # the emit loop over a batch's slots
    track_ms: float = 0.0         # of it, the tracker


# -- device state and the in-flight pipeline -------------------------------------


@dataclass
class _Inflight:
    """A dispatched (not yet drained) batch."""

    group: BatchGroup
    outputs: Dict[str, torch.Tensor]
    t_collect: float              # wall s the tick's collect returned
    t_submit: float               # wall s the step was queued
    start: Optional["torch.cuda.Event"] = None   # compute stream, before the step
    done: Optional["torch.cuda.Event"] = None    # compute stream, after the step


class _ThumbPool:
    """Device-resident per-stream quality thumbnails: one [capacity, th, tw]
    f32 tensor and a host map from stream to row. A batch's previous-tick
    thumbnails are a device-side gather by row; the step's new thumbnails
    scatter back. Both run on the tick thread's (compute) stream, so tick
    t + 1 gathers what tick t scattered. Row 0 stays zero: first-seen
    streams and padded slots gather it (the first diff is against zeros,
    which the quality tracker discards)."""

    _GROW = 64

    def __init__(self, side: int, device: torch.device):
        self.side = int(side)
        self.device = device
        self._slots: Dict[str, int] = {}
        self._free: List[int] = []
        self._pool: Optional[torch.Tensor] = None
        self._high = 0

    def __bool__(self) -> bool:
        return bool(self._slots)

    def __iter__(self):
        return iter(list(self._slots))

    def pop(self, device_id: str) -> None:
        """Forget a stream; its row is free for reuse (scatter overwrites
        it before anything gathers it)."""
        row = self._slots.pop(device_id, None)
        if row is not None:
            self._free.append(row)

    def _ensure(self, rows: int) -> None:
        cap = 0 if self._pool is None else self._pool.shape[0]
        if rows <= cap:
            return
        grown = torch.zeros((-(-max(rows, 1) // self._GROW) * self._GROW, self.side, self.side),
                            dtype=torch.float32, device=self.device)
        if self._pool is not None:
            grown[:cap] = self._pool
        self._pool = grown

    def _to_device(self, rows: Sequence[int]) -> torch.Tensor:
        idx = torch.tensor(rows, dtype=torch.int64)
        if self.device.type == "cuda":
            # Pinned and asynchronous: a pageable copy would synchronise
            # the compute stream.
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def gather(self, device_ids: Sequence[str], bucket: int) -> torch.Tensor:
        """Previous-tick [bucket, th, tw] thumbnails of a batch, slot order."""
        self._ensure(1)
        rows = [self._slots.get(d, 0) for d in device_ids]
        rows += [0] * (bucket - len(rows))
        return self._pool.index_select(0, self._to_device(rows))

    def scatter(self, device_ids: Sequence[str], thumbs: torch.Tensor) -> None:
        """Store this tick's thumbnails (rows 0..n-1 of ``thumbs``) for the
        next tick's diff; assigns rows on first sight."""
        rows = []
        for d in device_ids:
            row = self._slots.get(d)
            if row is None:
                row = self._free.pop() if self._free else self._high + 1
                self._high = max(self._high, row)
                self._slots[d] = row
            rows.append(row)
        if not rows:
            return
        self._ensure(max(rows) + 1)
        self._pool.index_copy_(0, self._to_device(rows), thumbs[:len(rows)])


class _Prefetched:
    """Handle of one batch placement in flight on the transfer thread."""

    __slots__ = ("group", "ready", "placed", "event", "error", "transfer_ms",
                 "overlapped_ms")

    def __init__(self, group: BatchGroup):
        self.group = group
        self.ready = threading.Event()
        self.placed: Optional[torch.Tensor] = None
        self.event = None              # the copy's CUDA event (None on the CPU)
        self.error: Optional[BaseException] = None
        self.transfer_ms = 0.0
        self.overlapped_ms = 0.0       # transfer time while a batch was in flight


class _PrefetchStage:
    """The H2D transfer stage: ``place`` (the one placement, with the
    transfer stream) and, when started (``cfg.prefetch``), a depth-2 queue
    feeding one transfer thread that places each collected batch, so the
    copy of batch t + 1 runs while the tick thread dispatches batch t and
    the device computes it. Not started, the tick thread calls ``place``
    itself. A placement resolves only once its copy has completed, so
    nothing reads the leased host buffer after its handle is ready. An
    error on the transfer thread is stored on the handle and raised on the
    tick thread. Its pinned slots are the collector's leased pool buffers:
    one is rewritten only after its lease returns."""

    DEPTH = 2

    def __init__(self, device: torch.device, drain_q: queue.Queue):
        self._device = device
        # A dispatched batch is in flight while the drain queue has
        # unfinished tasks (put at dispatch, done after emit).
        self._drain_q = drain_q
        self.stream = None             # the transfer stream (on the card)
        self._q: "queue.Queue[Optional[_Prefetched]]" = queue.Queue(maxsize=self.DEPTH)
        self._thread: Optional[threading.Thread] = None

    def place(self, frames: np.ndarray):
        """Host frames -> (device tensor, the copy's CUDA event, copy ms).

        On the card the copy runs on the transfer stream, asynchronously
        from the pinned pooled buffer, and returns once it has completed
        (the host lease may then be returned). Frames outside pinned memory
        are refused: there is no synchronous copy. On the CPU (only when
        the caller asked for it) the placement is a plain copy."""
        host = torch.from_numpy(frames)
        if self._device.type != "cuda":
            return host.clone(), None, 0.0
        if not host.is_pinned():
            raise RuntimeError("frames to place must lie in pinned host memory")
        if self.stream is None:
            self.stream = torch.cuda.Stream(self._device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            placed = torch.empty(host.shape, dtype=host.dtype, device=self._device)
            placed.copy_(host, non_blocking=True)
            end.record()
        end.synchronize()
        return placed, end, start.elapsed_time(end)

    def _busy(self) -> bool:
        return self._drain_q.unfinished_tasks > 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="vep-torch-xfer", daemon=True)
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        if self._thread is None:
            return
        try:
            self._q.put(None, timeout=5)
        except queue.Full:
            log.warning("transfer queue full at stop; abandoning the thread")
        self._thread.join(timeout=10)
        self._thread = None

    def submit(self, group: BatchGroup, stop_event) -> Optional[_Prefetched]:
        """Queue a placement; blocks while both slots are taken. None on
        shutdown (the caller returns the lease)."""
        pre = _Prefetched(group)
        while not stop_event.is_set():
            try:
                self._q.put(pre, timeout=0.1)
                return pre
            except queue.Full:
                continue
        return None

    def _loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            pre = self._q.get()
            if pre is None:
                return
            busy = self._busy()
            try:
                pre.placed, pre.event, pre.transfer_ms = self.place(pre.group.frames)
            except BaseException as exc:   # raised on the tick thread
                pre.error = exc
            if busy or self._busy():
                pre.overlapped_ms = pre.transfer_ms
            pre.ready.set()


class _Stopping(RuntimeError):
    """A dispatch abandoned because the engine is stopping: not a failure."""


def _pinned_empty(shape: tuple) -> np.ndarray:
    """An uninitialised uint8 host array in pinned memory (the collector's
    batch buffers on the card, so the H2D copy reads them directly)."""
    return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()


class _GraphedStep:
    """The serving step of one (model, stem, geometry, bucket) key as one
    CUDA graph: the card's counterpart of the JAX engine's ``_TimedStep``,
    the compiled program of a step-cache key.

    The first call builds the eager step (``build()``, i.e.
    ``build_serving_step``), runs it ``WARMUP_CALLS`` times on the calling
    stream (the engine's compute stream) over the static inputs, so that
    cuBLAS, cuDNN and the constants of ``ops/preprocess.py`` are set up
    outside the capture, then captures one call on that stream into the
    engine's graph pool and hands the capture's seconds to ``on_capture``.
    Every call copies its frames (and the previous thumbnails) into the
    static inputs, replays the graph and returns fresh copies of the static
    outputs: the next replay overwrites them while the drain still reads
    this batch. A failed capture or replay raises; nothing runs the step
    eagerly in its place, and the engine drops the batch with a log line.

    A failed capture leaves torch's allocator recording into the pool it
    captured into (``beginAllocateToPool: already recording``), so the pool
    is given up: ``pool()`` is asked for the pool at every capture, and
    ``on_capture_failed`` lets the engine hand out a fresh pool to the
    captures that follow, of this key and of any other. The key is never
    captured again: its batches raise at once for the engine's lifetime,
    so a key that cannot be captured gives up one pool, not one a try.

    Launch counts: a kernel wrapper counts when Python calls it, which
    inside a capture records a launch but runs none. The capture's counts
    are taken back and added at every replay, so each wrapper's count stays
    the number of launches the device ran.
    """

    WARMUP_CALLS = 3

    def __init__(self, build: Callable[[], Callable], frame_shape: tuple,
                 thumb_hw: Optional[tuple], *, device: torch.device,
                 pool: Callable[[], tuple],
                 on_capture: Callable[[float], None],
                 on_capture_failed: Callable[[BaseException], None] = lambda exc: None):
        self._build = build
        self._pool = pool
        self._on_capture = on_capture
        self._on_capture_failed = on_capture_failed
        self._failure: Optional[BaseException] = None
        self._failed_graph: Optional["torch.cuda.CUDAGraph"] = None
        self.frames_in = torch.zeros(frame_shape, dtype=torch.uint8, device=device)
        self.thumbs_in = None
        if thumb_hw:
            self.thumbs_in = torch.zeros((frame_shape[0],) + tuple(thumb_hw),
                                         dtype=torch.float32, device=device)
        self.capture_s = 0.0
        self._graph: Optional["torch.cuda.CUDAGraph"] = None
        self._out: Dict[str, torch.Tensor] = {}
        self._launches: tuple = ()     # (wrapper, launches a replay)

    def __call__(self, frames: torch.Tensor,
                 prev_thumbs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if frames.shape != self.frames_in.shape:
            raise ValueError(f"graphed step of {tuple(self.frames_in.shape)} frames called "
                             f"with {tuple(frames.shape)}")
        if self._failure is not None:
            raise RuntimeError(f"the graph of {tuple(self.frames_in.shape)} frames failed to "
                               f"capture; its batches are dropped") from self._failure
        self.frames_in.copy_(frames)
        if self.thumbs_in is not None:
            if prev_thumbs is None:
                self.thumbs_in.zero_()
            else:
                self.thumbs_in.copy_(prev_thumbs)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for wrapper, n in self._launches:
            wrapper.launches += n
        return {k: v.clone() for k, v in self._out.items()}

    def _capture(self) -> None:
        from ..kernels import launch_counters

        step = self._build()
        args = (self.frames_in,) if self.thumbs_in is None else (self.frames_in, self.thumbs_in)
        for _ in range(self.WARMUP_CALLS):
            step(*args)
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.frames_in.device)
        t0 = time.perf_counter()
        try:
            # thread_local: the transfer and drain threads keep copying
            # and synchronising on their own streams meanwhile.
            with torch.cuda.graph(graph, pool=self._pool(), stream=stream,
                                  capture_error_mode="thread_local"):
                out = step(*args)
        except BaseException as exc:
            # The graph is kept alive: the allocator may still hold a
            # filter that reads its capture id.
            self._failure, self._failed_graph = exc, graph
            self._on_capture_failed(exc)
            raise
        finally:
            captured = tuple((w, w.launches - b) for w, b in zip(counters, before)
                             if w.launches != b)
            for w, b in zip(counters, before):
                w.launches = b
        self.capture_s = time.perf_counter() - t0
        self._graph, self._out, self._launches = graph, dict(out), captured
        self._on_capture(self.capture_s)


def _record_after_first_success(step: Callable, record: Callable[[], None]) -> Callable:
    """``step`` that calls ``record()`` once, after its first call that
    returned: a program whose first call fails is never recorded in the
    prewarm manifest (it would fail again at every start)."""
    pending = [record]

    def recorded(*args):
        out = step(*args)
        if pending:
            pending.pop()()
        return out

    return recorded


class InferenceEngine:
    """Tick loop serving one model over every stream of a frame bus: a
    detector or classifier on each stream's newest frame, a video model on
    each stream's clip window once it is full.

    ``model``: an ``nn.Module`` already on ``device`` (e.g. with loaded
    weights); None builds the registry model with random weights at
    ``warmup``. ``device`` defaults to the card and raises without one.

    Threads: the tick thread (collect, shed, dispatch on the compute
    stream), the transfer thread (``cfg.prefetch``), and the drain thread
    (read-back and emit). A tick or a batch that fails is logged ("engine
    tick failed; continuing", "drain failed; continuing") and the engine
    serves the next one; a failed batch is dropped, never run eagerly or
    with a plain version in place of a kernel. Only a thread that cannot
    run at all (its device cannot be set) ends the engine, and ``stop()``
    raises that error.

    Interest gating: the collector infers only the streams a subscriber
    covers (``_stream_interest``), for ``cfg.active_window_s`` after the
    last one went away, and each tick touches the bus's ``last_query`` key
    of exactly those streams (``keep_streams_hot``), which keeps their
    ingest workers decoding every frame. ``serve_lockstep`` (replay) infers
    every published stream.

    On the card every step runs as the replay of the CUDA graph of its
    (model, stem, geometry, bucket) key (``_GraphedStep``), captured on the
    key's first batch or at ``start()`` (``cfg.prewarm`` and the prewarm
    manifest, ``compile_for``), with the classic stem.

    ``annotations``: the uplink queue (None: no annotations);
    ``model_resolver`` and ``annotation_policy_resolver``: the per-stream
    model and emit-policy overrides (the process manager's
    ``inference_model_of`` and ``annotation_policy_of``); ``journal``: a
    decision journal to record into (the server's, shared by the process)
    instead of one of the engine's own, with ``cfg.journal`` on.
    """

    # The stem variant of every program: the port serves the classic stem
    # only (the JAX engine's cfg.stem; ``s2d`` is not ported).
    _STEM = "classic"

    # Per-stream state of a stream absent from the bus this long is dropped;
    # shorter gaps (a producer re-creating its ring) keep it.
    _STATE_GC_GRACE_S = 10.0

    # Per-stream model failure breaker: the first retry after this long,
    # doubling per consecutive failure up to the cap.
    BAD_MODEL_BACKOFF_S = 30.0
    BAD_MODEL_BACKOFF_MAX_S = 600.0

    def __init__(self, bus: FrameBus, cfg: Optional[EngineConfig] = None, *,
                 device: "str | torch.device" = "cuda",
                 model: Optional[torch.nn.Module] = None,
                 annotations=None,
                 model_resolver: Optional[Callable[[str], str]] = None,
                 annotation_policy_resolver: Optional[Callable[[str], str]] = None,
                 journal=None):
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._cfg = cfg or EngineConfig()
        self._spec = registry.get(self._cfg.model)
        self._dtype = getattr(torch, self._cfg.dtype)
        self._model = model
        self._buckets = tuple(sorted(self._cfg.batch_buckets))
        self._bus = bus
        self._annotations = annotations
        self._model_resolver = model_resolver
        self._ann_policy_resolver = annotation_policy_resolver
        # Per-stream extra models, name -> (spec, module), built on first
        # use; the default model is (self._spec, self._model).
        self._models: Dict[str, tuple] = {}
        # The failure breaker: name -> {"failures", "retry_at" (monotonic),
        # "error"}.
        self._bad_models: Dict[str, dict] = {}
        self._collector = Collector(
            bus, buckets=self._buckets, clip_len=self._spec.clip_len,
            active_window_s=self._cfg.active_window_s, default_model=self._spec.name,
            interest_of=self._stream_interest, model_of=self._stream_model,
            strict_lease=True, alloc=_pinned_empty if self._cuda else host_empty,
        )
        self._thumbs = _ThumbPool(self._cfg.quality_thumb, self._device)
        # Step cache: (model, stem, src_hw, bucket) -> the step of that key.
        self._steps: Dict[tuple, Callable] = {}
        # The graph memory pool the captures share (the card); a failed
        # capture retires it (_GraphedStep) and the next capture opens a
        # fresh one. Every pool opened is kept for graph_stats().
        self._graph_pool = None
        self._graph_pools: list = []
        self._graphs: List[_GraphedStep] = []
        self.perf = PerfTracker()
        # Prewarm manifest (engine/aot_cache.py); "" = off. Prewarm
        # progress for prewarm_status(): with the manifest on, the program
        # set is known only once start() has read it.
        self._aot_dir = self._cfg.aot_cache_dir if self._cfg.aot_cache else ""
        self._prewarm_required = len(self._cfg.prewarm)
        self._prewarm_done = 0
        self._prewarm_started = not self._aot_dir
        self._stats: Dict[str, StreamStats] = {}
        self._subscribers: list = []
        self._sub_lock = threading.Lock()
        self._fanout_closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        # Dispatched batches wait here for the drain thread. Depth 2 is
        # double buffering; a full queue back-pressures the tick loop.
        self._drain_q: "queue.Queue[Optional[_Inflight]]" = queue.Queue(maxsize=2)
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_blocked = False
        # _emit mutates tracker state on the drain thread while the tick
        # loop forgets absent streams: one lock covers both.
        self._state_lock = threading.Lock()
        self._trackers: Dict[str, tuple] = {}        # device_id -> (model, IoUTracker)
        # Emit-policy state per stream (on_change signatures, min_interval
        # stamps), under _state_lock like the trackers.
        self._ann_state: Dict[str, dict] = {}
        self._ann_policy_warned: set = set()   # (device_id, unknown policy)
        self.annotations_suppressed = 0
        self._known: set = set()                     # streams seen on the bus
        self._absent: Dict[str, float] = {}          # device_id -> absent since
        self.ticks = 0
        self.last_tick_monotonic = 0.0
        self._last_tick_dur_s = 0.0
        # stage_trace: per-frame stage times (wall s), bounded.
        self.stage_records: deque = deque(maxlen=4096)
        self._checksum = 0
        self._pipe = PipelineStats()
        self._pipe_lock = threading.Lock()
        self._rate = _RateWindow()
        # Streams: the compute stream carries the steps and the thumbnail
        # pool, the read-back stream the drain's D2H copies (made by
        # warmup(), on the engine's device); the transfer stage owns the
        # transfer stream. Its thread runs only with cfg.prefetch.
        self._compute = self._d2h = None
        self._xfer = _PrefetchStage(self._device, self._drain_q)
        # The decision journal first, so every plane below records into
        # it; cfg.journal=False leaves it None and no plane has a hook.
        self.journal = None
        if self._cfg.journal:
            if journal is not None:
                self.journal = journal
            else:
                from ..obs.journal import DecisionJournal

                self.journal = DecisionJournal(self._cfg.journal_capacity)
        self.watchdog = Watchdog(journal=self.journal)
        # _watch_tick's state (tick thread only): the effective drain
        # depth, the step-cache misses seen and the consecutive-miss streak.
        self._bp_depth = 0
        self._miss_seen = 0.0
        self._miss_streak = 0
        self.ladder: Optional[DegradationLadder] = None
        if self._cfg.ladder:
            self.ladder = DegradationLadder(escalate_after_s=self._cfg.ladder_escalate_after_s,
                                            recover_after_s=self._cfg.ladder_recover_after_s,
                                            watchdog=self.watchdog, journal=self.journal)
        # The open shed excursion's journal seq and its frames so far.
        self._shed_seq: Optional[int] = None
        self._shed_excursion_frames = 0
        self.slo: Optional[SLOEngine] = None
        self._slo_burning = False
        self._slo_episodes = 0        # opened episodes of every SLO: the trigger watermark
        self._slo_next_eval = 0.0
        if self._cfg.slo:
            self.slo = SLOEngine(default_slos(latency_ms=self._cfg.slo_latency_ms,
                                              target_fps=self._cfg.slo_target_fps,
                                              warmup_s=self._cfg.slo_warmup_s),
                                 watchdog=self.watchdog, journal=self.journal)
        # Bounded torch.profiler captures (obs/prof.py), on demand or, with
        # cfg.prof_trigger, once per SLO episode or escalation from
        # _watch_tick. cfg.prof=False disables it (REST answers 400).
        self.prof: Optional[Profiler] = None
        if self._cfg.prof:
            self.prof = Profiler(
                self._cfg.prof_dir or os.path.join(tempfile.gettempdir(), "vep_prof"),
                retention_bytes=self._cfg.prof_retention_bytes,
                trigger=self._cfg.prof_trigger,
                trigger_ms=self._cfg.prof_trigger_ms,
                trigger_min_interval_s=self._cfg.prof_trigger_min_interval_s,
                max_ms=self._cfg.prof_max_ms,
                tracer=tracer,
                journal=self.journal,
                snapshot_fn=self._prof_snapshot,
                cuda=self._cuda,
            )
        self.quality: Optional[QualityTracker] = None
        if self._cfg.quality:
            self.quality = QualityTracker(
                black_luma=self._cfg.quality_black_luma,
                black_var=self._cfg.quality_black_var,
                freeze_diff=self._cfg.quality_freeze_diff,
                enter_s=self._cfg.quality_enter_s, exit_s=self._cfg.quality_exit_s,
                flatline_s=self._cfg.quality_flatline_s, window_s=self._cfg.quality_window_s,
                drift_threshold=self._cfg.quality_drift_threshold,
                on_transition=self._on_quality_transition,
            )
        # The canary integrity loop (cfg.quality_canary), armed by start().
        self.canary = None
        self._canary_thread: Optional[threading.Thread] = None
        self._m_batches = obs_registry.counter(
            "vep_engine_batches_total", "Device batches dispatched").labels()
        self._m_frames = obs_registry.counter(
            "vep_stream_frames_total", "Inference results per stream", ("stream",))
        self._m_latency = obs_registry.histogram(
            "vep_stream_latency_ms", "Capture to result latency per stream (ms)", ("stream",))
        self._m_shed = obs_registry.counter(
            "vep_ladder_shed_frames_total",
            "Frames shed by the degradation ladder (stale at dispatch)").labels()
        self._m_drain_depth = obs_registry.gauge(
            "vep_drain_queue_depth",
            "Dispatched batches waiting on the drain thread").labels()
        self._m_cache_miss = obs_registry.counter(
            "vep_step_cache_misses_total",
            "Serving-step cache misses (each captures a CUDA graph on the card)").labels()
        self._m_cache_hit = obs_registry.counter(
            "vep_step_cache_hits_total", "Serving-step cache hits").labels()

    # -- models ---------------------------------------------------------------

    def _thumb_side(self, spec) -> int:
        """Quality thumbnails only for frame models."""
        return 0 if spec.clip_len else self._cfg.quality_thumb

    def _model_entry(self, name: Optional[str]) -> tuple:
        """(spec, module) of the default model (None, "" or its name) or
        of a per-stream model already built."""
        if not name or name == self._spec.name:
            return self._spec, self._model
        return self._models[name]

    def _ensure_model(self, name: str) -> tuple:
        """(spec, module) of a registry model, built on first use on the
        engine's device and dtype with random weights from seed 0 (as the
        JAX engine initialises its extras from PRNGKey(0))."""
        entry = self._models.get(name)
        if entry is None:
            spec = registry.get(name)
            module = spec.init_params(torch.Generator().manual_seed(0), device=self._device,
                                      dtype=self._dtype)
            if self._cuda:
                torch.cuda.synchronize(self._device)
            entry = (spec, module)
            self._models[name] = entry
            log.info("engine loaded extra model '%s' (kind=%s)", name, spec.kind)
        return entry

    def _stream_model(self, device_id: str) -> Optional[tuple]:
        """The collector's resolver: (model name, clip_len) of a stream,
        ("none", 0) when its inference is off, None for the default model.
        A model that cannot be built falls back to the default behind the
        failure breaker (half-open after an exponential backoff)."""
        if self._model_resolver is None:
            return None
        name = self._model_resolver(device_id)
        if name == "none":
            return "none", 0
        if not name or name == self._spec.name:
            return None
        bad = self._bad_models.get(name)
        if bad is not None and time.monotonic() < bad["retry_at"]:
            return None
        try:
            spec, _ = self._ensure_model(name)
        except Exception as exc:
            failures = (bad["failures"] if bad else 0) + 1
            backoff = min(self.BAD_MODEL_BACKOFF_S * (2 ** (failures - 1)),
                          self.BAD_MODEL_BACKOFF_MAX_S)
            self._bad_models[name] = {"failures": failures,
                                      "retry_at": time.monotonic() + backoff,
                                      "error": f"{type(exc).__name__}: {exc}"}
            log.exception("stream %s model '%s' unavailable (failure %d); using default, "
                          "retrying in %.0fs", device_id, name, failures, backoff)
            return None
        if bad is not None:
            self._bad_models.pop(name, None)
            log.info("model '%s' recovered after %d failure(s)", name, bad["failures"])
        return name, spec.clip_len

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> None:
        """Build the model (random weights unless one was given) and, on
        the card, the CUDA kernels, so the first tick does not stall."""
        if self._model is None:
            self._model = self._spec.init_params(device=self._device, dtype=self._dtype)
        if self._cuda:
            from ..kernels.build import build_all

            build_all()
            # The engine's streams do not wait on the default stream: the
            # weights must be in place before the first step.
            torch.cuda.synchronize(self._device)
            if self._compute is None:
                self._compute = torch.cuda.Stream(self._device)
                self._d2h = torch.cuda.Stream(self._device)

    def _start_pipeline(self) -> None:
        """Start the transfer and drain threads (start() adds the tick
        thread)."""
        if self._drain_thread is not None:
            raise RuntimeError("engine already started")
        self.warmup()
        self._stop.clear()
        if self._cfg.prefetch:
            self._xfer.start()
        self._drain_thread = threading.Thread(target=self._drain_loop, name="vep-torch-drain",
                                              daemon=True)
        self._drain_thread.start()

    def start(self) -> None:
        """Warm up, prewarm (``cfg.prewarm`` and the manifest's programs),
        then start the threads."""
        if self._drain_thread is not None:
            raise RuntimeError("engine already started")
        self.warmup()
        self._prewarm()
        self._start_pipeline()
        self._thread = threading.Thread(target=self._loop, name="vep-torch-engine", daemon=True)
        self._thread.start()
        if self.quality is not None and self._cfg.quality_canary:
            try:
                self._start_canary()
            except Exception:
                log.exception("canary start failed; integrity loop disabled")

    def _prewarm(self) -> None:
        """Build the program of every ``cfg.prewarm`` entry and, with the
        prewarm manifest on, of every program it records (the union, each
        once). An entry whose bucket the engine does not serve is skipped,
        and one that fails is logged: both count as done, so that
        ``prewarm_status`` reaches ``complete``."""
        entries = [list(g) for g in self._cfg.prewarm]
        if self._aot_dir:
            def entry_key(e):
                try:
                    return (int(e[0]), int(e[1]), int(e[2]),
                            str(e[3]) if len(e) >= 4 and e[3] else "")
                except (TypeError, ValueError, IndexError):
                    return None

            seen = {k for k in (entry_key(e) for e in entries) if k}
            programs = aot_cache.load_manifest(self._aot_dir) or []
            for entry in aot_cache.prewarm_entries(programs):
                key = entry_key(entry)
                if key is not None and key not in seen:
                    seen.add(key)
                    entries.append(entry)
            if programs:
                log.info("prewarm manifest: %d recorded programs, %d prewarm entries in all",
                         len(programs), len(entries))
        self._prewarm_required = len(entries)
        self._prewarm_done = 0
        self._prewarm_started = True     # the entry list is final
        for geom in entries:
            # [h, w, bucket], [h, w, bucket, model] or [h, w, bucket, model, stem]
            try:
                model = str(geom[3]) if len(geom) >= 4 else None
                stem = str(geom[4]) if len(geom) >= 5 else None
                h, w, bucket = (int(v) for v in geom[:3])
                if bucket not in self._buckets:
                    log.warning("prewarm bucket %d not in the engine's buckets %s; skipping",
                                bucket, self._buckets)
                    continue
                log.info("prewarming the program of %dx%d bucket=%d model=%s", h, w, bucket,
                         model or self._spec.name)
                self.compile_for((h, w), bucket, model, stem=stem)
            except Exception:   # a bad entry must not stop the start
                log.exception("prewarm entry %r failed; continuing", geom)
            finally:
                self._prewarm_done += 1

    def prewarm_status(self) -> dict:
        """Prewarm progress, as the JAX engine reports it: ``required``
        entries, ``done`` (skipped and failed ones included), ``complete``
        and whether the manifest is on. With the manifest on, ``complete``
        stays False until start() has read it."""
        required = self._prewarm_required
        done = self._prewarm_done
        return {
            "required": required,
            "done": done,
            "complete": self._prewarm_started and done >= required,
            "aot_cache": bool(self._aot_dir),
        }

    def compile_for(self, src_hw: tuple, bucket: int, model: Optional[str] = None, *,
                    stem: Optional[str] = None) -> None:
        """Build the program of one (source geometry, bucket) ahead of its
        first batch: on the card, capture its graph by running it once over
        zero frames. ``model``: a registry model other than the default
        (a per-stream model, built here if it is not yet). An entry pinned
        to another stem is skipped with a warning."""
        if stem is not None and stem != self._STEM:
            log.warning("prewarm entry pinned stem=%r but the engine serves stem=%r; "
                        "skipping %sx%s bucket=%d", stem, self._STEM, src_hw[0], src_hw[1],
                        bucket)
            return
        self.warmup()
        if model and model != self._spec.name:
            self._ensure_model(model)
        spec, _ = self._model_entry(model)
        thumb = self._thumb_side(spec)
        shape = ((bucket,) + ((spec.clip_len,) if spec.clip_len else ())
                 + tuple(src_hw) + (3,))
        with self._compute_stream(), torch.inference_mode():
            args = [torch.zeros(shape, dtype=torch.uint8, device=self._device)]
            if thumb:
                args.append(torch.zeros((bucket, thumb, thumb),
                                        dtype=torch.float32, device=self._device))
            self._step(src_hw, bucket, spec.name)(*args)

    def graph_stats(self) -> dict:
        """The captured graphs: how many, their capture seconds in all, and
        the bytes of the engine's graph memory pool (None on the CPU)."""
        graphs = [g for g in self._graphs if g.capture_s > 0.0]
        pool_bytes = None
        if self._cuda and self._graph_pools:
            pools = {tuple(p) for p in self._graph_pools}
            pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                             if tuple(seg.get("segment_pool_id", ())) in pools)
        return {"programs": len(graphs), "capture_s": sum(s.capture_s for s in graphs),
                "pools": len(self._graph_pools), "pool_bytes": pool_bytes}

    def _current_graph_pool(self) -> tuple:
        """The pool the next capture records into, opened on first use."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_pools.append(self._graph_pool)
        return self._graph_pool

    def _retire_graph_pool(self, exc: BaseException) -> None:
        """A capture failed: torch's allocator may still be recording into
        the pool, so no later capture uses it."""
        log.warning("graph capture failed; its pool is retired and later captures get a "
                    "fresh one: %r", exc)
        self._graph_pool = None

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the threads and end every subscription; everything already
        dispatched is drained first. Raises the error of a thread that could
        not run (``_fail``); failed ticks and batches were logged, not
        raised."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("engine loop did not stop")
            self._thread = None
        if self._canary_thread is not None:
            self._canary_thread.join(timeout)
            self._canary_thread = None
        self._xfer.stop()
        if self._drain_thread is not None:
            try:
                self._drain_q.put(None, timeout=timeout)
            except queue.Full:
                log.warning("drain queue full at stop; abandoning the drain thread")
            self._drain_thread.join(timeout)
            if self._drain_thread.is_alive():
                raise RuntimeError("drain thread did not stop")
            self._drain_thread = None
        with self._sub_lock:
            self._fanout_closed = True
            for q, _ in self._subscribers:
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass    # the reader sees the stop flag on its next wait
        if self._errors:
            raise RuntimeError("engine failed") from self._errors[0]

    def _fail(self, exc: BaseException) -> None:
        """A thread that cannot go on (it could not set its device, or a
        non-Exception such as SystemExit reached its boundary): record the
        error and end the engine. A failed tick or batch does not come
        here."""
        log.error("engine thread failed", exc_info=exc)
        self._errors.append(exc)
        self._stop.set()

    def health(self) -> dict:
        """Liveness: every thread alive and a tick completed within
        ``health_stale_after_s``."""
        age = time.monotonic() - self.last_tick_monotonic if self.last_tick_monotonic else None
        out = {
            "engine_thread_alive": self._thread is not None and self._thread.is_alive(),
            "drain_thread_alive": (self._drain_thread is not None
                                   and self._drain_thread.is_alive()),
            "xfer_thread_alive": self._xfer.alive(),
            "last_tick_age_s": age,
            "ladder": self.ladder.rung if self.ladder is not None else "normal",
            "error": repr(self._errors[0]) if self._errors else None,
            # Per-stream models behind the failure breaker (informational:
            # their streams serve the default model meanwhile).
            "disabled_models": {
                name: {"failures": bad["failures"],
                       "retry_in_s": round(max(0.0, bad["retry_at"] - time.monotonic()), 1),
                       "error": bad["error"]}
                for name, bad in list(self._bad_models.items())},
        }
        out["ok"] = (out["engine_thread_alive"] and out["drain_thread_alive"]
                     and (not self._cfg.prefetch or out["xfer_thread_alive"])
                     and age is not None and age <= self._cfg.health_stale_after_s
                     and not self._errors)
        return out

    # -- profiling -------------------------------------------------------

    def _prof_snapshot(self) -> dict:
        """Engine state frozen into every capture bundle (obs/prof.py): the
        numbers that were true while the trace ran. ``perf`` holds the
        compile records; MFU and the programs' FLOPs are not ported."""
        snap = {"ticks": self.ticks, "batches": self.pipeline_stats().batches,
                "perf": self.perf.snapshot()}
        if self.slo is not None:
            snap["slo"] = self.slo.snapshot()
        if self.ladder is not None:
            snap["rung"] = self.ladder.rung
        return snap

    def start_profile(self, log_dir: str) -> None:
        """Begin an unbounded torch.profiler trace (``self.prof.start``;
        it shares one busy flag with the bounded captures)."""
        if self.prof is None:
            raise RuntimeError("profiling disabled (engine.prof=False)")
        self.prof.start(log_dir)

    def stop_profile(self) -> None:
        """Stop the trace begun by :meth:`start_profile`."""
        if self.prof is None:
            raise RuntimeError("profiling disabled (engine.prof=False)")
        self.prof.stop()

    # -- the canary integrity loop (obs/quality.py) -------------------------

    def _start_canary(self) -> None:
        """Arm the canary loop: an engine-owned publisher replays the
        golden trace (cfg.quality_canary) into the bus at low cadence under
        cfg.quality_canary_stream, and the drain folds each emitted slot's
        host checksum into the CanaryChecker, which compares once a trace
        loop. The canary rides the whole serving path (bus, collector,
        graphed step, keep mask, drain), so a numerics regression anywhere
        on it moves the fold and fires the ``canary_integrity`` SLO and
        watchdog episode."""
        from ..obs.quality import CanaryChecker
        from ..obs.slo import BurnRateSLO, integrity_slo
        from ..replay.player import TracePlayer

        player = TracePlayer(self._cfg.quality_canary)
        if not player.devices:
            raise ValueError(f"canary trace {self._cfg.quality_canary!r} has no streams")
        events = player.frame_events(player.devices[0])
        if not events:
            raise ValueError(f"canary trace {self._cfg.quality_canary!r} has no frames")
        slo = None
        if self.slo is not None:
            slo = self.slo.add(BurnRateSLO(integrity_slo(warmup_s=self._cfg.slo_warmup_s)))
        self.canary = CanaryChecker(
            loop_len=len(events), stream=self._cfg.quality_canary_stream,
            golden=self._cfg.quality_canary_golden or None, watchdog=self.watchdog, slo=slo)
        self._canary_thread = threading.Thread(target=self._canary_loop, args=(events,),
                                               name="vep-torch-canary", daemon=True)
        self._canary_thread.start()

    def _canary_loop(self, events: list) -> None:
        """The golden-replay publisher (its own thread): frames enter
        through the bus like any camera's, with the recorded packet index
        (``meta_for``) and a fresh capture stamp. A publish failure is
        logged once per run of failures and skipped: the checker voids an
        incomplete cycle, so a dropped canary frame never reads as a
        mismatch."""
        from ..replay.player import meta_for
        from ..replay.trace import decode_frame

        name = self._cfg.quality_canary_stream
        period = 1.0 / max(self._cfg.quality_canary_fps, 0.1)
        frame0 = decode_frame(events[0])
        i = 0
        alive = False
        warned = False
        while not self._stop.wait(period):
            ev = events[i % len(events)]
            i += 1
            try:
                if not alive:
                    self._bus.create_stream(name, frame0.nbytes)
                    alive = True
                frame = decode_frame(ev)
                self._bus.publish(name, frame,
                                  meta_for(ev, frame, timestamp_ms=int(time.time() * 1000)))
                warned = False
            except Exception as exc:
                alive = False
                if not warned:
                    log.warning("canary publish failed: %s", exc)
                    warned = True

    # -- consumers ---------------------------------------------------------

    def _stream_interest(self, device_id: str) -> bool:
        """Does anything consume this stream's results now: the canary's
        checker (its stream, while the loop is armed), the annotation
        uplink (standing interest in every stream: the engine feeds the
        cloud what the reference's clients fed it), else a live subscriber
        that covers it. With none, inferring would compute results nobody
        reads, and the collector gates the stream out."""
        if self.canary is not None and device_id == self.canary.stream:
            return True
        if self._annotations is not None:
            return True
        with self._sub_lock:
            return any(ids is None or device_id in ids for _, ids in self._subscribers)

    def subscribe(self, device_ids=None, context=None, timeout: float = 0.5):
        """Iterator of InferenceResult for ``device_ids`` (None = all). The
        subscription starts when this is called, and from the next tick on
        the streams it covers are of interest; the iterator ends when the
        engine stops or ``context.is_active()`` turns false (a gRPC
        context, or anything with that method)."""
        q: queue.Queue = queue.Queue(maxsize=256)
        ids = set(device_ids) if device_ids else None
        with self._sub_lock:
            self._subscribers.append((q, ids))
        return self._drain_subscription(q, timeout, context)

    def _drain_subscription(self, q: queue.Queue, timeout: float, context=None):
        try:
            while True:
                if context is not None and not context.is_active():
                    return
                try:
                    item = q.get(timeout=timeout)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                if item is None:
                    return
                yield item
        finally:
            with self._sub_lock:
                self._subscribers = [(sq, si) for sq, si in self._subscribers if sq is not q]

    def stats(self) -> Dict[str, StreamStatsView]:
        """Per-stream snapshot copies."""
        return {d: StreamStatsView(st.frames, st.last_latency_ms, st.ema_latency_ms,
                                   st.last_batch, st.padded_slots, st.device_ms_ema)
                for d, st in list(self._stats.items())}

    def pipeline_stats(self) -> PipelineStats:
        """A copy of the engine-wide totals."""
        with self._pipe_lock:
            return PipelineStats(**vars(self._pipe))

    @property
    def checksum(self) -> int:
        """Running fold of ``host_slot_checksum`` over every emitted
        detection slot, mod 2^31: a sum, so it does not depend on the order
        the slots were emitted in. Two runs that serve the same frames in
        the same batches fold to the same value."""
        return self._checksum

    def serve_lockstep(self, ticks: Iterable[Sequence[tuple]]) -> int:
        """Serve recorded ticks in lockstep on the calling thread (replay):
        each tick's ``(device_id, frame, meta)`` are published (a stream is
        created on first sight), then one collect and dispatch. With
        ``cfg.prefetch`` the batches cross the transfer and drain threads
        as in serving; without it they are placed and drained here. No
        ladder, shedding or SLO tick runs, so with one frame a stream a
        tick every published frame is served once. Returns ``checksum``
        once everything is emitted; the threads it started are stopped
        (``stop()`` raises their errors). A failed batch raises: a replay
        does not log and go on."""
        if self._thread is not None:
            raise RuntimeError("serve_lockstep needs an engine not started")
        self.warmup()
        self._prewarm()
        prefetch = self._cfg.prefetch
        if prefetch:
            self._start_pipeline()
        created = set(self._bus.streams())
        try:
            with self._compute_stream(), torch.inference_mode():
                for tick in ticks:
                    for device_id, frame, meta in tick:
                        if device_id not in created:
                            self._bus.create_stream(device_id, frame.nbytes)
                            created.add(device_id)
                        self._bus.publish(device_id, frame, meta)
                    # Ungated: replay infers every published stream.
                    groups = self._collector.collect(
                        device_ids=self._collector.active_streams())
                    if prefetch:
                        self._dispatch(groups, strict=True)
                        continue
                    for group in groups:
                        self._dispatch([group], strict=True)
                        inflight = self._drain_q.get_nowait()
                        try:
                            self._emit(inflight)
                        finally:
                            self._collector.release(inflight.group)
                            self._drain_q.task_done()
            if prefetch:
                self._drain_q.join()
        finally:
            if prefetch:
                self.stop()
        return self.checksum

    # -- tick loop ---------------------------------------------------------

    def _loop(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            with self._compute_stream(), torch.inference_mode():
                self._serve_ticks()
        except BaseException as exc:  # the thread cannot go on: record, end
            self._fail(exc)

    def _serve_ticks(self) -> None:
        """The tick loop. It outlives any bad tick or batch: a failure is
        logged and the next tick serves, as in the JAX engine."""
        tick_s = self._cfg.tick_ms / 1000.0
        inferred: List[str] = []
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                inferred = self._tick(tick_s)
            except Exception:
                if self._stop.is_set():
                    # A shutdown race (a prefetched placement abandoned
                    # mid-dispatch) is not an error.
                    log.info("engine tick aborted by shutdown")
                else:
                    log.exception("engine tick failed; continuing")
            self.ticks += 1
            self.last_tick_monotonic = time.monotonic()
            # The ladder's staleness signal: the work phase, not the
            # assembly window that absorbs the rest of the budget.
            self._last_tick_dur_s = self.last_tick_monotonic - t0
            try:
                self._watch_tick(inferred)
                self._collector.assemble_until(t0 + tick_s, device_ids=inferred,
                                               stop_event=self._stop)
            except Exception:
                log.exception("window assembly failed; continuing")
                elapsed = time.monotonic() - t0
                if elapsed < tick_s:
                    self._stop.wait(tick_s - elapsed)

    def _compute_stream(self):
        return torch.cuda.stream(self._compute) if self._cuda else contextlib.nullcontext()

    def _tick(self, tick_s: float) -> List[str]:
        """One tick: ladder, one bus enumeration (``partition``: the present
        streams and the inferred subset), the ``admission_pause`` subset of
        the inferred, keep-hot of exactly what is inferred, collect, shed,
        dispatch, forget absent streams. Returns the streams inferred."""
        # With prefetch the depth-2 drain queue is full in healthy saturated
        # serving; only a handoff that had to block counts as backpressure.
        depth = self._drain_q.qsize()
        if self._cfg.prefetch and not self._drain_blocked:
            depth = min(depth, 1)
        self._drain_blocked = False
        self._bp_depth = depth
        rung = "normal"
        if self.ladder is not None:
            rung = self.ladder.observe(
                queue_depth=depth, tick_lag_s=self._last_tick_dur_s, tick_budget_s=tick_s,
                slo_burning=self._slo_burning and self._cfg.slo_ladder)
            self._apply_rung_cap(rung)
        if rung == "normal" and self._shed_seq is not None:
            # The shed excursion closes when the ladder recovers (journaled
            # on the edge, never per tick).
            self._close_shed_excursion()
        present, inferred = self._collector.partition()
        if rung == "admission_pause":
            # Only the admitted half competes for the device; the paused
            # half's workers stop decoding too (keep-hot skips them).
            # Quality-unhealthy streams pause first; the canary never
            # pauses (the integrity probe matters most under degradation).
            dep = (self.quality.unhealthy() if self.quality is not None
                   and self._cfg.quality_ladder else frozenset())
            canary = self.canary.stream if self.canary is not None else None
            if canary is not None:
                dep = dep - {canary}
            admitted = admitted_streams(inferred, dep)
            if canary is not None and canary in inferred and canary not in admitted:
                admitted.append(canary)
            inferred = admitted
        # Keep-hot before collect, for the inferred set only: the workers'
        # decode gates follow what is inferred, and do not flap.
        self._collector.keep_streams_hot(device_ids=inferred)
        groups = self._collector.collect(device_ids=inferred)
        t_collect = time.time()
        if rung != "normal" and groups:
            groups = self._shed_stale_groups(groups)
        self._dispatch(groups, t_collect)
        self._forget_absent(present)
        return inferred

    def _apply_rung_cap(self, rung: str) -> None:
        """``bucket_downshift`` and above hide the largest bucket, so new
        batches run the next smaller program; below it the cap clears."""
        cap = None
        if RUNGS.index(rung) >= RUNGS.index("bucket_downshift") and len(self._buckets) > 1:
            cap = self._buckets[-2]
        self._collector.set_bucket_cap(cap)

    def _shed_stale_groups(self, groups: List[BatchGroup]) -> List[BatchGroup]:
        """Rung ``shed``: drop stale frames (see shed_stale); fully stale
        groups return their lease here."""
        now_ms = time.time() * 1000.0
        out: List[BatchGroup] = []
        tick_shed = 0
        for group in groups:
            kept, shed = shed_stale(group, now_ms, self._cfg.shed_staleness_ms, self._buckets)
            if shed:
                with self._pipe_lock:
                    self._pipe.shed_frames += shed
                self._m_shed.inc(shed)
                tick_shed += shed
            if kept is None:
                self._collector.release(group)
            else:
                out.append(kept)
        # One shed excursion event per degraded episode: opened on the
        # first frame actually dropped, caused by the ladder transition
        # that engaged shedding, closed when the ladder recovers (_tick).
        if tick_shed and self.journal is not None:
            if self._shed_seq is None:
                self._shed_seq = self.journal.record(
                    "engine", "shed_open", subject=("engine", "dispatch"),
                    trigger={"frames": tick_shed, "staleness_ms": self._cfg.shed_staleness_ms},
                    cause=(self.ladder.last_transition_seq if self.ladder is not None
                           else None))
                self._shed_excursion_frames = 0
            self._shed_excursion_frames += tick_shed
        return out

    def _close_shed_excursion(self) -> None:
        """Close the open shed excursion (the ladder is back at normal)."""
        if self.journal is not None and self._shed_seq is not None:
            self.journal.record("engine", "shed_close", subject=("engine", "dispatch"),
                                trigger={"frames": self._shed_excursion_frames},
                                cause=self._shed_seq)
        self._shed_seq = None
        self._shed_excursion_frames = 0

    def _forget_absent(self, present: Sequence[str]) -> None:
        """Drop the collector's cursor, geometry and clip window and the
        tracker, thumbnail and quality state of streams gone from the bus
        longer than the grace period (a producer re-creating its ring must
        not reset its stream's track ids)."""
        now = time.monotonic()
        present = set(present)
        self._known |= present
        for d in present.intersection(self._absent):
            del self._absent[d]
        for d in self._known - present:
            since = self._absent.setdefault(d, now)
            if now - since <= self._STATE_GC_GRACE_S:
                continue
            self._collector.drop_stream(d)
            with self._state_lock:
                self._trackers.pop(d, None)
                self._ann_state.pop(d, None)
                self._thumbs.pop(d)
                if self.quality is not None:
                    self.quality.forget(d)
            self._known.discard(d)
            del self._absent[d]

    def _watch_tick(self, inferred: Sequence[str] = ()) -> None:
        """Per-tick checks (obs/watch.py), each logged once per episode:
        drain backpressure and a recompile storm (a step-cache miss on 3+
        consecutive ticks: shapes churning faster than the cache warms).
        Then the SLO samples and the throttled evaluation, and the
        profiler's trigger poll (one capture per new SLO episode or
        escalation, rate-limited, on its own thread; idle: compares under
        a lock)."""
        self._m_drain_depth.set(self._drain_q.qsize())
        self.watchdog.check("drain_backpressure", self._bp_depth, above=1,
                            detail="device slower than the tick loop (double buffer full)")
        misses = self._m_cache_miss.value
        self._miss_streak = self._miss_streak + 1 if misses > self._miss_seen else 0
        self._miss_seen = misses
        self.watchdog.check("recompile_storm", self._miss_streak, above=2,
                            detail="step-cache miss on 3+ consecutive ticks (shape churn)")
        if self.slo is not None:
            self._slo_tick(inferred)
        if self.prof is not None:
            rung_idx = self.ladder.rung_index if self.ladder is not None else 0
            self.prof.poll(episodes=self._slo_episodes, rung=rung_idx,
                           context={"slo_episode": self._slo_episodes or None,
                                    "slo_burning": self._slo_burning,
                                    "rung": RUNGS[rung_idx]})

    def _slo_tick(self, inferred: Sequence[str]) -> None:
        """Per-tick fps and availability samples (only while streams are
        inferred) and the throttled SLO evaluation."""
        now = time.monotonic()
        if inferred:
            if self._cfg.slo_target_fps > 0:
                good = self._rate.fps() >= self._cfg.slo_target_fps
                self.slo.get("aggregate_fps").record(good=float(good), bad=float(not good))
            avail = self.slo.get("stream_availability")
            for device_id in inferred:
                st = self._stats.get(device_id)
                if st is None or not st.last_emit_mono:
                    continue   # never served yet: boot grace, not an SLI
                ok = now - st.last_emit_mono <= self._cfg.slo_availability_window_s
                avail.record(good=float(ok), bad=float(not ok))
        if now >= self._slo_next_eval:
            self._slo_next_eval = now + self._cfg.slo_eval_interval_s
            verdict = self.slo.evaluate()
            self._slo_burning = verdict["burning"]
            # Episodes opened by every SLO: the profiler's trigger watermark.
            self._slo_episodes = sum(st["episodes"] for st in verdict["slos"].values())

    def _step(self, src_hw: tuple, bucket: int, model: Optional[str] = None) -> Callable:
        """The step of (``model``, default: the engine's; its stem,
        ``src_hw``, ``bucket``): on the card a ``_GraphedStep``, captured
        at its first call; on the CPU the eager step. A new key records its
        program in the prewarm manifest after its first call that
        returns."""
        src_hw = tuple(int(v) for v in src_hw)
        spec, module = self._model_entry(model)
        name = spec.name
        thumb = self._thumb_side(spec)
        key = (name, self._STEM, src_hw, bucket)
        fn = self._steps.get(key)
        if fn is not None:
            self._m_cache_hit.inc()
            return fn
        self._m_cache_miss.inc()
        build = functools.partial(build_serving_step, module, spec, quality_thumb=thumb)
        if self._cuda:
            shape = ((bucket,) + ((spec.clip_len,) if spec.clip_len else ()) + src_hw + (3,))
            fn = _GraphedStep(
                build, shape, (thumb, thumb) if thumb else None,
                device=self._device, pool=self._current_graph_pool,
                on_capture=functools.partial(self.perf.note_compile, name, src_hw, bucket),
                on_capture_failed=self._retire_graph_pool)
            self._graphs.append(fn)
        else:
            fn = build()
        if self._aot_dir:
            fn = _record_after_first_success(fn, functools.partial(
                aot_cache.record_program, self._aot_dir, model=name, stem=self._STEM,
                src_hw=src_hw, bucket=bucket))
        self._steps[key] = fn
        return fn

    # -- placement, dispatch ---------------------------------------------------

    def _dispatch(self, groups: List[BatchGroup], t_collect: Optional[float] = None, *,
                  strict: bool = False) -> None:
        """Place and run each group, then hand it to the drain thread. With
        the transfer stage the placements of groups g + 1 and g + 2 run
        while group g is dispatched. A group that fails returns its lease,
        after its placement (which may still read the host buffer) has
        resolved, is logged with the tick's words ("engine tick failed;
        continuing") and dropped, and the next group is dispatched: one
        failing key does not starve the keys that sort after it. When the
        engine stops (or ``strict``, or on a ``BaseException``) every group
        not yet handed to the drain thread returns its lease and the error
        is raised."""
        if t_collect is None:
            t_collect = time.time()
        handles: List[Optional[_Prefetched]] = []

        def top_up(upto: int) -> None:
            while len(handles) < min(len(groups), upto):
                handles.append(self._xfer.submit(groups[len(handles)], self._stop))

        prefetch = self._cfg.prefetch
        if prefetch and groups:
            top_up(_PrefetchStage.DEPTH)
        for gi, group in enumerate(groups):
            try:
                step = self._step(group.src_hw, group.bucket, group.model)
                if prefetch:
                    top_up(gi + 1 + _PrefetchStage.DEPTH)
                    pre = handles[gi]
                    if pre is None:
                        raise _Stopping("engine stopping; prefetch submission aborted")
                    while not pre.ready.wait(timeout=0.1):
                        if self._stop.is_set():
                            raise _Stopping("engine stopping; placement abandoned")
                    if pre.error is not None:
                        raise pre.error
                    placed, event = pre.placed, pre.event
                    h2d_ms, overlapped_ms = pre.transfer_ms, pre.overlapped_ms
                else:
                    placed, event, h2d_ms = self._xfer.place(group.frames)
                    overlapped_ms = 0.0
                inflight = self._run_step(step, group, placed, event, t_collect)
            except BaseException as exc:
                fatal = (strict or self._stop.is_set() or isinstance(exc, _Stopping)
                         or not isinstance(exc, Exception))
                for gj in range(gi, len(groups) if fatal else gi + 1):
                    if gj < len(handles) and handles[gj] is not None:
                        handles[gj].ready.wait(timeout=5.0)
                    self._collector.release(groups[gj])
                    if tracer.enabled:
                        self._record_dropped(groups[gj], "dispatch_error")
                if fatal:
                    raise
                log.exception("engine tick failed; continuing")
                continue
            with self._pipe_lock:
                self._pipe.batches += 1
                self._pipe.h2d_ms += h2d_ms
                self._pipe.h2d_overlapped_ms += overlapped_ms
            self._m_batches.inc()
            if tracer.enabled:
                for did, meta in zip(group.device_ids, group.metas):
                    if tracer.sampled(meta.packet):
                        tracer.record(did, "submit", meta.packet, ts=inflight.t_submit,
                                      bucket=group.bucket, trace_id=trace_id_of(meta, did))
            self._enqueue_drain(inflight)

    @staticmethod
    def _record_dropped(group: BatchGroup, reason: str) -> None:
        """Close the sampled lineages of a group that leaves without a
        result (a ``dropped`` span)."""
        for did, m in zip(group.device_ids, group.metas):
            if tracer.sampled(m.packet):
                tracer.record(did, "dropped", m.packet, reason=reason,
                              trace_id=trace_id_of(m, did))

    def _run_step(self, step: Callable, group: BatchGroup, placed: torch.Tensor, event,
                  t_collect: float) -> _Inflight:
        """Queue one step on the compute stream after its input's copy."""
        start = done = None
        if self._cuda:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            # The placed tensor was allocated on the transfer stream: its
            # memory must not be reused before the step has read it.
            placed.record_stream(stream)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        if self._thumb_side(self._model_entry(group.model)[0]):
            outputs = dict(step(placed, self._thumbs.gather(group.device_ids, group.bucket)))
            self._thumbs.scatter(group.device_ids, outputs.pop("quality_thumbs"))
        else:
            outputs = dict(step(placed))
        if self._cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record(stream)
        return _Inflight(group, outputs, t_collect, time.time(), start, done)

    def _enqueue_drain(self, inflight: _Inflight) -> None:
        """Hand a dispatched batch to the drain thread; blocks (in short
        interruptible slices) while two are queued. On shutdown while full,
        the batch's result is dropped and its lease returned."""
        try:
            self._drain_q.put_nowait(inflight)
            return
        except queue.Full:
            self._drain_blocked = True   # the ladder's backpressure signal
        while not self._stop.is_set():
            try:
                self._drain_q.put(inflight, timeout=0.1)
                return
            except queue.Full:
                continue
        if tracer.enabled:
            self._record_dropped(inflight.group, "shutdown_drain")
        self._collector.release(inflight.group)

    # -- drain and emit -----------------------------------------------------------

    def _drain_loop(self) -> None:
        """Read back the oldest dispatched batch as soon as its step is done
        and emit its results. A batch that fails to emit is logged and its
        lease returned; the next batch is emitted."""
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            while True:
                inflight = self._drain_q.get()
                if inflight is None:
                    self._drain_q.task_done()
                    return
                try:
                    self._emit(inflight)
                except Exception:
                    log.exception("drain failed; continuing")
                finally:
                    self._collector.release(inflight.group)
                    inflight.outputs = None
                    self._drain_q.task_done()
        except BaseException as exc:  # the thread cannot go on: record, end
            self._fail(exc)

    def _read_back(self, inflight: _Inflight) -> Dict[str, np.ndarray]:
        """The step's outputs on the host. On the card the copies run on the
        read-back stream after the step's done event, so they neither race
        the step nor queue behind later steps."""
        if not self._cuda:
            return {k: v.numpy() for k, v in inflight.outputs.items()}
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(inflight.done)
            host = {}
            for k, v in inflight.outputs.items():
                v.record_stream(self._d2h)
                host[k] = v.to("cpu").numpy()
        return host

    def _emit(self, inflight: _Inflight) -> None:
        group = inflight.group
        t_drain0 = time.time()
        host = self._read_back(inflight)
        t_drained = time.time()
        if self._cuda:
            device_ms = inflight.start.elapsed_time(inflight.done)
        else:
            device_ms = (t_drained - inflight.t_submit) * 1000.0
        now_ms = int(t_drained * 1000)
        spec, module = self._model_entry(group.model)
        kind = spec.kind
        num_classes = module.cfg.num_classes
        slo_latency = (self.slo.get("detect_latency_p50")
                       if self.slo is not None and kind == "detect" else None)
        capture_sum = 0.0
        track_s = 0.0
        for i, (device_id, meta) in enumerate(zip(group.device_ids, group.metas)):
            detections = to_detections(host, i, kind, num_classes)
            if self._cfg.track and kind == "detect":
                # Empty frames too: misses must accumulate so stale tracks
                # expire.
                t_track = time.perf_counter()
                self._assign_tracks(device_id, spec.name, detections)
                track_s += time.perf_counter() - t_track
            if self.quality is not None:
                self._observe_quality(host, i, device_id, meta, detections)
            latency = max(0.0, now_ms - meta.timestamp_ms) if meta.timestamp_ms else 0.0
            if meta.timestamp_ms:
                capture_sum += inflight.t_collect * 1000.0 - meta.timestamp_ms
            self._publish(InferenceResult(
                device_id=device_id, timestamp=meta.timestamp_ms, model=spec.name,
                detections=detections, latency_ms=latency, batch_size=group.bucket,
                frame_packet=meta.packet, trace_id=meta.trace_id, parent_span=meta.parent_span,
            ))
            self._annotate(device_id, meta, detections, spec)
            if kind == "detect":
                self._checksum = (self._checksum + host_slot_checksum(host, i)) & CHECKSUM_MASK
            st = self._stats.setdefault(device_id, StreamStats())
            st.frames += 1
            st.note_latency(latency)
            st.last_batch = group.bucket
            st.note_device(device_ms, group.padded_slots)
            st.last_emit_mono = time.monotonic()
            if slo_latency is not None and meta.timestamp_ms:
                ok = latency <= self._cfg.slo_latency_ms
                slo_latency.record(good=float(ok), bad=float(not ok))
            self._m_frames.labels(device_id).inc()
            self._m_latency.labels(device_id).observe(latency)
            if self._cfg.stage_trace:
                self.stage_records.append({
                    "device_id": device_id, "ts_pub_ms": meta.timestamp_ms,
                    "t_collect": inflight.t_collect, "t_submit": inflight.t_submit,
                    "t_drain0": t_drain0, "t_drained": t_drained, "t_emitted": time.time(),
                    "bucket": group.bucket})
            if tracer.sampled(meta.packet):
                tid = trace_id_of(meta, device_id)
                tracer.record(device_id, "device", meta.packet, ts=t_drained,
                              dur_ms=device_ms, bucket=group.bucket, trace_id=tid)
                tracer.record(device_id, "emit", meta.packet, trace_id=tid)
        n = len(group.device_ids)
        self._rate.note(n)
        t_emitted = time.time()
        with self._pipe_lock:
            p = self._pipe
            p.frames += n
            p.device_ms += device_ms if self._cuda else 0.0
            p.capture_to_collect_ms += capture_sum
            p.collect_to_submit_ms += n * (inflight.t_submit - inflight.t_collect) * 1000.0
            p.submit_to_drained_ms += n * (t_drained - inflight.t_submit) * 1000.0
            p.drained_to_emitted_ms += n * (t_emitted - t_drained) * 1000.0
            p.emit_ms += (t_emitted - t_drained) * 1000.0
            p.track_ms += track_s * 1000.0

    def _assign_tracks(self, device_id: str, model: str, detections: List[Detection]) -> None:
        """Per-stream SORT-style association (engine/tracker.py) filling
        Detection.track_id. The tracker resets when the stream's model
        changes (class ids of two models are two vocabularies), and the new
        one continues the old one's numbering."""
        with self._state_lock:
            entry = self._trackers.get(device_id)
            if entry is None or entry[0] != model:
                first = entry[1].next_id if entry else 1
                entry = (model, IoUTracker(next_id=first))
                self._trackers[device_id] = entry
            ids = entry[1].update(
                [(d.box.left, d.box.top, d.box.left + d.box.width, d.box.top + d.box.height)
                 for d in detections],
                [d.class_id for d in detections],
                scores=[d.confidence for d in detections],
            )
        for det, tid in zip(detections, ids):
            det.track_id = tid

    def _observe_quality(self, host: Dict[str, np.ndarray], i: int, device_id: str, meta,
                         detections: List[Detection]) -> None:
        """Fold one emitted slot into the quality plane: the step's frame
        statistics, when it carried them, and the detection set; a canary
        slot's host checksum goes to the integrity checker."""
        kwargs = {}
        qs = host.get("quality_stats")
        if qs is not None:
            kwargs = {"luma_mean": float(qs[i, 0]), "luma_var": float(qs[i, 1]),
                      "diff_energy": float(qs[i, 2])}
        self.quality.observe(device_id, classes=[d.class_id for d in detections],
                             scores=[d.confidence for d in detections], **kwargs)
        if (self.canary is not None and device_id == self.canary.stream
                and "boxes" in host):
            self.canary.note(meta.packet, host_slot_checksum(host, i))

    # -- the annotation uplink --------------------------------------------------

    def _annotate(self, device_id: str, meta, detections: Sequence[Detection], spec=None) -> None:
        """One emitted frame's detections -> AnnotateRequest wire bytes on
        the uplink queue, when the stream's emit policy lets them through
        (the rest count in ``annotations_suppressed``)."""
        if self._annotations is None:
            return
        spec = spec or self._spec
        eligible = [d for d in detections if d.confidence > 0.0 and d.class_id >= 0]
        if not self._should_annotate(device_id, meta, eligible):
            self.annotations_suppressed += len(eligible)
            return
        detect = spec.kind == "detect"
        for det in eligible:
            req = AnnotateRequest(
                device_name=device_id,
                type="detection" if detect else spec.kind,
                start_timestamp=meta.timestamp_ms or int(time.time() * 1000),
                object_type=det.class_name,
                object_tracking_id=det.track_id,
                confidence=det.confidence,
                # A detector's results carry a box, a classifier's none.
                object_bouding_box=(AnnotationBox(top=det.box.top, left=det.box.left,
                                                  width=det.box.width, height=det.box.height)
                                    if detect else None),
                ml_model=spec.name,
                ml_model_version="0",
                width=meta.width,
                height=meta.height,
                is_keyframe=meta.is_keyframe,
            )
            self._annotations.publish(encode_annotation(req))

    def _should_annotate(self, device_id: str, meta, eligible: Sequence[Detection]) -> bool:
        """The stream's emit policy (cfg.annotation_emit, or its
        annotation_policy override): all, keyframe, min_interval (at most
        one frame's annotations per annotation_min_interval_ms; a frame
        with nothing to emit does not use the slot) or on_change (the
        tracked object set changed, or a confidence moved more than
        annotation_confidence_delta). An unknown policy emits all, with
        one warning per stream."""
        policy = ""
        if self._ann_policy_resolver is not None:
            policy = self._ann_policy_resolver(device_id) or ""
        policy = policy or self._cfg.annotation_emit
        if policy == "all":
            return True
        if policy == "keyframe":
            return bool(meta.is_keyframe)
        if policy not in ("min_interval", "on_change"):
            if (device_id, policy) not in self._ann_policy_warned:
                self._ann_policy_warned.add((device_id, policy))
                log.warning("unknown annotation policy %r for %s; emitting all", policy,
                            device_id)
            return True
        # Under _state_lock: the tick thread's GC drops the state of
        # streams gone from the bus.
        with self._state_lock:
            st = self._ann_state.setdefault(device_id, {})
            if policy == "min_interval":
                if not eligible:
                    return True
                now = meta.timestamp_ms or int(time.time() * 1000)
                last = st.get("last_ms")
                if last is not None and now - last < self._cfg.annotation_min_interval_ms:
                    return False
                st["last_ms"] = now
                return True
            # on_change: track ids when the tracker runs, else per-class
            # maximum confidence.
            cur: Dict[str, float] = {}
            for det in eligible:
                key = det.track_id or f"class{det.class_id}"
                cur[key] = max(cur.get(key, 0.0), det.confidence)
            prev = st.get("sig")
            delta = self._cfg.annotation_confidence_delta
            changed = prev is None or set(cur) != set(prev) or any(
                abs(cur[k] - prev[k]) > delta for k in cur)
            if changed:
                st["sig"] = cur
            return changed and bool(eligible)

    def _on_quality_transition(self, stream: str, old: str, new: str) -> None:
        """A quality verdict's transition (black, frozen, flatline, their
        recoveries) goes out on the uplink as a ``type="quality"`` event."""
        if self._annotations is None:
            return
        req = AnnotateRequest(device_name=stream, type="quality",
                              start_timestamp=int(time.time() * 1000), object_type=new,
                              confidence=1.0, ml_model="obs.quality", ml_model_version=old)
        try:
            self._annotations.publish(encode_annotation(req))
        except Exception:
            log.exception("quality alert publish failed")

    def _publish(self, result: InferenceResult) -> None:
        with self._sub_lock:
            if self._fanout_closed:
                return
            targets = [q for q, ids in self._subscribers
                       if ids is None or result.device_id in ids]
        for q in targets:
            try:
                q.put_nowait(result)
            except queue.Full:
                pass    # a slow subscriber loses results, never the engine
