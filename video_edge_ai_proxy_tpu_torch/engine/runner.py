"""Serving step and inference engine (counterpart of ``video_edge_ai_proxy_tpu/engine/runner.py``).

``build_serving_step`` is the single source of truth for the per-tick
device program of a model: uint8 frames (or clips) in, postprocessed
results out. Detectors: letterbox -> YOLOv8 ``decode="serving"`` ->
sigmoid of the per-anchor max logit -> batched NMS through the CUDA
keep-mask kernel -> unletterbox. Classifiers and video models: stretch
resize + ImageNet normalisation -> MobileNetV2 / ViT / VideoMAE (long
clips through the CUDA flash-attention kernel) -> float32 softmax ->
top-5. Embedders: the same resize and normalisation -> ResNet's pooled
float32 features (``features_only``), one re-ID vector a frame, carried
as a box-less detection's ``embedding`` (the annotation's
``object_signature``). Frame models add the frame-quality statistics. It
runs eagerly; ``chip_smoke.py`` times it.

The engine compiles it once per (model, stem, geometry, bucket), the JAX
engine's step-cache key: on the card ``_GraphedStep`` captures it into
one CUDA graph over static input buffers and replays that graph for
every batch of the key (the counterpart of the JAX ``_TimedStep``), with
step-cache hit and miss counters, the capture's time in
``obs/perf.py``, prewarming at ``start()`` from ``cfg.prewarm`` and the
prewarm manifest (``engine/aot_cache.py``), and ``prewarm_status()``;
then the tick thread warms the serving path with one unserved batch of
each program before its first tick. On the CPU, where the caller asked
for it, the step runs eagerly.

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

The detect family's variant axes (``cfg.stem``, ``cfg.quantize``), as in
the JAX engine: ``stem="s2d"`` serves the space-to-depth stem model behind
the fused letterbox (a classic model handed in folds its stem losslessly,
``models/carry.py`` ``fit_state``); ``quantize="int8"`` serves from int8
weights and per-channel scales held on the device and dequantized inside
the step (``models/quantize.py`` ``QuantizedModel``), and ``"int8_act"``
also runs every ConvBN but the stem int8 x int8 against input ranges
calibrated at warmup on synthetic frames. Each variant is its own
(model, stem, geometry, bucket) program.

Checkpoints (``cfg.checkpoint_path``, as in the JAX engine): at warmup,
before any step is built (so a CUDA graph captures the loaded weights), a
msgpack checkpoint that exists is loaded into the default model
(``utils/checkpoint.py`` ``load_msgpack_with_meta`` -> ``carry.from_flax``
-> ``fit_state``); a missing one logs a warning and leaves the random
init. Its metadata's ``conf_threshold`` (stamped by the self-training
loop's calibration) filters the default model's detections, and only
those: per-stream extra models start from their init and keep the NMS
floor. ``save_checkpoint`` writes the served weights back (float32, the
dequantized ones for a quantized engine).

The device accounting: ``perf`` (``obs/perf.py``) counts each program's
FLOPs when it is built, each batch's device time, padding and MFU against
the card's peak (resolved from its name at warmup), each placement's H2D
bytes and time, and the aggregate frames/s the fps objective reads;
``hbm`` (``obs/hbm.py``, ``cfg.hbm``) keeps the program footprints and the
pools' bytes, and its pressure verdict feeds the ladder.

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

ROI serving (``cfg.roi``): each tick ``_roi_transform`` motion-gates every
detect stream (``_RoiGate``: the previous tick's thumbnail diff energy and
the stream's tracker): ``full`` rows stay classic frames, ``roi`` rows
become crops around the predicted track boxes, shelf-packed with other
streams' crops onto shared canvases (``CanvasPacker``) in a pooled, pinned
staging buffer and served as one more program key, and ``idle`` rows
become a coast group with no device work whose tracker-coasted results
ride the drain queue. The drain routes each canvas detection to its crop by
center point and maps it back through the crop's exact inverse
(``_emit_canvas``, ``uncrop_boxes``). The temporal cascade
(``cfg.cascade``, ``temporal/``): the emit harvests each tracked
detection's crop into its track's device clip ring, and the tick runs the
scheduler: the scatter, and every ``cascade_every_n`` ticks the VideoMAE
head (``_build_cascade_head``, its own ``cascade:<model>`` program key),
whose enter and exit events go to the metrics, the uplink
(``type="cascade"``) and, on enter, the archive. Both are off by default
and leave the classic path as it was.

The fault domain, the capacity plane and the mesh paths are later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
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

from ..bus.interface import FrameBus, FrameMeta
from ..device import resolve_device
from ..models import registry
from ..obs import registry as obs_registry
from ..models.quantize import calibrate_serving, quantize_model, quantized_nbytes, tree_nbytes
from ..models.registry import place
from ..obs.perf import PerfTracker, count_flops, resolve_peak_tflops
from ..obs.prof import Profiler
from ..obs.quality import QualityTracker
from ..obs.slo import SLOEngine, default_slos
from ..obs.spans import trace_id_of, tracer
from ..obs.watch import Watchdog
from ..ops.boxes import uncrop_boxes
from ..ops.nms import _top, batched_nms, nms_keep_mask
from ..ops.preprocess import (
    frame_quality_stats, preprocess_classify, preprocess_clip, preprocess_letterbox,
    preprocess_letterbox_fused, unletterbox_boxes,
)
from ..proto.annotate import AnnotateRequest, encode as encode_annotation
from ..proto.annotate import BoundingBox as AnnotationBox
from ..replay.checksum import CHECKSUM_MASK, host_slot_checksum
from ..resilience.ladder import RUNGS, DegradationLadder
from ..utils.config import EngineConfig
from ..utils.logging import ContextFilter, log_context
from . import aot_cache
from .classes import class_name
from .collector import BatchGroup, CanvasPacker, Collector, bucket_for, host_empty
from .tracker import IoUTracker

log = logging.getLogger("vep.torch.engine.runner")
# Records carry the per-slot context (utils/logging.py) to every handler,
# the root logger's included.
log.addFilter(ContextFilter())

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
      4]`` (source px, xyxy), ``scores``, ``classes``, ``valid``; an
      ``s2d``-stem model takes the fused letterbox's folded plane;
    - ``"embed"``: frames [N, H, W, 3] uint8 -> dict of ``embedding [N,
      F]`` f32, the model's pooled features (``features_only=True``);
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
        letterbox = (preprocess_letterbox_fused
                     if getattr(model.cfg, "stem", "classic") == "s2d" else preprocess_letterbox)

        def raw(frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
            with torch.inference_mode():
                x, lb = letterbox(frames_u8, size, out_dtype=preprocess_dtype)
                # decode="serving": class reduction in logit space; sigmoid is
                # monotone, so it is applied to the per-anchor winners only.
                boxes, max_logit, cls_ids = model(x.permute(0, 3, 1, 2), decode="serving")
                b, s, c, valid = batched_nms(boxes, torch.sigmoid(max_logit), cls_ids,
                                             keep_mask=keep_mask)
                b = unletterbox_boxes(b, lb)
            return {"boxes": b, "scores": s, "classes": c, "valid": valid}
    elif spec.kind == "embed":
        def raw(frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
            with torch.inference_mode():
                x = preprocess_classify(frames_u8, (size, size), out_dtype=preprocess_dtype)
                return {"embedding": model(x, features_only=True)}
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


def _build_cascade_head(model: torch.nn.Module, score_w, score_b: float):
    """The temporal head's program (the cascade): uint8 clips [B, T, S, S,
    3] -> ``logits`` [B, classes] (the video model's, float32), ``features``
    [B, 3] and ``event_score`` [B], as the JAX package's
    ``_build_cascade_head``. Features per clip: the mean absolute luma
    difference between consecutive frames (exactly 0 for a pixel-static
    track), the clip's luma variance (the population variance, as
    ``jnp.var``) and the head's largest softmax probability; luma is the
    mean over the three channels, not the weighted luma of the quality
    statistics. The model takes ``clips / 255`` as they are: no ImageNet
    normalisation (not the ``preprocess="clip"`` path). The score is
    ``sigmoid(w . f + b)``; the features, the softmax and the score are
    float32."""
    device = next(model.parameters()).device
    w = torch.tensor((tuple(score_w) + (0.0, 0.0, 0.0))[:3], dtype=torch.float32, device=device)
    b = float(score_b)

    def head(clips_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x = clips_u8.to(torch.float32) / 255.0
            logits = model(x).to(torch.float32)
            probs = torch.softmax(logits, dim=-1)
            luma = x.mean(dim=-1)
            diff_energy = (luma[:, 1:] - luma[:, :-1]).abs().mean(dim=(1, 2, 3))
            luma_var = luma.var(dim=(1, 2, 3), correction=0)
            top_prob = probs.amax(dim=-1)
            feats = torch.stack([diff_energy, luma_var, top_prob], dim=-1)
            score = torch.sigmoid(feats @ w + b)
        return {"event_score": score, "features": feats, "logits": logits}

    return head


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
    embedding: List[float] = field(default_factory=list)   # re-ID features (embed models)
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
                  num_classes: int, conf_threshold: float = 0.0) -> List[Detection]:
    """Row ``i`` of a host-side step output -> wire detections. Detectors:
    int pixel boxes (left/top/width/height), confidence, class id and
    name, those scoring below ``conf_threshold`` (a checkpoint's calibrated
    operating point) left out. Embedders: one box-less detection with the
    feature vector, confidence 1 and class id -1. Classifiers and video
    models: one box-less detection per top-5 entry."""
    out: List[Detection] = []
    if kind == "embed":
        return [Detection(confidence=1.0, class_id=-1,
                          embedding=[float(v) for v in host["embedding"][i]])]
    if kind != "detect":
        for p, cid in zip(host["top_probs"][i], host["top_ids"][i]):
            out.append(Detection(confidence=float(p), class_id=int(cid),
                                 class_name=class_name(int(cid), num_classes)))
        return out
    for j in np.nonzero(host["valid"][i])[0]:
        if float(host["scores"][i, j]) < conf_threshold:
            continue
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
    harvest_ms: float = 0.0       # of it, the cascade's harvest (cfg.cascade)


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
    # A warm-up batch (start() on the card): read back, not emitted; the
    # drain sets the event once it is through.
    warm: Optional[threading.Event] = None


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

    def nbytes(self) -> int:
        """Device bytes of the pool now (rows stay allocated after their
        streams go)."""
        pool = self._pool
        return int(pool.nbytes) if pool is not None else 0

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
        # Placements resolved and not yet handed to a step (id -> tensor):
        # the device bytes the stage holds (nbytes).
        self._parked: Dict[int, torch.Tensor] = {}
        self._parked_lock = threading.Lock()

    def nbytes(self) -> int:
        """Device bytes of placements resolved and not yet dispatched."""
        with self._parked_lock:
            return sum(int(t.nbytes) for t in self._parked.values())

    def unpark(self, pre: "_Prefetched") -> None:
        """The tick thread took ``pre``'s placement (or gave it up)."""
        with self._parked_lock:
            self._parked.pop(id(pre), None)

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
                with self._parked_lock:
                    self._parked[id(pre)] = pre.placed
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
    outside the capture (the first of them under FlopCounterMode:
    ``flops``), then captures one call on that stream into the engine's
    graph pool and hands the capture's seconds to ``on_capture``; the step
    then also holds ``flops``, the static inputs' and outputs' bytes and
    ``pool_growth``, the bytes the graph pool reserved during the capture.
    Every call copies its frames (and the previous thumbnails) into the
    static inputs, replays the graph and returns fresh copies of the static
    outputs: the next replay overwrites them while the drain still reads
    this batch. A failed capture or replay raises; nothing runs the step
    eagerly in its place, and the engine drops the batch with a log line.

    A failed capture leaves torch's allocator recording into the pool it
    captured into (``beginAllocateToPool: already recording``): the
    recording is ended (``_end_pool_recording``) and the pool is given up:
    ``pool()`` is asked for the pool at every capture, and
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
                 on_capture_failed: Callable[[BaseException], None] = lambda exc: None,
                 flops: Optional[float] = None):
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
        # Known FLOPs (the prewarm manifest's) spare the FlopCounterMode pass.
        self._known_flops = flops
        self.flops = 0.0
        self.pool_growth = 0
        self._graph: Optional["torch.cuda.CUDAGraph"] = None
        self._step: Optional[Callable] = None
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
        if self._known_flops:
            step(*args)
            self.flops = float(self._known_flops)
        else:
            _, self.flops = count_flops(step, *args)
        for _ in range(self.WARMUP_CALLS - 1):
            step(*args)
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.frames_in.device)
        pool = self._pool()
        reserved = _pool_bytes({tuple(pool)})
        t0 = time.perf_counter()
        try:
            # thread_local: the transfer and drain threads keep copying
            # and synchronising on their own streams meanwhile.
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = step(*args)
        except BaseException as exc:
            _end_pool_recording(self.frames_in.device, pool)
            # The failed graph is kept, not destroyed while serving.
            self._failure, self._failed_graph = exc, graph
            self._on_capture_failed(exc)
            raise
        finally:
            captured = tuple((w, w.launches - b) for w, b in zip(counters, before)
                             if w.launches != b)
            for w, b in zip(counters, before):
                w.launches = b
        self.capture_s = time.perf_counter() - t0
        self.pool_growth = max(0, _pool_bytes({tuple(pool)}) - reserved)
        # The step is kept with its graph: the tensors it made when it was
        # built (the cascade head's score weights) are read by every replay
        # at the addresses the capture saw.
        self._graph, self._out, self._launches, self._step = graph, dict(out), captured, step
        self._on_capture(self.capture_s)

    @property
    def input_bytes(self) -> int:
        return sum(int(t.nbytes) for t in (self.frames_in, self.thumbs_in) if t is not None)

    @property
    def output_bytes(self) -> int:
        return sum(int(t.nbytes) for t in self._out.values())


def _end_pool_recording(device: torch.device, pool: tuple) -> None:
    """End the allocator's recording into ``pool`` after a failed capture.
    ``capture_end`` raises on an invalidated capture before it ends the
    recording, and while any recording is open the allocator's
    ``empty_cache`` releases nothing and each freed block that another
    stream used stays pending: the process would keep its cached memory
    for its lifetime."""
    end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
           or torch._C._cuda_endAllocateCurrentStreamToPool)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        end(index, pool)
    except RuntimeError:
        pass    # the capture's own end closed it


def _pool_bytes(pools: set) -> int:
    """Reserved bytes of the CUDA graph memory pools ``pools`` (handles)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def _note_first_call(step: Callable, note: Callable[[float, float], None]) -> Callable:
    """``step`` whose first call runs under FlopCounterMode and hands its
    seconds and FLOPs to ``note`` (the CPU's eager program build)."""
    pending = [note]

    def counted(*args):
        if not pending:
            return step(*args)
        t0 = time.perf_counter()
        out, flops = count_flops(step, *args)
        pending.pop()(time.perf_counter() - t0, flops)
        return out

    return counted


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


class _RoiGate:
    """Per-stream motion-gate state of ROI serving (``cfg.roi``).

    Its inputs are feedback: the previous tick's thumbnail diff energy (the
    quality statistics, noted on the drain thread in ``_emit``) and the
    stream's tracker. The verdict per detect stream per tick:

    - ``full``: the refresh is due, or no gating signal yet, or motion with
      no track to localise it: the classic full frame (the only slots that
      refresh the quality statistics, so the diff signal never starves);
    - ``idle``: diff energy below ``roi_idle_diff``: no device work, the
      tracker coasts one frame and its predicted boxes emit with decayed
      confidence;
    - ``roi``: motion with live tracks: crops around the predicted boxes
      join the shared canvases.

    A dict protocol (``__iter__``, ``__len__``, ``pop``) for the engine's
    stream GC. All access runs under the engine's ``_state_lock``.
    """

    def __init__(self, idle_diff: float, full_interval_ms: float):
        self.idle_diff = float(idle_diff)
        self.full_interval_s = full_interval_ms / 1000.0
        self._streams: Dict[str, dict] = {}

    def __bool__(self) -> bool:
        return bool(self._streams)

    def __iter__(self):
        return iter(self._streams)

    def __len__(self) -> int:
        return len(self._streams)

    def pop(self, device_id: str, default=None):
        return self._streams.pop(device_id, default)

    def state(self, device_id: str) -> dict:
        return self._streams.setdefault(device_id, {"diff": None, "full_at": 0.0})

    def note_diff(self, device_id: str, diff: float) -> None:
        self.state(device_id)["diff"] = float(diff)

    def note_full(self, device_id: str, now: float) -> None:
        self.state(device_id)["full_at"] = now

    def classify(self, device_id: str, tracker, now: float) -> str:
        st = self.state(device_id)
        if not st["full_at"] or now - st["full_at"] >= self.full_interval_s:
            return "full"
        if st["diff"] is not None and st["diff"] < self.idle_diff:
            return "idle"
        if tracker is not None and tracker.live_tracks:
            return "roi"
        return "full"


class InferenceEngine:
    """Tick loop serving one model over every stream of a frame bus: a
    detector or classifier on each stream's newest frame, a video model on
    each stream's clip window once it is full.

    ``model``: an ``nn.Module`` already on ``device`` (e.g. with loaded
    weights), fitted at ``warmup`` to the variant ``cfg.stem`` and
    ``cfg.quantize`` ask for; None builds the registry model with random
    weights at ``warmup``. ``device`` defaults to the card and raises
    without one.

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
    manifest, ``compile_for``), under the engine's stem (``cfg.stem``).

    ``annotations``: the uplink queue (None: no annotations);
    ``model_resolver`` and ``annotation_policy_resolver``: the per-stream
    model and emit-policy overrides (the process manager's
    ``inference_model_of`` and ``annotation_policy_of``); ``journal``: a
    decision journal to record into (the server's, shared by the process)
    instead of one of the engine's own, with ``cfg.journal`` on;
    ``archiver``: where the cascade's enter events archive their clips
    (anything with ``submit(GopSegment)``, e.g. ``ingest/archive.py``
    ``SegmentArchiver``; None: no archive).
    """

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
                 journal=None, archiver=None):
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._cfg = cfg or EngineConfig()
        # The stem of every program (a key axis), and the quantization.
        self._stem = self._cfg.stem or "classic"
        if self._stem not in ("classic", "s2d"):
            raise ValueError(f"engine.stem={self._stem!r} unsupported ('classic' or 's2d')")
        if self._cfg.quantize not in ("", "int8", "int8_act"):
            raise ValueError(f"engine.quantize={self._cfg.quantize!r} unsupported (only 'int8' "
                             "weight-only and 'int8_act' calibrated activation quantization "
                             "exist)")
        self._dtype = getattr(torch, self._cfg.dtype)
        self._spec = self._variant_spec(registry.get(self._cfg.model))
        self._model = model
        self._model_ready = False      # fitted, calibrated, quantized (warmup)
        # The default model's serving threshold from its checkpoint's
        # metadata (warmup); 0.0 = the NMS floor only.
        self._conf_threshold = 0.0
        self._buckets = tuple(sorted(self._cfg.batch_buckets))
        self._bus = bus
        self._annotations = annotations
        self._archiver = archiver
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
        # The MFU peak is resolved from the card at warmup (0 on the CPU).
        self.perf = PerfTracker(peak_tflops=self._cfg.peak_tflops)
        # ROI serving (cfg.roi): the motion gate and the shelf packer (at
        # most one canvas per slot of the largest bucket), and the last ROI
        # mode journaled per stream. roi=False leaves both None: every batch
        # takes the classic path.
        self._roi: Optional[_RoiGate] = None
        self._packer: Optional[CanvasPacker] = None
        self._roi_mode: Dict[str, str] = {}
        if self._cfg.roi:
            self._roi = _RoiGate(self._cfg.roi_idle_diff, self._cfg.roi_full_interval_ms)
            self._packer = CanvasPacker(
                side=self._cfg.roi_canvas, gap=self._cfg.roi_gap,
                max_canvases=min(self._cfg.roi_max_canvases, max(self._buckets)),
                min_crop=self._cfg.roi_min_crop)
        # The temporal cascade (cfg.cascade): track-keyed device clip rings
        # and the head every cascade_every_n ticks. cascade=False leaves it
        # None: no tap anywhere.
        self._cascade = None
        if self._cfg.cascade:
            from ..temporal import CascadeScheduler

            self._cascade = CascadeScheduler(
                model=self._cfg.cascade_model, every_n=self._cfg.cascade_every_n,
                crop=self._cfg.cascade_crop, clip_len=self._cfg.cascade_clip_len,
                threshold=self._cfg.cascade_threshold, enter_n=self._cfg.cascade_enter_n,
                exit_n=self._cfg.cascade_exit_n, ttl_ticks=self._cfg.cascade_track_ttl_ticks,
                perf=self.perf, device=self._device)
            self._cascade.head = self._cascade_head
        # Int8 residency of each model served quantized: name -> (fp bytes,
        # int8 bytes), as tree_nbytes and quantized_nbytes count them.
        self.residency: Dict[str, tuple] = {}
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
        self._warmed = threading.Event()   # the tick thread warmed the serving path
        self._errors: List[BaseException] = []
        # Dispatched batches wait here for the drain thread. Depth 2 is
        # double buffering; a full queue back-pressures the tick loop.
        self._drain_q: "queue.Queue[Optional[_Inflight]]" = queue.Queue(maxsize=2)
        self._drain_thread: Optional[threading.Thread] = None
        # Held by the tick loop through each tick's dispatch: at_rest()
        # takes it to read between ticks.
        self._tick_lock = threading.Lock()
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
        # Results a full subscriber queue dropped (``_publish``).
        self.subscriber_drops = 0
        self.subscriber_drops_by_stream: Dict[str, int] = {}
        self._inferred: List[str] = []               # the last tick's inferred streams
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
        # The device-memory plane (cfg.hbm): program footprints noted at
        # capture, the pools' live bytes, the forecast that feeds the
        # ladder. None when off: no footprint taps, /api/v1/hbm answers 400.
        self.hbm = None
        if self._cfg.hbm:
            from ..obs.hbm import HbmTracker

            self.hbm = HbmTracker(
                budget_bytes=self._cfg.hbm_budget_bytes,
                fast_window_s=self._cfg.hbm_fast_window_s,
                slow_window_s=self._cfg.hbm_slow_window_s,
                util_objective=self._cfg.hbm_util_objective,
                eval_interval_s=self._cfg.hbm_eval_interval_s,
                pressure_horizon_s=self._cfg.hbm_pressure_horizon_s,
            )
            self.hbm.register_pool("thumbs", self._thumbs.nbytes)
            self.hbm.register_pool(
                "track_state",
                lambda: self._cascade.pool_nbytes() if self._cascade is not None else 0)
            self.hbm.register_pool("prefetch", self._xfer.nbytes)
            self.hbm.register_pool("collector_host", self._collector.pool_nbytes)
        # The capacity plane (cfg.capacity): each measured batch's device
        # time attributed to its occupant streams, the headroom forecast
        # evaluated off the tick (throttled). None when off: no tap in the
        # emit path, /api/v1/capacity answers 400.
        self.capacity = None
        if self._cfg.capacity:
            from ..obs.capacity import CapacityTracker

            self.capacity = CapacityTracker(
                tick_ms=self._cfg.tick_ms,
                fast_window_s=self._cfg.capacity_fast_window_s,
                slow_window_s=self._cfg.capacity_slow_window_s,
                util_objective=self._cfg.capacity_util_objective,
                eval_interval_s=self._cfg.capacity_eval_interval_s)
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
        self._m_ticks = obs_registry.counter(
            "vep_engine_ticks_total", "Engine ticks completed").labels()
        self._m_batches = obs_registry.counter(
            "vep_engine_batches_total", "Device batches dispatched").labels()
        self._m_frames = obs_registry.counter(
            "vep_stream_frames_total", "Inference results per stream", ("stream",))
        self._m_latency = obs_registry.histogram(
            "vep_stream_latency_ms", "Capture to result latency per stream (ms)", ("stream",))
        self._m_device = obs_registry.histogram(
            "vep_device_batch_ms", "Batch submit to host fetch complete (ms)", ("model",))
        self._m_occupancy = obs_registry.histogram(
            "vep_batch_occupancy_pct", "Real frames per padded batch slot (percent)").labels()
        self._m_sub_drops = obs_registry.counter(
            "vep_stream_subscriber_dropped_total",
            "Results dropped on slow subscribers per stream", ("stream",))
        self._m_late = obs_registry.counter(
            "vep_frames_late_total", "Results slower end-to-end than engine.obs_late_ms",
            ("stream",))
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

    @property
    def cascade(self):
        """The cascade scheduler, or None with ``cfg.cascade`` off
        (``/api/v1/cascade`` answers 400 then)."""
        return self._cascade

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
            spec = self._variant_spec(registry.get(name))
            module = spec.init_params(torch.Generator().manual_seed(0), device=self._device,
                                      dtype=self._dtype)
            module = self._prepare(spec, module)
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

    def _variant_spec(self, spec):
        """``spec`` with its build rewritten to the detect-family variant
        axes of the config (``stem``, ``act_int8`` under ``quantize=
        "int8_act"``); the spec itself for the classic fp variant and for
        the other families."""
        if spec.kind != "detect":
            return spec
        overrides = {}
        if self._stem != "classic":
            overrides["stem"] = self._stem
        if self._cfg.quantize == "int8_act":
            overrides["act_int8"] = True
        if not overrides:
            return spec

        def build(dtype, _base=spec.build, _ov=dict(overrides)):
            m = _base(dtype)
            return type(m)(dataclasses.replace(m.cfg, **_ov), dtype)

        return dataclasses.replace(spec, build=build)

    def _fit_variant(self, spec, module: torch.nn.Module) -> torch.nn.Module:
        """A model handed to the engine, as the variant ``spec`` builds:
        itself when its config already is that variant, else the variant's
        model on the same device with the weights carried across
        (``carry.fit_state``: the classic stem folded into the s2d one)."""
        if spec.kind != "detect" or (
                getattr(module.cfg, "stem", "classic"), getattr(module.cfg, "act_int8", False)
        ) == (self._stem, self._cfg.quantize == "int8_act"):
            return module
        from ..models.carry import fit_state

        want = spec.build(self._dtype)
        want.load_state_dict(fit_state(module.state_dict(), want), strict=True)
        return place(want, self._device, channels_last=True)

    def _prepare(self, spec, module: torch.nn.Module) -> torch.nn.Module:
        """Calibrate (``int8_act``) and quantize (``int8``, ``int8_act``)."""
        return self._maybe_quantize(spec, self._maybe_calibrate(spec, module))

    def _maybe_calibrate(self, spec, module: torch.nn.Module) -> torch.nn.Module:
        """``quantize="int8_act"``: the input ranges of the int8 convs from
        two synthetic batches of 2 frames at the model's input size (seed
        0, as the JAX engine's warmup calibrates); the pass runs the fp
        forward."""
        if (self._cfg.quantize != "int8_act" or spec.kind != "detect"
                or not getattr(module.cfg, "act_int8", False)):
            return module
        rng = np.random.default_rng(0)
        s = spec.input_size
        batches = [torch.from_numpy(rng.integers(0, 256, (2, s, s, 3), np.uint8))
                   .to(self._device) for _ in range(2)]
        calibrate_serving(module, spec, batches)
        log.info("engine activations calibrated for int8 serving (%d synthetic batches at "
                 "%d^2)", len(batches), s)
        return module

    def _maybe_quantize(self, spec, module: torch.nn.Module) -> torch.nn.Module:
        """``quantize`` set: the model served from int8 weights and their
        scales (``QuantizedModel``); its residency goes to ``residency``."""
        if not self._cfg.quantize:
            return module
        from ..models.quantize import serving_state

        before = tree_nbytes(serving_state(module))
        module = quantize_model(module)
        after = quantized_nbytes(module.qt)
        self.residency[spec.name] = (before, after)
        log.info("engine params of %s quantized int8 (%s): %.1f MB -> %.1f MB", spec.name,
                 "weight-only" if self._cfg.quantize == "int8" else
                 "weights + calibrated activations", before / 1e6, after / 1e6)
        return module

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> None:
        """Build the model (random weights unless one was given), fitted to
        the variant, calibrated and quantized as the config asks, resolve
        the MFU peak and the device-memory budget from the card, and build
        the CUDA kernels, so the first tick does not stall."""
        if not self._model_ready:
            if self._model is None:
                self._model = self._spec.init_params(device=self._device, dtype=self._dtype)
            else:
                self._model = self._fit_variant(self._spec, self._model)
            self._load_checkpoint()
            self._model = self._prepare(self._spec, self._model)
            self.perf.set_peak(resolve_peak_tflops(self._cfg.peak_tflops, self._device))
            if self.hbm is not None and not self._cfg.hbm_budget_bytes and self._cuda:
                self.hbm.set_budget(torch.cuda.mem_get_info(self._device)[1])
            self._model_ready = True
        if self._cuda:
            from ..kernels.build import build_all

            build_all()
            # The engine's streams do not wait on the default stream: the
            # weights must be in place before the first step.
            torch.cuda.synchronize(self._device)
            if self._compute is None:
                self._compute = torch.cuda.Stream(self._device)
                self._d2h = torch.cuda.Stream(self._device)

    def _load_checkpoint(self) -> None:
        """``cfg.checkpoint_path`` into the default model, fitted to its
        variant, strictly; its ``conf_threshold`` metadata becomes the
        default model's serving threshold. A missing file keeps the
        random init."""
        ckpt = self._cfg.checkpoint_path
        if not ckpt:
            return
        if not os.path.exists(ckpt):
            log.warning("checkpoint %s missing; using random init", ckpt)
            return
        from ..models.carry import fit_state, from_flax
        from ..utils.checkpoint import load_msgpack_with_meta

        raw, meta = load_msgpack_with_meta(ckpt)
        self._model.load_state_dict(fit_state(from_flax(raw), self._model), strict=True)
        log.info("loaded engine params from %s", ckpt)
        thr = (meta or {}).get("conf_threshold")
        if thr is not None:
            self._conf_threshold = float(thr)
            log.info("serving at calibrated conf_threshold=%.3f (checkpoint metadata)",
                     self._conf_threshold)

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write the default model's served weights to ``path`` (default:
        ``cfg.checkpoint_path``) as a float32 msgpack checkpoint (atomic),
        the format the JAX package's ``load_msgpack`` reads. Refused before
        warmup, which would write unloaded weights. A quantized engine
        writes its dequantized weights, lossy against what it loaded."""
        from ..models.carry import to_flax
        from ..utils.checkpoint import save_msgpack

        if not self._model_ready:
            raise RuntimeError("save_checkpoint before warmup would overwrite the checkpoint "
                               "with unloaded params; call warmup() first")
        path = path or self._cfg.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured")
        if self._cfg.quantize:
            from ..models.quantize import dequantize_tree

            # Checkpoints stay full precision; quantization re-applies at
            # the next warmup. The exact pre-quantization weights are gone.
            log.warning("save_checkpoint from a quantized engine writes int8-roundtripped "
                        "weights (lossy vs the originally loaded params); keep a copy of the "
                        "source checkpoint")
            state = dequantize_tree(self._model.qt)
        else:
            state = self._model.state_dict()
        save_msgpack(path, to_flax(state))
        return path

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
        then start the threads; on the card, return once the tick thread
        has warmed the serving path."""
        if self._drain_thread is not None:
            raise RuntimeError("engine already started")
        self.warmup()
        self._prewarm()
        self._start_pipeline()
        self._warmed.clear()
        self._thread = threading.Thread(target=self._loop, name="vep-torch-engine", daemon=True)
        self._thread.start()
        # On the card the tick thread warms the serving path before its
        # first tick (_warm_serving_path): a frame published after start()
        # returns meets a warm path.
        while self._cuda and not self._warmed.wait(0.1):
            if not self._thread.is_alive():
                raise RuntimeError("engine failed while warming its serving path") from (
                    self._errors[0] if self._errors else None)
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

    def _warm_serving_path(self, timeout_s: float = 60.0) -> None:
        """On the card, on the tick thread before its first tick: one batch
        of zero frames for each program built so far (the prewarm's)
        through the path a tick's batch takes: a pooled pinned batch
        buffer, the placement (on the transfer thread with
        ``cfg.prefetch``), the step on the compute stream with its
        thumbnail gather, and the drain thread's read-back. Without it a
        process's first served batch pays the first use of each (0.5-0.9 s
        on one H100 with the program prewarmed, most of it the first
        thumbnail gather on the tick thread), and the tick loop stalls
        behind it: a paced stream's next frame is overwritten before it is
        collected. The batch is not traffic: nothing is emitted, and no
        stats, metric, capacity ledger, checksum or span sees it. A key
        whose batch fails is logged and skipped, as a tick skips it."""
        t0 = time.monotonic()
        for (name, _stem, src_hw, bucket), step in list(self._steps.items()):
            spec = self._model_entry(name)[0]
            shape = ((bucket,) + ((spec.clip_len,) if spec.clip_len else ()) + src_hw + (3,))
            frames, idx = self._collector.staging_buffer(shape)
            group = BatchGroup(src_hw, [], frames, [], bucket, model=name)
            self._collector.lease_staged(group, shape, idx)
            drained = threading.Event()
            try:
                if self._cfg.prefetch:
                    pre = self._xfer.submit(group, self._stop)
                    if pre is None or not pre.ready.wait(timeout_s):
                        raise RuntimeError("warm-up placement did not resolve")
                    self._xfer.unpark(pre)
                    if pre.error is not None:
                        raise pre.error
                    placed, event = pre.placed, pre.event
                else:
                    placed, event, _ = self._xfer.place(frames)
                inflight = self._run_step(step, group, placed, event, time.time())
                inflight.warm = drained
                self._enqueue_drain(inflight)
            except Exception:
                self._collector.release(group)
                log.exception("warm-up batch of %s %sx%s bucket=%d failed; continuing", name,
                              src_hw[0], src_hw[1], bucket)
                continue
            if not drained.wait(timeout_s):
                raise RuntimeError(f"the warm-up batch of {name} {src_hw[0]}x{src_hw[1]} "
                                   f"bucket={bucket} was not drained within {timeout_s} s")
        if self._steps:
            log.info("serving path warmed over %d programs in %.3f s", len(self._steps),
                     time.monotonic() - t0)

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
        (a per-stream model, built here if it is not yet). ``stem`` pins the
        stem an entry was written for: an entry of the engine's stem is
        served, one of another stem skipped with a warning (the engine's
        weights are fitted to one stem), as in the JAX engine."""
        if stem is not None and stem != self._stem:
            log.warning("prewarm entry pinned stem=%r but the engine serves stem=%r; "
                        "skipping %sx%s bucket=%d", stem, self._stem, src_hw[0], src_hw[1],
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
            pool_bytes = _pool_bytes({tuple(p) for p in self._graph_pools})
        return {"programs": len(graphs), "capture_s": sum(s.capture_s for s in graphs),
                "pools": len(self._graph_pools), "pool_bytes": pool_bytes}

    def _current_graph_pool(self) -> tuple:
        """The pool the next capture records into, opened on first use."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_pools.append(self._graph_pool)
        return self._graph_pool

    def _retire_graph_pool(self, exc: BaseException) -> None:
        """A capture failed: the pool holds what the failed capture
        allocated into it, so no later capture uses it."""
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

    def at_rest(self, read: Callable[[], object], timeout: float = 10.0):
        """``read()`` with no batch between its step's launch and its emit:
        the tick loop is held between two ticks and every batch already
        dispatched is emitted first, so counts that a batch moves at both
        ends (its kernels' launches, then its batch metric) read as a pair.
        After ``timeout`` (a drain thread that died) a warning is logged and
        ``read()`` runs as things stand."""
        deadline = time.monotonic() + timeout
        held = self._tick_lock.acquire(timeout=timeout)
        try:
            done = self._drain_q.all_tasks_done
            with done:
                while self._drain_q.unfinished_tasks and time.monotonic() < deadline:
                    done.wait(max(deadline - time.monotonic(), 0.0))
                drained = not self._drain_q.unfinished_tasks
            if not (held and drained):
                log.warning("engine not at rest after %.1f s; reading as it stands", timeout)
            return read()
        finally:
            if held:
                self._tick_lock.release()

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
        numbers that were true while the trace ran."""
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
    def shed_frames(self) -> int:
        """Frames the degradation ladder shed, stale at dispatch (the JAX
        engine's ``shed_frames``)."""
        with self._pipe_lock:
            return self._pipe.shed_frames

    @property
    def _step_cache(self) -> Dict[tuple, Callable]:
        """The step of each key built so far, under the JAX engine's name
        (the chaos soak samples its size)."""
        return self._steps

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
                if self._cuda:
                    self._warm_serving_path()
                self._warmed.set()
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
                with self._tick_lock:
                    inferred = self._tick(tick_s)
            except Exception:
                if self._stop.is_set():
                    # A shutdown race (a prefetched placement abandoned
                    # mid-dispatch) is not an error.
                    log.info("engine tick aborted by shutdown")
                else:
                    log.exception("engine tick failed; continuing")
            self.ticks += 1
            self._m_ticks.inc()
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
                slo_burning=self._slo_burning and self._cfg.slo_ladder,
                hbm_pressure=self.hbm is not None and self.hbm.pressure())
            self._apply_rung_cap(rung)
        if self._cascade is not None:
            # The head's cadence stretches while the ladder is off normal;
            # the streams of the last tick are those whose cadence moves.
            self._apply_cascade_stretch(rung, self._inferred)
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
        if self._roi is not None and groups:
            groups = self._roi_transform(groups)
        self._dispatch(groups, t_collect)
        if self._cascade is not None:
            # A tap: the scatter of the harvested tiles, the head on cadence
            # ticks, the events. The detect path never branches on it.
            self._cascade_tick()
        self._forget_absent(present)
        self._inferred = inferred
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

    def _apply_cascade_stretch(self, rung: str, streams: Sequence[str]) -> None:
        """While the ladder is off normal the temporal head runs every
        ``every_n * cascade_stretch_factor`` ticks: head work sheds before
        streams do. Journaled on the edge only, with an event per stream,
        so ``/api/v1/why?stream=S`` leads from a stream's cadence back to
        the ladder's transition."""
        factor = self._cfg.cascade_stretch_factor if rung != "normal" else 1
        if not self._cascade.set_stretch(factor):
            return
        action = "cascade_stretch" if factor > 1 else "cascade_unstretch"
        if self.journal is not None:
            cause = self.ladder.last_transition_seq if self.ladder is not None else None
            trigger = {"rung": rung, "factor": factor, "every_n": self._cascade.every_n}
            self.journal.record("engine", action, subject=("cascade", "head"), trigger=trigger,
                                cause=cause)
            for sid in sorted(set(streams or [])):
                self.journal.record("engine", action, subject=("stream", str(sid)),
                                    trigger=dict(trigger), cause=cause)
        log.info("cascade cadence %s: every_n %d x%d (rung %s)",
                 "stretched" if factor > 1 else "restored", self._cascade.every_n, factor, rung)

    # -- ROI serving (cfg.roi) ----------------------------------------------------

    def _roi_transform(self, groups: List[BatchGroup]) -> List[BatchGroup]:
        """Motion-gate each detect group's rows and rewrite the tick's work:
        ``full`` rows stay classic frames (compacted in place in their
        pooled buffer, as ``shed_stale`` does; the lease stays with them),
        ``roi`` rows become crops shelf-packed onto shared canvases (one
        canvas group a tick, drawn in a pooled staging buffer with a lease
        of its own, pinned on the card), ``idle`` rows a coast group with
        no device work.

        Order matters twice: the crops are copied out of the pooled buffer
        before the full rows compact (compaction moves rows within it), and
        this runs on the tick thread before ``_dispatch`` hands any group
        to the transfer stage, so nothing reads a buffer after its lease is
        returned. The verdicts are taken under ``_state_lock``: the drain
        thread feeds the gate and the trackers. Groups that are not
        full-frame detect batches pass through."""
        out: List[BatchGroup] = []
        for group in groups:
            spec, module = self._model_entry(group.model)
            if (spec.kind != "detect" or group.frames.ndim != 4
                    or group.crops is not None or group.coast is not None):
                out.append(group)
                continue
            now = time.monotonic()
            full_rows: List[int] = []
            coast: List[tuple] = []
            reqs: List[tuple] = []    # CanvasPacker requests
            req_row: List[int] = []   # request index -> group row
            edges: List[tuple] = []   # ROI mode transitions, journaled below
            with self._state_lock:
                for i, device_id in enumerate(group.device_ids):
                    entry = self._trackers.get(device_id)
                    tracker = entry[1] if entry is not None and entry[0] == spec.name else None
                    verdict = self._roi.classify(device_id, tracker, now)
                    if self.journal is not None and self._roi_mode.get(device_id) != verdict:
                        edges.append((device_id, self._roi_mode.get(device_id), verdict))
                        self._roi_mode[device_id] = verdict
                    if verdict == "idle":
                        coast.append((device_id, group.metas[i],
                                      self._coasted_detections(tracker, module)))
                        continue
                    rects = self._track_rois(tracker) if verdict == "roi" else []
                    if rects:
                        for rect in rects:
                            reqs.append((device_id, group.metas[i], group.frames[i], rect))
                            req_row.append(i)
                    else:
                        full_rows.append(i)
            for device_id, prev, verdict in edges:
                self.journal.record("engine", "roi_mode", subject=("stream", str(device_id)),
                                    trigger={"mode": verdict, "prev": prev or "none"})
            if not coast and not reqs:
                # Everything full: the group passes untouched, its verdicts
                # counted (streams primed together refresh together).
                self.perf.note_roi_gate(0, 0, len(group.device_ids))
                out.append(group)
                continue
            placements: list = []
            staged: dict = {}
            side = self._packer.side
            if reqs:
                def alloc(k: int) -> np.ndarray:
                    shape = (bucket_for(k, self._buckets), side, side, 3)
                    staged["shape"] = shape
                    staged["buf"], staged["idx"] = self._collector.staging_buffer(shape)
                    return staged["buf"]

                _, placements, overflow = self._packer.pack(reqs, alloc=alloc)
                if overflow:
                    # Crops that did not fit send their streams down the
                    # full-frame path, and all of a spilled stream's
                    # placements leave the routing table: a stream never
                    # emits twice in a tick (its placed crops' detections
                    # drop as unrouted, counted).
                    spill = {reqs[ri][0] for ri in overflow}
                    placements = [p for p in placements if p.device_id not in spill]
                    spill_rows = {req_row[ri] for ri in range(len(reqs)) if reqs[ri][0] in spill}
                    full_rows = sorted(set(full_rows) | spill_rows)
            self.perf.note_roi_gate(len(coast), len({p.device_id for p in placements}),
                                    len(full_rows))
            if placements:
                n_used = 1 + max(p.canvas for p in placements)
                metas = []
                for ci in range(n_used):
                    # A canvas's own stamp is its oldest crop's; each
                    # stream's latency uses its crop's meta at the emit.
                    pts = [p.meta.timestamp_ms or 0 for p in placements if p.canvas == ci]
                    metas.append(FrameMeta(width=side, height=side, channels=3,
                                           timestamp_ms=min(pts) if pts else 0))
                bucket = bucket_for(n_used, self._buckets)
                view = staged["buf"][:bucket]
                if bucket != n_used:
                    view[n_used:] = 0
                cgroup = BatchGroup(src_hw=(side, side),
                                    device_ids=[f"_canvas{ci}" for ci in range(n_used)],
                                    frames=view, metas=metas, bucket=bucket, model=group.model,
                                    crops=placements)
                self._collector.lease_staged(cgroup, staged["shape"], staged["idx"])
                out.append(cgroup)
                self.perf.note_roi_pack(len(placements), n_used,
                                        CanvasPacker.area_fraction(placements, n_used, side))
            if coast:
                out.append(BatchGroup(
                    src_hw=group.src_hw, device_ids=[c[0] for c in coast],
                    frames=np.empty((0,) + group.frames.shape[1:], group.frames.dtype),
                    metas=[c[1] for c in coast], bucket=0, model=group.model, coast=coast))
            if full_rows:
                for new_i, old_i in enumerate(full_rows):
                    if new_i != old_i:
                        group.frames[new_i] = group.frames[old_i]
                group.device_ids = [group.device_ids[i] for i in full_rows]
                group.metas = [group.metas[i] for i in full_rows]
                n = len(full_rows)
                bucket = bucket_for(n, self._buckets)
                view = group.frames[:bucket]
                if bucket != n:
                    view[n:] = 0
                group.frames = view
                group.bucket = bucket
                out.append(group)
            else:
                # No full row: the pooled buffer goes back now (the canvases
                # and the coast group hold copies).
                self._collector.release(group)
        return out

    def _coasted_detections(self, tracker, module) -> List[Detection]:
        """A gated-idle stream's results: its tracker advanced one frame
        with no detections (misses age, so stale tracks still expire while
        it is gated) and the surviving predicted boxes, their confidence
        decayed geometrically. The caller holds ``_state_lock``."""
        if tracker is None:
            return []
        tracker.update([], [])
        decay = self._cfg.roi_coast_decay
        floor = self._cfg.roi_coast_floor
        out: List[Detection] = []
        for t in tracker.tracks():
            conf = t["confidence"] * decay ** max(t["misses"], 1)
            if conf < floor:
                continue
            x1, y1, x2, y2 = (int(round(v)) for v in t["box"])
            out.append(Detection(
                box=BoundingBox(left=x1, top=y1, width=x2 - x1, height=y2 - y1),
                confidence=float(conf), class_id=t["class_id"],
                class_name=class_name(t["class_id"], module.cfg.num_classes),
                track_id=str(t["track_id"])))
        return out

    def _track_rois(self, tracker) -> List[tuple]:
        """A tracked stream's crop rectangles: the predicted track boxes
        inflated by ``roi_margin`` (context for the detector, slack for the
        motion since the prediction), overlapping ones merged into their
        hull: one object never lands in two crops of one stream. The caller
        holds ``_state_lock``."""
        if tracker is None:
            return []
        margin = self._cfg.roi_margin
        rects: List[list] = []
        for t in tracker.tracks():
            x1, y1, x2, y2 = t["box"]
            mw = (x2 - x1) * margin
            mh = (y2 - y1) * margin
            rects.append([x1 - mw, y1 - mh, x2 + mw, y2 + mh])
        merged = True
        while merged:
            merged = False
            folded: List[list] = []
            for r in rects:
                for o in folded:
                    if r[0] < o[2] and o[0] < r[2] and r[1] < o[3] and o[1] < r[3]:
                        o[0] = min(o[0], r[0])
                        o[1] = min(o[1], r[1])
                        o[2] = max(o[2], r[2])
                        o[3] = max(o[3], r[3])
                        merged = True
                        break
                else:
                    folded.append(list(r))
            rects = folded
        return [tuple(r) for r in rects]

    # -- the temporal cascade (cfg.cascade) ------------------------------------------

    def _cascade_head(self, pool, slot_idx: np.ndarray, time_idx: np.ndarray,
                      n_real: int) -> tuple:
        """The scheduler's head: the time-ordered clip gather from the state
        pool (eager, on the device), then the head's program of its bucket,
        ``cascade:<model>`` in the step cache (on the card a CUDA graph
        whose static input the gathered clips are copied into). Returns
        (host outputs, device ms). The pool never goes to the host; the two
        int32 index vectors are the H2D aux bytes."""
        name = self._cfg.cascade_model
        spec, module = self._ensure_model(name)
        bucket = int(slot_idx.shape[0])
        side = pool.side
        label = f"cascade:{name}"
        key = (label, self._stem, (side, side), bucket)
        fn = self._steps.get(key)
        if fn is None:
            self._m_cache_miss.inc()
            build = functools.partial(_build_cascade_head, module, self._cfg.cascade_score_w,
                                      self._cfg.cascade_score_b)
            if self._cuda:
                graphed = _GraphedStep(
                    build, (bucket, pool.clip_len, side, side, 3), None, device=self._device,
                    pool=self._current_graph_pool,
                    on_capture=lambda seconds: self._note_graph(label, (side, side), bucket,
                                                                graphed),
                    on_capture_failed=self._retire_graph_pool)
                self._graphs.append(graphed)
                fn = graphed
            else:
                fn = _note_first_call(build(), lambda seconds, flops: self.perf.note_compile(
                    label, (side, side), bucket, seconds, cost={"flops": flops}))
            self._steps[key] = fn
        else:
            self._m_cache_hit.inc()
        t0 = time.perf_counter()
        start = done = None
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        outputs = fn(pool.gather(slot_idx, time_idx))
        if self._cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
        host = {k: v.cpu().numpy() for k, v in outputs.items()}
        device_ms = (start.elapsed_time(done) if self._cuda
                     else (time.perf_counter() - t0) * 1000.0)
        self.perf.note_h2d(f"cascade/{name}", bucket, int(slot_idx.nbytes + time_idx.nbytes), 0.0)
        # A head pass emits no frames: it stays out of the fps window.
        self.perf.note_batch(f"cascade/{name}", (side, side), bucket, device_ms, n_real,
                             streams=0)
        return host, device_ms

    def _cascade_tick(self) -> None:
        """One scheduler tick and its outcome: the ``temporal`` lineage span
        of each sampled track the head read, and each event out to the
        metrics, the uplink and the archive. Never raises: the detect path
        must not feel a cascade failure."""
        try:
            res = self._cascade.tick()
        except Exception:
            log.exception("cascade tick failed; continuing")
            return
        if self.capacity is not None and res.head_ms is not None:
            # The 1/N-cadence head's pass splits equally across its due
            # tracks' streams: raw cost in the ledger, cost / every_n in the
            # per-tick figure.
            side = self._cascade.side
            self.capacity.note_batch(
                f"cascade/{self._cfg.cascade_model}", (side, side),
                len(res.head_tracks) or 1, res.head_ms,
                [stream for stream, _ in res.head_tracks],
                kind="cascade", amortize_n=self._cfg.cascade_every_n)
        if tracer.enabled and res.head_ms is not None:
            t_now = time.time()
            for stream, meta in res.head_tracks:
                if meta is None or not tracer.sampled(meta.packet):
                    continue
                tracer.record(stream, "temporal", meta.packet, ts=t_now, dur_ms=res.head_ms,
                              trace_id=trace_id_of(meta, stream))
        for ev in res.events:
            self._cascade_emit_event(ev)

    def _cascade_emit_event(self, ev: dict) -> None:
        """One cascade event out three ways, each failing on its own: the
        ``vep_cascade_events_total`` metric (and the journal), an
        AnnotateRequest of ``type="cascade"`` on the uplink queue, and on
        "enter" the track's recent tiles to the archive as a clip
        segment."""
        kind = ev["kind"]
        self.perf.note_cascade_event(kind)
        meta = ev.get("meta")
        now_ms = int(time.time() * 1000)
        ts = meta.timestamp_ms if meta is not None and meta.timestamp_ms else now_ms
        if self.journal is not None:
            # The hysteresis already edge-triggers: one decision an event.
            self.journal.record("engine", f"cascade_{kind}", subject=("stream", str(ev["stream"])),
                                trigger={"track": str(ev["track_id"]),
                                         "score": round(float(ev["score"]), 4),
                                         "tick": int(ev["tick"])})
        log.info("cascade %s stream=%s track=%s score=%.3f tick=%d", kind, ev["stream"],
                 ev["track_id"], ev["score"], ev["tick"])
        if self._annotations is not None:
            try:
                req = AnnotateRequest(
                    device_name=ev["stream"], type="cascade", start_timestamp=ts,
                    object_type=f"anomaly_{kind}", object_tracking_id=str(ev["track_id"]),
                    confidence=float(ev["score"]), ml_model="temporal.cascade",
                    ml_model_version=self._cfg.cascade_model,
                    width=meta.width if meta is not None else 0,
                    height=meta.height if meta is not None else 0)
                self._annotations.publish(encode_annotation(req))
            except Exception:
                log.exception("cascade uplink publish failed")
        history = ev.get("history")
        if kind == "enter" and self._archiver is not None and history:
            try:
                from ..ingest.archive import GopSegment

                fps = max(1.0, 1000.0 / max(self._cfg.tick_ms, 1))
                dur_ms = int(len(history) * 1000.0 / fps)
                self._archiver.submit(GopSegment(device_id=f"cascade_{ev['stream']}",
                                                 start_ts_ms=ts - dur_ms, end_ts_ms=ts, fps=fps,
                                                 frames=list(history)))
            except Exception:
                log.exception("cascade archive trigger failed")

    def _forget_absent(self, present: Sequence[str]) -> None:
        """Drop the collector's cursor, geometry and clip window and the
        tracker, thumbnail, quality, ROI gate and cascade state of streams
        gone from the bus longer than the grace period (a producer
        re-creating its ring must not reset its stream's track ids). A
        stream's cascade tracks go without events: their rows free, their
        machines clear."""
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
                if self._roi is not None:
                    # The gate restarts with the stream: its first frame is full.
                    self._roi.pop(d, None)
                    self._roi_mode.pop(d, None)
                if self._cascade is not None:
                    self._cascade.pop(d, None)
            self._known.discard(d)
            del self._absent[d]

    def _watch_tick(self, inferred: Sequence[str] = ()) -> None:
        """Per-tick checks (obs/watch.py), each logged once per episode:
        drain backpressure and a recompile storm (a step-cache miss on 3+
        consecutive ticks: shapes churning faster than the cache warms).
        Then the SLO samples and the throttled evaluation, the device-memory
        plane's throttled evaluation, and the profiler's trigger poll (one
        capture per new SLO episode or escalation, rate-limited, on its own
        thread; idle: compares under a lock)."""
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
        if self.capacity is not None:
            # Throttled to capacity_eval_interval_s inside: between
            # refreshes a clock read and a compare.
            self.capacity.evaluate()
        if self.hbm is not None:
            self.hbm.evaluate()
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
                good = self.perf.fps() >= self._cfg.slo_target_fps
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
        at its first call; on the CPU the eager step. The build is noted in
        ``perf`` with its FLOPs (and, with ``cfg.hbm``, the graph's
        footprint in ``hbm``). A new key records its program in the prewarm
        manifest after its first call that returns."""
        src_hw = tuple(int(v) for v in src_hw)
        spec, module = self._model_entry(model)
        name = spec.name
        thumb = self._thumb_side(spec)
        key = (name, self._stem, src_hw, bucket)
        fn = self._steps.get(key)
        if fn is not None:
            self._m_cache_hit.inc()
            return fn
        self._m_cache_miss.inc()
        build = functools.partial(build_serving_step, module, spec, quality_thumb=thumb)
        graphed = None
        if self._cuda:
            shape = ((bucket,) + ((spec.clip_len,) if spec.clip_len else ()) + src_hw + (3,))
            graphed = _GraphedStep(
                build, shape, (thumb, thumb) if thumb else None,
                device=self._device, pool=self._current_graph_pool,
                on_capture=lambda seconds: self._note_graph(name, src_hw, bucket, graphed),
                on_capture_failed=self._retire_graph_pool,
                flops=(aot_cache.program_flops(self._aot_dir, model=name, stem=self._stem,
                                               src_hw=src_hw, bucket=bucket)
                       if self._aot_dir else None))
            self._graphs.append(graphed)
            fn = graphed
        else:
            fn = _note_first_call(build(), lambda seconds, flops: self.perf.note_compile(
                name, src_hw, bucket, seconds, cost={"flops": flops}))
        if self._aot_dir:
            fn = _record_after_first_success(fn, lambda: aot_cache.record_program(
                self._aot_dir, model=name, stem=self._stem, src_hw=src_hw, bucket=bucket,
                flops=graphed.flops if graphed is not None else None))
        self._steps[key] = fn
        return fn

    def _note_graph(self, name: str, src_hw: tuple, bucket: int, graph: _GraphedStep) -> None:
        """A key's graph was captured: its build and FLOPs into ``perf``,
        its footprint into ``hbm``."""
        self.perf.note_compile(name, src_hw, bucket, graph.capture_s,
                               cost={"flops": graph.flops})
        if self.hbm is not None:
            self.hbm.note_program(name, src_hw, bucket, {
                "argument_bytes": graph.input_bytes, "output_bytes": graph.output_bytes,
                "temp_bytes": graph.pool_growth}, stem=self._stem)

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
        is raised. A coast group (the ROI path's gated-idle streams) has no
        device work: it goes straight to the drain queue, behind the batches
        dispatched before it, so each stream's results keep their order."""
        if t_collect is None:
            t_collect = time.time()
        if self._roi is not None and groups:
            rest = []
            for g in groups:
                if g.coast is not None:
                    self._enqueue_drain(_Inflight(g, {}, t_collect, time.time()))
                else:
                    rest.append(g)
            groups = rest
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
                    self._xfer.unpark(pre)
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
                        self._xfer.unpark(handles[gj])
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
            self._m_occupancy.observe(100.0 * len(group.device_ids) / group.bucket)
            spec = self._model_entry(group.model)[0]
            # The frames (bucket padding included) and, for a model with
            # quality thumbnails, the int64 slot-index vector of the gather
            # (a canvas batch gathers none).
            aux = 8 * group.bucket if self._thumb_side(spec) and group.crops is None else 0
            self.perf.note_h2d(spec.name, group.bucket, int(group.frames.nbytes) + aux,
                               h2d_ms / 1000.0, hidden_s=overlapped_ms / 1000.0)
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
        """Queue one step on the compute stream after its input's copy.
        ``t_submit`` is taken after the step is queued, as in JAX, on the
        card; on the CPU, where the call runs the step, before it, so that
        submit -> drained (JAX's device time on the CPU) includes it."""
        start = done = None
        t_submit = time.time()
        if self._cuda:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            # The placed tensor was allocated on the transfer stream: its
            # memory must not be reused before the step has read it.
            placed.record_stream(stream)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        if self._thumb_side(self._model_entry(group.model)[0]) and group.crops is None:
            outputs = dict(step(placed, self._thumbs.gather(group.device_ids, group.bucket)))
            self._thumbs.scatter(group.device_ids, outputs.pop("quality_thumbs"))
        else:
            outputs = dict(step(placed))
            if group.crops is not None:
                # A canvas batch runs the same program, quality statistics
                # included; they mean nothing per stream (and its synthetic
                # _canvas<i> ids must not take thumbnail rows): dropped
                # before the read-back.
                outputs.pop("quality_stats", None)
                outputs.pop("quality_thumbs", None)
        if self._cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record(stream)
            t_submit = time.time()
        return _Inflight(group, outputs, t_collect, t_submit, start, done)

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

    def _threshold_of(self, spec) -> float:
        """The calibrated threshold rides the default model's checkpoint;
        per-stream extra models keep the NMS floor."""
        return self._conf_threshold if spec.name == self._spec.name else 0.0

    def _emit(self, inflight: _Inflight) -> None:
        group = inflight.group
        spec, module = self._model_entry(group.model)
        if inflight.warm is not None:
            try:
                self._read_back(inflight)
            finally:
                inflight.warm.set()
            return
        if group.coast is not None:
            self._emit_coast(inflight, spec)
            return
        t_drain0 = time.time()
        host = self._read_back(inflight)
        t_drained = time.time()
        # vep_device_batch_ms is the JAX engine's device time: submit ->
        # host fetch complete; device_ms is the step's own span on the card.
        self._m_device.labels(spec.name).observe((t_drained - inflight.t_submit) * 1000.0)
        if self._cuda:
            device_ms = inflight.start.elapsed_time(inflight.done)
        else:
            device_ms = (t_drained - inflight.t_submit) * 1000.0
        if group.crops is not None:
            # A canvas batch: the fps window counts the streams it served,
            # its occupancy is the crop-pixel share.
            self.perf.note_batch(
                spec.name, group.src_hw, group.bucket, device_ms, len(group.device_ids),
                streams=len({p.device_id for p in group.crops}),
                area_frac=CanvasPacker.area_fraction(group.crops, len(group.device_ids),
                                                     group.src_hw[0]))
            if self.capacity is not None:
                # Each stream's share is its crops' blitted canvas area.
                areas: Dict[str, int] = {}
                for p in group.crops:
                    a = (p.dst[2] - p.dst[0]) * (p.dst[3] - p.dst[1])
                    areas[p.device_id] = areas.get(p.device_id, 0) + a
                self.capacity.note_batch(spec.name, group.src_hw, group.bucket, device_ms,
                                         list(areas), weights=list(areas.values()), kind="roi")
            self._emit_canvas(inflight, host, spec, module, device_ms, t_drained)
            return
        if self.capacity is not None:
            # The bucket's cost, padded slots included, splits equally
            # across the real frames.
            self.capacity.note_batch(spec.name, group.src_hw, group.bucket, device_ms,
                                     group.device_ids)
        now_ms = int(t_drained * 1000)
        kind = spec.kind
        num_classes = module.cfg.num_classes
        slo_latency = (self.slo.get("detect_latency_p50")
                       if self.slo is not None and kind == "detect" else None)
        if self._roi is not None and kind == "detect" and group.frames.ndim == 4:
            # A full-frame detect batch while ROI serving is on: stamp the
            # refresh cadence (the gate's feedback) and count the streams
            # toward the equivalent-fps window.
            now_mono = time.monotonic()
            with self._state_lock:
                for device_id in group.device_ids:
                    self._roi.note_full(device_id, now_mono)
            self.perf.note_roi_emit(len(group.device_ids))
        capture_sum = 0.0
        track_s = 0.0
        harvest_s = 0.0
        for i, (device_id, meta) in enumerate(zip(group.device_ids, group.metas)):
            # Every record logged while this slot emits (tracker,
            # annotate, publish, quality) carries stream=<id> seq=<packet>.
            with log_context(stream=device_id, seq=meta.packet):
                detections = to_detections(host, i, kind, num_classes,
                                           self._threshold_of(spec))
                if self._cfg.track and kind == "detect":
                    # Empty frames too: misses must accumulate so stale tracks
                    # expire.
                    t_track = time.perf_counter()
                    self._assign_tracks(device_id, spec.name, detections)
                    track_s += time.perf_counter() - t_track
                    if self._cascade is not None and group.frames.ndim == 4:
                        # The cascade's harvest: each tracked detection's crop
                        # from the leased host frame (valid until this emit
                        # returns) into its track's tile.
                        t_harvest = time.perf_counter()
                        try:
                            self._cascade.harvest(device_id, group.frames[i], detections, meta)
                        except Exception:
                            log.exception("cascade harvest failed; continuing")
                        harvest_s += time.perf_counter() - t_harvest
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
                if latency > self._cfg.obs_late_ms:
                    self._m_late.labels(device_id).inc()
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
        self.perf.note_batch(spec.name, group.src_hw, group.bucket, device_ms, n)
        self._note_results(inflight, n, capture_sum, t_drained, device_ms, track_s, harvest_s)

    def _note_results(self, inflight: _Inflight, n: int, capture_sum: float, t_drained: float,
                      device_ms: float, track_s: float = 0.0, harvest_s: float = 0.0) -> None:
        """Fold one emitted batch's ``n`` results into the pipeline totals."""
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
            p.harvest_ms += harvest_s * 1000.0

    def _emit_coast(self, inflight: _Inflight, spec) -> None:
        """Emit a coast group (gated-idle streams): its detections were
        made at gate time on the tick thread (the tracker coasted); they go
        out with the per-stream semantics of a full frame's, and no device
        time."""
        group = inflight.group
        t_drained = time.time()
        now_ms = int(t_drained * 1000)
        capture_sum = 0.0
        for device_id, meta, detections in group.coast:
            with log_context(stream=device_id, seq=meta.packet):
                capture_sum += self._emit_stream_result(inflight, device_id, meta, detections,
                                                        spec, now_ms, 0.0, coasted=True)
        self.perf.note_roi_emit(len(group.coast))
        if self.capacity is not None:
            # A coasting stream costs 0 ms in the ledger, not "missing".
            self.capacity.note_coast([device_id for device_id, _, _ in group.coast])
        self._note_results(inflight, len(group.coast), capture_sum, t_drained, 0.0)

    def _emit_canvas(self, inflight: _Inflight, host: Dict[str, np.ndarray], spec, module,
                     device_ms: float, t_drained: float) -> None:
        """The scatter-back of a canvas batch: each canvas detection goes to
        the crop whose cell holds its center (cells never overlap: the
        packer keeps a gap), through that crop's exact inverse
        (``uncrop_boxes``), clipped to the crop's source rect, and is
        emitted with that crop's stream. A detection whose center lands in
        no cell (a background artifact, or the cell of a stream that
        spilled to the full-frame path) is counted and dropped: it never
        reaches the wrong stream."""
        group = inflight.group
        now_ms = int(t_drained * 1000)
        by_canvas: Dict[int, list] = {}
        results: Dict[str, tuple] = {}   # device_id -> (meta, [Detection])
        for p in group.crops:
            by_canvas.setdefault(p.canvas, []).append(p)
            results.setdefault(p.device_id, (p.meta, []))
        num_classes = module.cfg.num_classes
        thr = self._threshold_of(spec)
        for ci in range(len(group.device_ids)):
            cells = by_canvas.get(ci)
            if not cells:
                continue
            for j in np.nonzero(host["valid"][ci])[0]:
                if float(host["scores"][ci, j]) < thr:
                    continue
                bx = [float(v) for v in host["boxes"][ci, j]]
                cx = (bx[0] + bx[2]) / 2.0
                cy = (bx[1] + bx[3]) / 2.0
                cell = next((p for p in cells if p.contains(cx, cy)), None)
                if cell is None:
                    self.perf.note_roi_unrouted()
                    continue
                box = uncrop_boxes(np.asarray(bx, np.float32), scale=cell.scale,
                                   dst_origin=cell.dst[:2], src_origin=cell.src[:2])
                x1 = max(cell.src[0], min(float(box[0]), cell.src[2]))
                y1 = max(cell.src[1], min(float(box[1]), cell.src[3]))
                x2 = max(cell.src[0], min(float(box[2]), cell.src[2]))
                y2 = max(cell.src[1], min(float(box[3]), cell.src[3]))
                ix1, iy1, ix2, iy2 = (int(round(v)) for v in (x1, y1, x2, y2))
                cid = int(host["classes"][ci, j])
                results[cell.device_id][1].append(Detection(
                    box=BoundingBox(left=ix1, top=iy1, width=ix2 - ix1, height=iy2 - iy1),
                    confidence=float(host["scores"][ci, j]), class_id=cid,
                    class_name=class_name(cid, num_classes)))
        capture_sum = 0.0
        for device_id, (meta, detections) in results.items():
            with log_context(stream=device_id, seq=meta.packet):
                capture_sum += self._emit_stream_result(inflight, device_id, meta, detections,
                                                        spec, now_ms, device_ms)
        self.perf.note_roi_emit(len(results))
        self._note_results(inflight, len(results), capture_sum, t_drained, device_ms)

    def _emit_stream_result(self, inflight: _Inflight, device_id: str, meta, detections,
                            spec, now_ms: int, device_ms: float, coasted: bool = False) -> float:
        """The ROI path's twin of the classic emit's per-slot tail: the
        tracker, the quality plane (detections only: a canvas slot carries
        no per-stream frame statistics), the result, the annotations, the
        stats and the SLO sample. Coasted results skip the tracker (the gate
        advanced it; the detections are its tracks) and the device time.
        Returns the frame's capture -> collect ms (0 without a stamp)."""
        group = inflight.group
        if self._cfg.track and spec.kind == "detect" and not coasted:
            self._assign_tracks(device_id, spec.name, detections)
        if self.quality is not None:
            self.quality.observe(device_id, classes=[d.class_id for d in detections],
                                 scores=[d.confidence for d in detections])
        latency = max(0.0, now_ms - meta.timestamp_ms) if meta.timestamp_ms else 0.0
        self._publish(InferenceResult(
            device_id=device_id, timestamp=meta.timestamp_ms, model=spec.name,
            detections=detections, latency_ms=latency, batch_size=group.bucket,
            frame_packet=meta.packet, trace_id=meta.trace_id, parent_span=meta.parent_span,
        ))
        self._annotate(device_id, meta, detections, spec)
        st = self._stats.setdefault(device_id, StreamStats())
        st.frames += 1
        st.note_latency(latency)
        st.last_batch = group.bucket
        if not coasted:
            st.note_device(device_ms, group.padded_slots)
        st.last_emit_mono = time.monotonic()
        if self.slo is not None and spec.kind == "detect" and meta.timestamp_ms:
            ok = latency <= self._cfg.slo_latency_ms
            self.slo.get("detect_latency_p50").record(good=float(ok), bad=float(not ok))
        self._m_frames.labels(device_id).inc()
        self._m_latency.labels(device_id).observe(latency)
        if latency > self._cfg.obs_late_ms:
            self._m_late.labels(device_id).inc()
        if meta.timestamp_ms:
            return inflight.t_collect * 1000.0 - meta.timestamp_ms
        return 0.0

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
            if self._roi is not None:
                # The ROI gate's feedback: the next tick classifies the
                # stream on the diff energy just read (only full frames
                # carry it, so the refresh cadence keeps it alive).
                with self._state_lock:
                    self._roi.note_diff(device_id, float(qs[i, 2]))
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
        eligible = [d for d in detections
                    if d.confidence > 0.0 and (d.class_id >= 0 or d.embedding)]
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
                # Re-ID features ride the proto's object_signature.
                object_signature=list(det.embedding),
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
                # A slow subscriber loses results, never the engine; the
                # drops are counted (the drain thread is the only writer).
                self.subscriber_drops += 1
                self.subscriber_drops_by_stream[result.device_id] = (
                    self.subscriber_drops_by_stream.get(result.device_id, 0) + 1)
                self._m_sub_drops.labels(result.device_id).inc()
