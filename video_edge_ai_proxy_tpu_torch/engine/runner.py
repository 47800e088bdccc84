"""Serving step and a slim inference engine (counterpart of ``video_edge_ai_proxy_tpu/engine/runner.py``).

``build_serving_step`` is the single source of truth for the per-tick
device program of a model: uint8 frames (or clips) in, postprocessed
results out. Detectors: letterbox -> YOLOv8 ``decode="serving"`` ->
sigmoid of the per-anchor max logit -> batched NMS through the CUDA
keep-mask kernel -> unletterbox. Classifiers and video models: stretch
resize + ImageNet normalisation -> ViT / VideoMAE (long clips through the
CUDA flash-attention kernel) -> float32 softmax -> top-5. Frame models
add the frame-quality statistics. The engine runs it per (geometry,
bucket); ``chip_smoke.py`` times it.

``InferenceEngine`` is the tick loop around it: collect -> H2D of uint8
from pinned host memory -> cached step -> D2H -> emit per stream, with the
per-stream quality thumbnails carried across ticks on the device. Results
are plain dataclasses with the proto's field names. The prefetch stage,
the drain thread, CUDA graphs, the tracker, shedding, the degradation
ladder, the SLO/observability planes, ROI, cascade and the gRPC surface
are later slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..bus.interface import FrameBus
from ..device import resolve_device
from ..models import registry
from ..ops.nms import _top, batched_nms, nms_keep_mask
from ..ops.preprocess import (
    frame_quality_stats, preprocess_classify, preprocess_clip, preprocess_letterbox,
    unletterbox_boxes,
)
from ..utils.config import EngineConfig
from .classes import class_name
from .collector import BatchGroup, Collector

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


@dataclass
class InferenceResult:
    device_id: str = ""
    timestamp: int = 0            # capture timestamp of the source frame (ms)
    model: str = ""
    detections: List[Detection] = field(default_factory=list)
    latency_ms: float = 0.0       # capture -> result latency
    batch_size: int = 0           # device batch this frame rode in
    frame_packet: int = 0         # source packet counter


@dataclass
class StreamStats:
    frames: int = 0
    last_latency_ms: float = 0.0
    last_batch: int = 0


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


class InferenceEngine:
    """Tick loop serving one model over every stream of a frame bus: a
    detector or classifier on each stream's newest frame, a video model on
    each stream's clip window once it is full.

    ``model``: an ``nn.Module`` already on ``device`` (e.g. with loaded
    weights); None builds the registry model with random weights at
    ``warmup``. ``device`` defaults to the card and raises without one.
    """

    def __init__(self, bus: FrameBus, cfg: Optional[EngineConfig] = None, *,
                 device: "str | torch.device" = "cuda",
                 model: Optional[torch.nn.Module] = None):
        self._device = resolve_device(device)
        self._cfg = cfg or EngineConfig()
        self._spec = registry.get(self._cfg.model)
        self._dtype = getattr(torch, self._cfg.dtype)
        self._model = model
        self._collector = Collector(bus, buckets=self._cfg.batch_buckets,
                                    clip_len=self._spec.clip_len)
        # Thumbnails (quality statistics) only for frame models.
        self._thumb = 0 if self._spec.clip_len else self._cfg.quality_thumb
        self._steps: Dict[tuple, Callable] = {}
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._thumbs: Dict[str, torch.Tensor] = {}
        self._stats: Dict[str, StreamStats] = {}
        self._subscribers: list = []
        self._sub_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> None:
        """Build the model (random weights unless one was given) and, on
        the card, the CUDA kernels, so the first tick does not stall."""
        if self._model is None:
            self._model = self._spec.init_params(device=self._device, dtype=self._dtype)
        if self._device.type == "cuda":
            from ..kernels.build import build_all

            build_all()

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="vep-torch-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the tick loop and end every subscription. Raises if the
        loop died of an error."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("engine loop did not stop")
            self._thread = None
        with self._sub_lock:
            for q, _ in self._subscribers:
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass    # the reader sees the stop flag on its next wait
        if self._error is not None:
            raise RuntimeError("engine loop failed") from self._error

    # -- consumers ---------------------------------------------------------

    def subscribe(self, device_ids=None, timeout: float = 0.5):
        """Iterator of InferenceResult for ``device_ids`` (None = all). The
        subscription starts when this is called; the iterator ends when the
        engine stops."""
        q: queue.Queue = queue.Queue(maxsize=256)
        ids = set(device_ids) if device_ids else None
        with self._sub_lock:
            self._subscribers.append((q, ids))
        return self._drain(q, timeout)

    def _drain(self, q: queue.Queue, timeout: float):
        try:
            while True:
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

    def stats(self) -> Dict[str, StreamStats]:
        """Per-stream snapshot copies."""
        return {d: StreamStats(st.frames, st.last_latency_ms, st.last_batch)
                for d, st in list(self._stats.items())}

    # -- tick loop ---------------------------------------------------------

    def _loop(self) -> None:
        tick_s = self._cfg.tick_ms / 1000.0
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            with torch.inference_mode():
                while not self._stop.is_set():
                    t0 = time.monotonic()
                    for group in self._collector.collect():
                        self._serve(group)
                    self._stop.wait(max(0.0, tick_s - (time.monotonic() - t0)))
        except Exception as exc:  # the loop's boundary: record, report, end
            log.exception("engine tick failed")
            self._error = exc

    def _step(self, src_hw: tuple, bucket: int) -> Callable:
        key = (src_hw, bucket)
        fn = self._steps.get(key)
        if fn is None:
            fn = build_serving_step(self._model, self._spec, quality_thumb=self._thumb)
            self._steps[key] = fn
        return fn

    def _to_device(self, frames: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(frames)
        if self._device.type != "cuda":
            return host
        # Pinned staging slot per batch shape. Reusing it is safe: the
        # previous group's D2H read-back waited for everything queued
        # before it on the stream, this copy included.
        buf = self._pinned.get(frames.shape)
        if buf is None:
            buf = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
            self._pinned[frames.shape] = buf
        buf.copy_(host)
        return buf.to(self._device, non_blocking=True)

    def _serve(self, group: BatchGroup) -> None:
        step = self._step(group.src_hw, group.bucket)
        frames = self._to_device(group.frames)
        if self._thumb:
            side = self._thumb
            zero = torch.zeros((side, side), dtype=torch.float32, device=self._device)
            prev = [self._thumbs.get(d, zero) for d in group.device_ids]
            prev += [zero] * group.padded_slots
            out = step(frames, torch.stack(prev))
            for i, d in enumerate(group.device_ids):
                self._thumbs[d] = out["quality_thumbs"][i]
        else:
            out = step(frames)
        host = {k: v.cpu().numpy() for k, v in out.items() if k != "quality_thumbs"}
        now_ms = time.time() * 1000.0
        num_classes = self._model.cfg.num_classes
        for i, (device_id, meta) in enumerate(zip(group.device_ids, group.metas)):
            latency = now_ms - meta.timestamp_ms if meta.timestamp_ms else 0.0
            result = InferenceResult(
                device_id=device_id, timestamp=meta.timestamp_ms,
                model=self._spec.name,
                detections=to_detections(host, i, self._spec.kind, num_classes),
                latency_ms=latency, batch_size=group.bucket,
                frame_packet=meta.packet,
            )
            st = self._stats.setdefault(device_id, StreamStats())
            st.frames += 1
            st.last_latency_ms = latency
            st.last_batch = group.bucket
            self._publish(result)

    def _publish(self, result: InferenceResult) -> None:
        with self._sub_lock:
            targets = [q for q, ids in self._subscribers
                       if ids is None or result.device_id in ids]
        for q in targets:
            try:
                q.put_nowait(result)
            except queue.Full:
                pass    # a slow subscriber loses results, never the engine
