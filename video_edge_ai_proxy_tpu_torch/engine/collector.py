"""Batch collector: N camera streams -> padded batches per tick.

Counterpart of ``video_edge_ai_proxy_tpu/engine/collector.py`` (its
single-chip fast path): each tick takes the newest unseen frame per stream
(latest-wins), groups the frames by source geometry, and pads each group
to the smallest covering batch bucket, so the serving step sees a small
closed set of shapes.

- **The pooled fast path.** A stream whose geometry is known from an
  earlier tick is read by the bus straight into a slot of a pooled batch
  buffer (``read_latest_into``): ring to batch in one memory pass, pages
  kept warm. Buffers come from ``alloc`` (pinned host memory on the card,
  so the H2D copy reads the pooled buffer itself and no second host copy
  is made). Under ``strict_lease`` a buffer backing an emitted group stays
  off-limits until ``release(group)``: the engine's dispatched batches
  outlive the tick that built them. Only the pool rows that may be dirty
  are zeroed (``_zero_pad_rows``).
- **Incremental assembly.** ``assemble_until`` plans the next tick's
  batches and copies each frame into its slot the moment its producer
  publishes, woken by the bus doorbell; ``collect`` at the tick boundary
  then only finalizes.
- **The generic path** takes first-sight streams, clips (a per-stream
  sliding window of the last ``clip_len`` frames, sampled once full; a new
  geometry or clip length starts a new window) and geometry drift, and
  joins them to the fast path on the next tick.
- ``set_bucket_cap`` hides the largest buckets (degradation-ladder rung
  ``bucket_downshift``), ``restrict`` limits the streams read.
- **Per-stream models.** With ``model_of`` (device_id -> ``(model,
  clip_len)``, or None for the default model), each stream is batched
  with the streams of its own model: groups are keyed by (model,
  geometry), a video model's streams sample clips of its own
  ``clip_len``, and ``inference_model: "none"`` (the resolver's
  ``("none", 0)``) gates the stream out of the batches and out of
  ``keep_streams_hot``, whatever its interest.
- **Interest gating.** With ``interest_of`` (device_id -> does anything
  consume this stream's results now), a stream whose interest lapsed
  keeps being inferred for ``active_window_s`` (the linger), then drops
  out of the batches (``partition``, ``inference_streams``) and out of
  ``keep_streams_hot``, which touches the bus's ``last_query`` key of the
  inferred streams only: the ingest worker of a gated stream stops
  decoding the frames between keyframes. A stream that never had interest
  is gated at once. Without ``interest_of`` nothing is gated.

- **ROI canvases.** ``CanvasPacker`` shelf-packs many streams' crops onto
  a few shared square canvases (the engine's ``roi`` path), each crop's
  provenance a ``CropPlacement``; ``staging_buffer`` hands the engine a
  pooled (pinned on the card) buffer for the canvas batch, leased like a
  collected group's.

- **Mesh-sharded layouts.** With ``shards`` > 1 (the engine's dp mesh)
  every batch is segmented into ``shards`` equal row ranges: a stream's
  frame lands in the segment of its slot (``stream_shard``, a stable
  crc32; after a device fault, the ``make_repin`` map the engine
  installs), each segment pads on its own, and ``BatchGroup.rows`` names
  each stream's row. Buckets that do not split evenly are dropped (with
  none left the collector serves unsharded). Shards = 1 keeps every path
  as it was.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..bus.interface import Frame, FrameBus, FrameMeta
from ..obs import registry as obs_registry
from ..obs.spans import trace_id_of, tracer

log = logging.getLogger("vep.torch.engine.collector")


def stream_shard(device_id: str, shards: int) -> int:
    """The stable stream -> mesh-slot assignment of data-parallel serving,
    the JAX package's: crc32 is the same on every platform and run, so a
    stream always lands on the same slot, where its thumbnail, tracker
    and cascade state live. Engine and collector must agree on it."""
    if shards <= 1:
        return 0
    return zlib.crc32(device_id.encode("utf-8")) % shards


def make_repin(base_shard_of, shards: int, dead):
    """The deterministic re-pin of a survivor-mesh failover, the JAX
    package's. ``base_shard_of`` is the routing live when the fault hit
    (``stream_shard`` bound to the old slot count, or an earlier
    failover's repin: composition covers cascaded faults), ``shards`` its
    slot count, ``dead`` the faulted slot indices. The survivors keep
    their old order in the rebuilt mesh (new slot i = the i-th surviving
    old slot, the same device), so a stream whose slot survives keeps
    that slot's new index (its state intact), and a stream whose slot died
    re-pins by highest-random-weight (rendezvous) hashing over the
    survivors: deterministic, spread evenly, and stable under further
    losses (only the streams of a newly dead slot move again)."""
    dead = frozenset(int(s) for s in dead)
    survivors = [s for s in range(int(shards)) if s not in dead]
    if not survivors:
        raise ValueError("no surviving shards to re-pin onto")
    new_index = {s: i for i, s in enumerate(survivors)}

    def repin(device_id: str) -> int:
        home = base_shard_of(device_id)
        idx = new_index.get(home)
        if idx is not None:
            return idx
        best = max(survivors, key=lambda t: zlib.crc32(f"{device_id}@{t}".encode("utf-8")))
        return new_index[best]

    return repin


@dataclass
class BatchGroup:
    """One shape-homogeneous batch."""

    src_hw: tuple            # (H, W) of the source frames
    device_ids: List[str]
    frames: np.ndarray       # [N, H, W, C] uint8, or [N, T, H, W, C] for clips
    metas: List[FrameMeta]
    bucket: int = 0          # padded batch size
    model: str = ""          # registry model the group runs
    lease: Optional[tuple] = None  # (pool shape, buffer index) under strict
                                   # leasing; Collector.release returns it
    # The ROI path (the engine's cfg.roi). ``crops``: the frames are packed
    # shared canvases, one CropPlacement per blitted crop, the provenance
    # the scatter-back routes canvas detections by. ``coast``: no device
    # work at all, a list of (device_id, meta, detections) of gated-idle
    # streams whose tracker-coasted results ride the drain queue, so each
    # stream's results keep their order. Both None on the classic path.
    crops: Optional[list] = None
    coast: Optional[list] = None
    # The mesh-sharded layout (Collector(shards=S)): ``rows[j]`` is the
    # frame row of ``device_ids[j]``; slot s owns rows [s * bucket / S,
    # (s + 1) * bucket / S), each segment zero-padded on its own. None:
    # the dense layout, row j is device_ids[j].
    rows: Optional[List[int]] = None

    @property
    def padded_slots(self) -> int:
        return max(0, self.bucket - len(self.device_ids))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest of the sorted ``buckets`` that holds ``n`` rows.
    Oversized batches are the caller's job (Collector.collect chunks to
    the largest bucket)."""
    bucket = next((b for b in buckets if b >= n), None)
    if bucket is None:
        raise ValueError(f"batch {n} exceeds max bucket {buckets[-1]}")
    return bucket


def host_empty(shape: tuple) -> np.ndarray:
    """The default batch-buffer allocation: pageable host memory."""
    return np.empty(shape, np.uint8)


@dataclass(frozen=True)
class CropPlacement:
    """Provenance of one crop blitted onto a shared canvas.

    The placement is an integer affine: the source rect ``src`` decimated
    by ``scale`` (source px per canvas px, a power of two) and blitted with
    its top-left corner at ``dst``'s origin, so the inverse
    (``ops/boxes.py`` ``uncrop_boxes``) is exact:
    ``src_px = (canvas_px - dst_origin) * scale + src_origin``."""

    device_id: str
    meta: FrameMeta          # the source frame's meta (timestamps, packet)
    canvas: int              # slot index within the canvas batch
    src: tuple               # (x0, y0, x1, y1) source-frame px (ints)
    dst: tuple               # (x0, y0, x1, y1) canvas px (ints)
    scale: int               # source px per canvas px (>= 1, power of 2)

    def contains(self, x: float, y: float) -> bool:
        """Does a canvas point land in this crop's cell? The scatter-back
        routes each detection by its center; cells never overlap (the
        packer keeps a gap between them)."""
        return self.dst[0] <= x < self.dst[2] and self.dst[1] <= y < self.dst[3]


class CanvasPacker:
    """Deterministic shelf packer: many streams' crops -> a few shared
    ``side`` x ``side`` uint8 canvases, as the JAX package packs them, byte
    for byte.

    Every canvas has one geometry, so a canvas batch is one more key of the
    engine's step cache. Order is deterministic (scaled height, then width,
    then stream id; first-fit shelves), so the same crops give the same
    canvases. A crop larger than a canvas is decimated by the smallest
    power-of-two stride that fits (a strided view: the inverse stays
    exact); a tiny one is inflated to ``min_crop``. ``gap`` background
    pixels separate cells, so a detection never straddles two streams'
    crops; the background is 114 gray, the letterbox's pad value."""

    def __init__(self, side: int = 640, gap: int = 8, max_canvases: int = 8,
                 min_crop: int = 16):
        self.side = int(side)
        self.gap = int(gap)
        self.max_canvases = int(max_canvases)
        self.min_crop = int(min_crop)

    def _fit_scale(self, w: int, h: int) -> int:
        scale = 1
        while (w + scale - 1) // scale > self.side or (h + scale - 1) // scale > self.side:
            scale *= 2
        return scale

    def pack(self, requests: Sequence[tuple],
             alloc: Optional[Callable[[int], np.ndarray]] = None):
        """``requests``: (device_id, meta, frame [H, W, 3] uint8, roi xyxy).

        Returns (canvases [K, side, side, 3] uint8, placements, overflow):
        one CropPlacement per packed crop, and the indices of the requests
        that did not fit within ``max_canvases`` (the engine sends their
        streams down the full-frame path). ``alloc(K)``, when given,
        returns the array (of at least K rows) the canvases are drawn in,
        e.g. a pinned staging buffer; rows past K are left as they are."""
        side, gap = self.side, self.gap
        prepared = []   # (sh, sw, scale, rect, request index)
        overflow: List[int] = []
        for ri, (_device_id, _meta, frame, roi) in enumerate(requests):
            fh, fw = frame.shape[0], frame.shape[1]
            x0 = max(0, min(int(roi[0]), fw - 1))
            y0 = max(0, min(int(roi[1]), fh - 1))
            x1 = max(x0 + 1, min(int(round(roi[2])), fw))
            y1 = max(y0 + 1, min(int(round(roi[3])), fh))
            # Tiny ROIs inflate to min_crop: the detector needs context.
            if x1 - x0 < self.min_crop:
                x1 = min(fw, x0 + self.min_crop)
                x0 = max(0, x1 - self.min_crop)
            if y1 - y0 < self.min_crop:
                y1 = min(fh, y0 + self.min_crop)
                y0 = max(0, y1 - self.min_crop)
            scale = self._fit_scale(x1 - x0, y1 - y0)
            sw = (x1 - x0 + scale - 1) // scale
            sh = (y1 - y0 + scale - 1) // scale
            prepared.append((sh, sw, scale, (x0, y0, x1, y1), ri))
        prepared.sort(key=lambda p: (-p[0], -p[1], requests[p[4]][0], p[4]))
        slots = []   # per-canvas shelf cursors: [x, y, shelf_h]
        blits = []   # (canvas, dst, rect, scale, request index)
        for sh, sw, scale, rect, ri in prepared:
            placed = False
            for ci, (x, y, shelf_h) in enumerate(slots):
                if x + sw > side:                     # next shelf
                    x, y, shelf_h = 0, y + shelf_h + gap, 0
                if x + sw <= side and y + sh <= side:
                    blits.append((ci, (x, y, x + sw, y + sh), rect, scale, ri))
                    slots[ci] = [x + sw + gap, y, max(shelf_h, sh)]
                    placed = True
                    break
            if not placed:
                if len(slots) < self.max_canvases:
                    ci = len(slots)
                    slots.append([sw + gap, 0, sh])
                    blits.append((ci, (0, 0, sw, sh), rect, scale, ri))
                else:
                    overflow.append(ri)
        k = len(slots)
        if alloc is None:
            canvases = np.full((k, side, side, 3), 114, np.uint8)
        else:
            canvases = alloc(k)[:k]
            canvases.fill(114)
        placements: List[CropPlacement] = []
        for ci, dst, rect, scale, ri in blits:
            device_id, meta, frame, _roi = requests[ri]
            x0, y0, x1, y1 = rect
            canvases[ci, dst[1]:dst[3], dst[0]:dst[2]] = frame[y0:y1:scale, x0:x1:scale]
            placements.append(CropPlacement(device_id=device_id, meta=meta, canvas=ci,
                                            src=rect, dst=dst, scale=scale))
        return canvases, placements, overflow

    @staticmethod
    def area_fraction(placements: Sequence[CropPlacement], n_canvases: int, side: int) -> float:
        """Crop-pixel share of a canvas batch: the crop-level occupancy
        ``obs/perf.py`` reports for packed batches."""
        if not n_canvases:
            return 0.0
        used = sum((p.dst[2] - p.dst[0]) * (p.dst[3] - p.dst[1]) for p in placements)
        return used / float(n_canvases * side * side)


class Collector:
    """Per-stream cursors, the batch pool, clip windows and per-tick batch
    assembly. ``clip_len`` > 0 (a video model) makes every sample of the
    default model a clip.
    ``alloc(shape)`` returns an uninitialised uint8 host array for batch
    buffers (default ``np.empty``)."""

    # Failsafe: a caller that leases but never releases would grow a
    # shape's pool without bound; past this many buffers per shape new
    # handouts are one-off, non-pooled buffers (lease None). The engine's
    # pipeline holds at most 6 (window, collect, 2 prefetched, 2 draining).
    MAX_POOL_BUFFERS = 8

    def __init__(self, bus: FrameBus, *, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 clip_len: int = 0, active_window_s: float = 10.0, default_model: str = "",
                 interest_of: Optional[Callable[[str], bool]] = None,
                 model_of: Optional[Callable[[str], Optional[tuple]]] = None,
                 strict_lease: bool = False,
                 alloc: Callable[[tuple], np.ndarray] = host_empty, shards: int = 1):
        self._bus = bus
        self._buckets = tuple(sorted(buckets))
        # The mesh-sharded layout: None routing = stream_shard; repin()
        # installs a failover's map.
        self._shards = 1
        self._shard_fn: Optional[Callable[[str], int]] = None
        if shards > 1:
            sharded = tuple(b for b in self._buckets if b % shards == 0)
            if sharded:
                self._shards = int(shards)
                self._buckets = sharded
            else:
                log.warning("no bucket in %s divides into %d shards; serving unsharded",
                            self._buckets, shards)
        self._bucket_cap: Optional[int] = None
        self.clip_len = clip_len
        self._default_model = default_model
        self._strict_lease = strict_lease
        self._alloc = alloc
        self._active_window_s = active_window_s
        self._interest_of = interest_of
        self._model_of = model_of
        self._last_interest: Dict[str, float] = {}   # device_id -> monotonic s
        self._cursors: Dict[str, int] = {}
        self._clips: Dict[str, deque] = {}
        self._geom: Dict[str, tuple] = {}    # last-seen (h, w, c) per stream
        # shape -> {"bufs": [array], "prev": set, "cur": [idx], "leased":
        # [idx in lease order], "fill": {idx: dirty rows}}
        self._pool: Dict[tuple, dict] = {}
        self._pool_lock = threading.Lock()   # release() runs on the drain thread
        self._window: Optional[dict] = None  # assemble_until's plan
        self._only: Optional[set] = None
        # Latest-wins supersessions are by design, invisible drops are not:
        # a cursor that jumps k > 1 sequence numbers skipped k - 1 frames.
        self._m_skipped = obs_registry.counter(
            "vep_frames_skipped_total",
            "Frames superseded before read (latest-wins drops)", ("stream",))

    # -- configuration -------------------------------------------------------

    def set_bucket_cap(self, cap: Optional[int]) -> None:
        """Cap the effective bucket list (ladder rung ``bucket_downshift``):
        ``cap=8`` hides buckets above 8 from the next collect on; None
        restores the full list."""
        self._bucket_cap = cap

    def _effective_buckets(self) -> tuple:
        cap = self._bucket_cap
        if cap is None:
            return self._buckets
        return tuple(b for b in self._buckets if b <= cap) or self._buckets[:1]

    def restrict(self, device_ids: Optional[Sequence[str]]) -> None:
        """Read only these streams from now on (None = all)."""
        self._only = set(device_ids) if device_ids else None

    def active_streams(self) -> List[str]:
        ids = self._bus.streams()
        if self._only is not None:
            ids = [d for d in ids if d in self._only]
        return sorted(ids)

    def _stream_model(self, device_id: str) -> tuple:
        """(model name, clip_len) of one stream: the resolver's answer, or
        the default model's."""
        if self._model_of is not None:
            resolved = self._model_of(device_id)
            if resolved:
                return resolved
        return self._default_model, self.clip_len

    def _gated(self, device_id: str) -> bool:
        """True when the stream must not be inferred this tick: its
        inference is switched off (``inference_model: "none"``), or nothing
        consumes its results and the ``active_window_s`` linger ran out
        (or it never had interest)."""
        if self._stream_model(device_id)[0] == "none":
            return True
        if self._interest_of is None:
            return False
        now = time.monotonic()
        if self._interest_of(device_id):
            self._last_interest[device_id] = now
            return False
        last = self._last_interest.get(device_id)
        return last is None or now - last >= self._active_window_s

    def partition(self) -> tuple:
        """One bus enumeration -> (present, inferred): every listed stream,
        and the subset the engine infers this tick. The engine's tick calls
        this once and hands the lists to keep_streams_hot, collect and its
        state GC."""
        present = self.active_streams()
        return present, [d for d in present if not self._gated(d)]

    def inference_streams(self) -> List[str]:
        """The streams the engine infers this tick."""
        return self.partition()[1]

    def keep_streams_hot(self, now_ms: Optional[int] = None,
                         device_ids: Optional[Sequence[str]] = None) -> List[str]:
        """Touch ``last_query`` of the inferred streams (``device_ids``, a
        set from ``partition``; None enumerates), as a client reading the
        stream would: their workers keep decoding every frame. A gated
        stream is not touched, so its worker falls back to keyframes."""
        ids = list(device_ids) if device_ids is not None else self.inference_streams()
        for device_id in ids:
            self._bus.touch_query(device_id, now_ms)
        return ids

    def drop_stream(self, device_id: str) -> None:
        self._cursors.pop(device_id, None)
        self._clips.pop(device_id, None)
        self._geom.pop(device_id, None)
        self._last_interest.pop(device_id, None)

    # -- cursors ---------------------------------------------------------------

    def _rebase_if_restarted(self, device_id: str) -> bool:
        """A producer that recreates its ring restarts sequence numbers below
        our cursor; a head strictly below the cursor is impossible on a
        monotonic ring, so it drops the cursor (callers retry the read in
        the same pass). Returns True when rebased."""
        cursor = self._cursors.get(device_id, 0)
        if cursor:
            head = self._bus.head(device_id)
            if head is not None and head < cursor:
                self._cursors.pop(device_id, None)
                return True
        return False

    def _note_read(self, device_id: str, seq: int, meta) -> None:
        """Every cursor advance: counts latest-wins skips and stamps the
        frame's ``collect`` lineage span, with ``pub_ms`` (the publish
        span lives in the worker's process, so the ingest -> collect leg
        must be computable from the engine's side alone)."""
        prev = self._cursors.get(device_id, 0)
        if prev and seq > prev + 1:
            self._m_skipped.labels(device_id).inc(seq - prev - 1)
        self._cursors[device_id] = seq
        if meta is not None and tracer.sampled(meta.packet):
            tracer.record(device_id, "collect", meta.packet, pub_ms=meta.timestamp_ms,
                          trace_id=trace_id_of(meta, device_id))

    # -- the batch pool --------------------------------------------------------

    def _begin_tick(self) -> None:
        """A new pool rotation epoch: buffers of the previous emitting tick
        stay off-limits, and the new tick's handouts accumulate so no two
        same-shape groups of one tick share a buffer."""
        with self._pool_lock:
            for slot in self._pool.values():
                if slot["cur"]:
                    slot["prev"] = set(slot["cur"])
                    slot["cur"] = []

    def _pooled(self, shape: tuple):
        """A pooled batch buffer for ``shape`` -> (array, pool index): not
        handed out this tick or the previous one, and not leased. At the
        cap with live leases it hands out a one-off buffer (index None)
        rather than steal a lease an in-flight batch may still read."""
        with self._pool_lock:
            slot = self._pool.get(shape)
            if slot is None:
                slot = {"bufs": [], "prev": set(), "cur": [], "leased": [], "fill": {}}
                self._pool[shape] = slot
            busy = set(slot["prev"])
            busy.update(slot["cur"])
            busy.update(slot["leased"])
            idx = next((i for i in range(len(slot["bufs"])) if i not in busy), None)
            if idx is None:
                if len(slot["bufs"]) >= self.MAX_POOL_BUFFERS and slot["leased"]:
                    log.warning("batch pool for shape %s hit %d buffers; handing out a "
                                "one-off buffer (a consumer is not calling "
                                "Collector.release)", shape, self.MAX_POOL_BUFFERS)
                    buf = self._alloc(shape)
                    buf.fill(0)
                    return buf, None
                buf = self._alloc(shape)
                buf.fill(0)
                slot["bufs"].append(buf)
                idx = len(slot["bufs"]) - 1
            slot["cur"].append(idx)
            return slot["bufs"][idx], idx

    def staging_buffer(self, shape: tuple) -> tuple:
        """A pooled buffer of ``shape`` for a batch the engine builds itself
        (the ROI canvases) -> (array, pool index). Every row counts as
        written. ``lease_staged(group, shape, idx)`` ties it to the group,
        so it is rewritten only after ``release(group)``."""
        buf, idx = self._pooled(shape)
        if idx is not None:
            with self._pool_lock:
                self._pool[shape]["fill"][idx] = shape[0]
        return buf, idx

    def lease_staged(self, group: BatchGroup, shape: tuple, idx) -> None:
        """Lease a ``staging_buffer`` to the group that carries it."""
        self._lease(group, shape, idx)

    def pool_nbytes(self) -> int:
        """Host bytes held by the pooled batch buffers."""
        with self._pool_lock:
            return sum(buf.nbytes for slot in self._pool.values() for buf in slot["bufs"])

    def _unrotate(self, shape: tuple) -> None:
        """No group came out of the last buffer handed out: give it back."""
        with self._pool_lock:
            slot = self._pool[shape]
            if slot["cur"]:
                slot["cur"].pop()

    def _lease(self, group: BatchGroup, shape: tuple, idx) -> None:
        """Under strict leasing, tie the group to its pooled buffer until
        release(group); a one-off buffer (idx None) has nothing to lease."""
        if not self._strict_lease or idx is None:
            return
        with self._pool_lock:
            self._pool[shape]["leased"].append(idx)
            group.lease = (shape, idx)

    def release(self, group: BatchGroup) -> None:
        """Return a leased group's buffer to the pool, once nothing can read
        its host frames any more. No-op for unleased groups and repeats."""
        if group.lease is None:
            return
        shape, idx = group.lease
        group.lease = None
        with self._pool_lock:
            slot = self._pool.get(shape)
            if slot is not None and idx in slot["leased"]:
                slot["leased"].remove(idx)

    def _zero_pad_rows(self, buf: np.ndarray, shape: tuple, idx, n: int,
                       touched: int) -> None:
        """Zero only the rows of a pooled buffer that may be dirty: the pool
        keeps a per-buffer high-water mark of written rows, so a steady
        16-stream batch re-zeroes nothing. ``touched`` is one past the
        highest slot any read of this tick targeted (a read that did not
        join the batch may still have written its slot). After this, rows
        >= n are zero."""
        if idx is None:
            return
        touched = min(max(touched, n), buf.shape[0])
        with self._pool_lock:
            fill = self._pool[shape]["fill"]
            dirty = max(fill.get(idx, 0), touched)
            fill[idx] = n
        if dirty > n:
            buf[n:dirty] = 0

    def _zero_pad_rows_sharded(self, buf: np.ndarray, shape: tuple, idx, real: set,
                               bucket: int, touched: int) -> None:
        """The sharded twin of _zero_pad_rows: the padding is interleaved
        (each segment pads on its own), so the dirty rows are every row of
        the dirty extent without a real frame. After this, rows >= bucket
        are zero (fill == bucket) and so are the pad rows inside the
        view."""
        touched = min(max(touched, bucket), buf.shape[0])
        dirty = touched
        if idx is not None:
            with self._pool_lock:
                fill = self._pool[shape]["fill"]
                dirty = max(fill.get(idx, 0), touched)
                fill[idx] = bucket
        for r in range(dirty):
            if r not in real:
                buf[r] = 0

    def _finish_sharded(self, buf: np.ndarray, shape: tuple, idx, per: List[list],
                        seg_src: int, bucket: int, touched: int, *, src_hw: tuple,
                        model: str) -> BatchGroup:
        """Compact each slot's rows from the allocation's spacing
        (``seg_src`` rows a slot) to the final bucket's, zero the dirty pad
        rows and build the shard-segmented group. ``per[s]`` is slot s's
        (device_id, meta) list in read order. With seg <= seg_src the
        destination s * seg + i never passes the source s * seg_src + i,
        and ascending (s, i) reads every source before a later destination
        can land on it. One slot is the dense layout: nothing moves, the
        pad rows are the tail and ``rows`` is None."""
        seg = bucket // self._shards
        ids: List[str] = []
        metas: List[FrameMeta] = []
        rows: List[int] = []
        real: set = set()
        for s, entries in enumerate(per):
            for i, (device_id, meta) in enumerate(entries):
                old = s * seg_src + i
                new = s * seg + i
                if new != old:
                    buf[new] = buf[old]
                ids.append(device_id)
                metas.append(meta)
                rows.append(new)
                real.add(new)
        if self._shards > 1:
            self._zero_pad_rows_sharded(buf, shape, idx, real, bucket, touched)
        else:
            self._zero_pad_rows(buf, shape, idx, len(ids), touched)
        group = BatchGroup(src_hw=src_hw, device_ids=ids, frames=buf[:bucket], metas=metas,
                           bucket=bucket, model=model,
                           rows=rows if self._shards > 1 else None)
        self._lease(group, shape, idx)
        return group

    def _by_shard(self, devs: Sequence) -> List[list]:
        """Split streams (or (device_id, ...) tuples) into per-slot lists,
        in order within each slot."""
        if self._shards == 1:
            return [list(devs)]
        out: List[list] = [[] for _ in range(self._shards)]
        fn = self._shard_fn
        for item in devs:
            did = item if isinstance(item, str) else item[0]
            s = stream_shard(did, self._shards) if fn is None else fn(did)
            out[s % self._shards].append(item)
        return out

    def _sharded_bucket(self, need: int, buckets: Sequence[int]) -> int:
        """The smallest bucket whose per-slot segment holds ``need`` rows."""
        return next(b for b in buckets if b // self._shards >= need)

    def repin(self, *, shards: int, shard_of=None,
              buckets: Optional[Sequence[int]] = None) -> None:
        """Swap the slot count and the routing in one tick-thread call: the
        mesh at warmup (``shard_of`` None: ``stream_shard``) and a
        survivor-mesh failover (a ``make_repin`` map; engine and collector
        must share it). The live assembly window is dropped: its plan was
        laid out under the old routing; its frames are still on their
        rings and the next tick reads them (latest-wins, nothing lost).
        ``buckets`` replaces the bucket list; those the new slot count
        does not divide are dropped."""
        self._window = None
        self._shards = max(1, int(shards))
        self._shard_fn = shard_of if self._shards > 1 else None
        if buckets is not None:
            sharded = tuple(sorted(b for b in buckets if b % self._shards == 0))
            if sharded:
                self._buckets = sharded

    # -- incremental assembly (between ticks) ----------------------------------

    def assemble_until(self, deadline: float, device_ids: Optional[Sequence[str]] = None,
                       stop_event=None) -> None:
        """Until ``deadline`` (time.monotonic), copy each planned stream's
        frame into its pooled slot as soon as it is published, woken by the
        bus doorbell; a bus without a doorbell just waits out the deadline
        and leaves the reads to collect()."""
        remaining = deadline - time.monotonic()
        if not getattr(self._bus, "doorbell", False):
            if remaining > 0:
                if stop_event is not None:
                    stop_event.wait(remaining)
                else:
                    time.sleep(remaining)
            return
        if remaining <= 0:
            return
        self.plan_assembly(device_ids)
        token = self._bus.doorbell_token()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            if stop_event is not None and stop_event.is_set():
                return
            token = self._bus.doorbell_wait(token, min(remaining, 0.1))
            self.assemble_step()

    def plan_assembly(self, device_ids: Optional[Sequence[str]] = None) -> None:
        """Lay out the next tick's fast-path batches: grouping and bucket
        chunking as in collect(), a pooled buffer per group. Streams of
        unknown geometry and clip streams stay unplanned."""
        if device_ids is None:
            device_ids = self.inference_streams()
        buckets = self._effective_buckets()
        max_bucket = buckets[-1]
        plan: Dict[tuple, list] = {}
        for device_id in device_ids:
            model, clip_len = self._stream_model(device_id)
            geom = self._geom.get(device_id)
            if not clip_len and geom is not None:
                plan.setdefault((model, geom), []).append(device_id)
        groups: Dict[tuple, dict] = {}
        of: Dict[str, tuple] = {}
        shard_of: Dict[str, int] = {}
        cap = max_bucket // self._shards
        for (model, geom), devs in sorted(plan.items()):
            # Shard-segmented window groups: a chunk fills when its fullest
            # slot fills, and a stream's row is pinned inside its slot's
            # segment (one slot: the dense layout).
            by_shard = self._by_shard(devs)
            n_chunks = max(((len(l) + cap - 1) // cap for l in by_shard if l), default=0)
            for ci in range(n_chunks):
                chunk = [l[ci * cap:(ci + 1) * cap] for l in by_shard]
                alloc = self._sharded_bucket(max(len(l) for l in chunk), buckets)
                shape = (alloc,) + geom
                buf, bidx = self._pooled(shape)
                key = (model, geom, ci)
                groups[key] = {"model": model, "geom": geom, "shape": shape, "buf": buf,
                               "idx": bidx, "per": [[] for _ in range(self._shards)],
                               "entry": {}, "slot": {}, "seg": alloc // self._shards,
                               "hw": 0}
                for s, shard_devs in enumerate(chunk):
                    for device_id in shard_devs:
                        of[device_id] = key
                        shard_of[device_id] = s
        self._window = {"groups": groups, "of": of, "spill": [], "shard": shard_of}

    def assemble_step(self) -> int:
        """One pass over the planned streams: copy any newly published frame
        into its group's next free slot (a second publish within the window
        overwrites the stream's slot). Returns how many frames were copied."""
        win = self._window
        if win is None:
            return 0
        got = 0
        drifted: List[str] = []
        for device_id, key in win["of"].items():
            cursor = self._cursors.get(device_id, 0)
            head = self._bus.head(device_id)
            if head is not None and head < cursor:
                self._cursors.pop(device_id, None)   # ring recreated under us
                cursor = 0
            if head is not None and head <= cursor:
                continue   # idle ring: one cheap load
            g = win["groups"][key]
            slot = g["slot"].get(device_id)
            s = win["shard"][device_id]
            t = slot if slot is not None else g["seg"] * s + len(g["per"][s])
            g["hw"] = max(g["hw"], t + 1)
            res = self._bus.read_latest_into(device_id, g["buf"][t], min_seq=cursor)
            if res is None:
                continue
            if isinstance(res, Frame):   # geometry drifted mid-window
                self._note_read(device_id, res.seq, res.meta)
                if res.data.ndim == 3:
                    self._geom[device_id] = res.data.shape
                win["spill"].append((device_id, g["model"], res))
                drifted.append(device_id)
                continue
            seq, meta = res
            self._note_read(device_id, seq, meta)
            if slot is None:
                g["slot"][device_id] = t
                g["entry"][device_id] = (s, len(g["per"][s]))
                g["per"][s].append((device_id, meta))
            else:
                es, ei = g["entry"][device_id]
                g["per"][es][ei] = (device_id, meta)
            got += 1
        for device_id in drifted:
            del win["of"][device_id]
        return got

    # -- the tick ----------------------------------------------------------------

    def _clip(self, device_id: str, frame: Frame, clip_len: int) -> "deque | None":
        """Append ``frame`` to the stream's window; the full window once it
        holds clip_len frames, else None."""
        window = self._clips.get(device_id)
        if window is None or window.maxlen != clip_len:
            # (Re)create on a clip-length change: no stale window carries over.
            window = deque(maxlen=clip_len)
            self._clips[device_id] = window
        if window and window[-1].data.shape != frame.data.shape:
            window.clear()      # a geometry change starts a new clip
        window.append(frame)
        return window if len(window) == clip_len else None

    def collect(self, device_ids: Optional[Sequence[str]] = None) -> List[BatchGroup]:
        """One tick: newest unseen frame per stream -> geometry-grouped,
        bucket-padded batches of frames, or of clips for a video model (a
        group larger than the biggest bucket is split into chunks of that
        size). ``device_ids``: the streams to read (None = the streams
        ``inference_streams`` returns)."""
        if device_ids is None:
            device_ids = self.inference_streams()
        self._begin_tick()
        buckets = self._effective_buckets()
        groups: List[BatchGroup] = []
        spill: List[tuple] = []
        planned: set = set()
        win = self._window
        if win is not None:
            # Finalize the assembly window: one catch-up sweep, then the
            # incrementally filled batches as they are.
            self.assemble_step()
            self._window = None
            planned = set(win["of"])
            spill.extend(win["spill"])
            for _, g in sorted(win["groups"].items()):
                counts = [len(p) for p in g["per"]]
                if any(counts):
                    # The full bucket list: the window's buffer predates any
                    # cap and its size is a member of the full list.
                    groups.append(self._finish_sharded(
                        g["buf"], g["shape"], g["idx"], g["per"], g["seg"],
                        self._sharded_bucket(max(counts), self._buckets), g["hw"],
                        src_hw=g["geom"][:2], model=g["model"]))

        fast: Dict[tuple, list] = {}
        slow: List[str] = []
        for device_id in device_ids:
            if device_id in planned:
                continue
            model, clip_len = self._stream_model(device_id)
            geom = self._geom.get(device_id)
            if clip_len or geom is None:
                slow.append(device_id)
            else:
                fast.setdefault((model, geom), []).append(device_id)

        for (model, geom), devs in sorted(fast.items()):
            self._collect_fast(model, geom, devs, buckets, groups, spill)

        # The generic path: first sight, clips, drift.
        by_hw: Dict[tuple, list] = {}
        for device_id in slow:
            frame = self._bus.read_latest(device_id, min_seq=self._cursors.get(device_id, 0))
            if frame is None and self._rebase_if_restarted(device_id):
                frame = self._bus.read_latest(device_id, min_seq=0)
            if frame is None:
                continue
            self._note_read(device_id, frame.seq, frame.meta)
            if frame.data.ndim != 3:
                continue    # a corrupt frame carries no geometry to batch on
            self._geom[device_id] = frame.data.shape
            model, clip_len = self._stream_model(device_id)
            sample = self._clip(device_id, frame, clip_len) if clip_len else frame.data
            if sample is not None:
                by_hw.setdefault((model, clip_len, frame.data.shape), []).append(
                    (device_id, frame.meta, sample))
        for device_id, model, frame in spill:
            if frame.data.ndim == 3:
                by_hw.setdefault((model, 0, frame.data.shape), []).append(
                    (device_id, frame.meta, frame.data))
        for (model, clip_len, shape), items in sorted(by_hw.items()):
            self._collect_generic(model, clip_len, shape, items, buckets, groups)
        return groups

    def _collect_fast(self, model: str, geom: tuple, devs: Sequence[str], buckets: tuple,
                      groups: List[BatchGroup], spill: List[tuple]) -> None:
        """The fast path (the JAX collector's ``_collect_fast_sharded`` and
        its dense loop): one (model, geometry) stream set -> pooled,
        bucket-padded, shard-segmented batches (one slot: dense), chunked to
        the largest bucket. Each stream is read straight into its slot's
        segment at the allocation's spacing; the final bucket is the
        smallest whose segment holds the fullest slot, and _finish_sharded
        compacts the segments to it."""
        S = self._shards
        cap = buckets[-1] // S
        by_shard = self._by_shard(devs)
        n_chunks = max(((len(l) + cap - 1) // cap for l in by_shard if l), default=0)
        for c in range(n_chunks):
            chunk = [l[c * cap:(c + 1) * cap] for l in by_shard]
            alloc = self._sharded_bucket(max(len(l) for l in chunk), buckets)
            shape = (alloc,) + geom
            batch, bidx = self._pooled(shape)
            seg_a = alloc // S
            per: List[list] = [[] for _ in range(S)]
            touched = 0
            for s, shard_devs in enumerate(chunk):
                for device_id in shard_devs:
                    t = s * seg_a + len(per[s])
                    touched = max(touched, t + 1)
                    cursor = self._cursors.get(device_id, 0)
                    res = self._bus.read_latest_into(device_id, batch[t], min_seq=cursor)
                    if res is None and self._rebase_if_restarted(device_id):
                        res = self._bus.read_latest_into(device_id, batch[t], min_seq=0)
                    if res is None:
                        continue
                    if isinstance(res, Frame):   # geometry drifted
                        self._note_read(device_id, res.seq, res.meta)
                        if res.data.ndim == 3:
                            self._geom[device_id] = res.data.shape
                        spill.append((device_id, model, res))
                        continue
                    seq, meta = res
                    self._note_read(device_id, seq, meta)
                    per[s].append((device_id, meta))
            counts = [len(p) for p in per]
            if not any(counts):
                if bidx is not None:
                    self._unrotate(shape)
                continue
            groups.append(self._finish_sharded(
                batch, shape, bidx, per, seg_a, self._sharded_bucket(max(counts), buckets),
                touched, src_hw=geom[:2], model=model))

    def _collect_generic(self, model: str, clip_len: int, shape: tuple,
                         items: Sequence[tuple], buckets: tuple,
                         groups: List[BatchGroup]) -> None:
        """The generic path (first sight, clips, drift; the JAX collector's
        ``_collect_generic_sharded`` and its dense loop): a fresh buffer,
        each sample written at the final bucket's spacing, so nothing
        compacts, and each segment's tail zeroed (one slot: dense)."""
        S = self._shards
        cap = buckets[-1] // S
        by_shard = self._by_shard(items)
        n_chunks = max(((len(l) + cap - 1) // cap for l in by_shard if l), default=0)
        sample_shape = ((clip_len,) + shape) if clip_len else shape
        for c in range(n_chunks):
            chunk = [l[c * cap:(c + 1) * cap] for l in by_shard]
            bucket = self._sharded_bucket(max(len(l) for l in chunk), buckets)
            seg = bucket // S
            batch = self._alloc((bucket,) + sample_shape)
            ids: List[str] = []
            metas: List[FrameMeta] = []
            rows: List[int] = []
            for s, shard_items in enumerate(chunk):
                for i, (device_id, meta, sample) in enumerate(shard_items):
                    r = s * seg + i
                    if clip_len:
                        for t, f in enumerate(sample):
                            batch[r, t] = f.data
                    else:
                        batch[r] = sample
                    ids.append(device_id)
                    metas.append(meta)
                    rows.append(r)
                if len(shard_items) < seg:
                    batch[s * seg + len(shard_items):(s + 1) * seg] = 0
            groups.append(BatchGroup(src_hw=shape[:2], device_ids=ids, frames=batch,
                                     metas=metas, bucket=bucket, model=model,
                                     rows=rows if S > 1 else None))
