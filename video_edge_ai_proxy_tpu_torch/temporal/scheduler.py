"""Cascade scheduler: detect every tick, the temporal head every N
(counterpart of ``video_edge_ai_proxy_tpu/temporal/scheduler.py``).

The detect step runs every tick unchanged; the scheduler taps its emitted
detections (``harvest``, on the drain thread), letterboxes each tracked
detection's box through a one-crop ``CanvasPacker`` into a ``side`` x
``side`` tile keyed by track ("stream#track_id"), appends the tile to that
track's device clip ring (``TrackStatePool``) at the next ``tick``, and
every ``every_n`` ticks (times ``stretch`` under pressure) runs the head
over every track holding a full clip, then its event hysteresis. The
detect step never branches on the cascade.

Threads: ``harvest`` runs on the engine's drain thread, ``tick`` on its
tick thread, the stream GC's ``pop`` under the engine's state lock; one
internal lock serialises them and is released around the head, so a head
that captures its graph never stalls the emit.

The head belongs to the engine (it needs the registry, the step cache and
the device accounting): the engine sets ``self.head`` to a callable
``(pool, slot_idx, time_idx, n_real) -> (outputs, device_ms)``, outputs
host arrays ``event_score [bucket]``, ``features [bucket, 3]`` and
``logits [bucket, num_classes]``. The pool tensor never goes to the host.

Under the engine's mesh of device slots (``configure_mesh``) the clip
rings are per slot (``ShardedTrackStatePool``): a track's clips live on
the slot that serves its stream, the head batch is shard-segmented
(``plan``) and each slot's rows run on its own device. A survivor-mesh
failover resets the sharded state, counted (``repin_mesh``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .events import TrackEventTracker
from .state_pool import ShardedTrackStatePool, TrackStatePool

log = logging.getLogger("vep.torch.temporal.scheduler")

# Head and scatter batch buckets (slot counts); due tracks past the
# largest wait for the next cadence tick.
BUCKETS = (4, 8, 16, 32, 64)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


@dataclass
class _Track:
    """Host-side record of a track; its clip lives in the device pool."""

    stream: str
    track_id: str
    tile: Optional[np.ndarray] = None      # latest [side, side, 3] uint8
    updated: bool = False                  # tile waiting for the scatter
    placement: object = None               # CropPlacement provenance
    meta: object = None                    # the source frame's FrameMeta
    last_seen: int = 0                     # scheduler tick of the last harvest
    last_score: Optional[float] = None
    observed: int = 0                      # head passes consumed
    history: deque = field(default_factory=deque)  # archive tiles


@dataclass
class CascadeTickResult:
    """One tick's outcome, read by the engine."""

    events: List[dict]
    head_tracks: List[Tuple[str, object]]  # (stream, meta) per due track
    head_ms: Optional[float]


class CascadeScheduler:
    """Tracker-keyed temporal state, cadence dispatch and event machines.
    ``device``: where the clip ring lives (the engine's device)."""

    def __init__(self, *, model: str, every_n: int = 4, crop: int = 0, clip_len: int = 0,
                 threshold: float = 0.5, enter_n: int = 2, exit_n: int = 2,
                 ttl_ticks: int = 30, perf=None, history_keep: int = 0, events_keep: int = 64,
                 device="cuda"):
        self.model = str(model)
        self.every_n = max(1, int(every_n))
        # The cadence stretch: the head runs every every_n * stretch ticks;
        # the engine raises it while its ladder is off "normal".
        self.stretch = 1
        self._crop = int(crop)
        self._clip_len = int(clip_len)
        self.ttl_ticks = max(1, int(ttl_ticks))
        self.perf = perf
        self._device = device
        self._history_keep = int(history_keep)
        self._lock = threading.Lock()
        self._tracks: Dict[str, _Track] = {}
        self._by_stream: Dict[str, Set[str]] = {}
        self._events = TrackEventTracker(threshold=threshold, enter_n=enter_n, exit_n=exit_n)
        self._pool: Optional[TrackStatePool] = None
        self._packer = None
        self.side = 0
        self.clip_len = 0
        self.ticks = 0
        self.head_dispatches = 0
        self.head_ticks: deque = deque(maxlen=256)
        self.harvested = 0
        self._event_counts: Dict[str, int] = {}
        self._events_log: deque = deque(maxlen=int(events_keep))
        # Set by the engine: (pool, slot_idx, time_idx, n_real) ->
        # (host outputs, device_ms).
        self.head: Optional[Callable] = None
        # The engine's mesh (configure_mesh): None = one device.
        self._mesh = None
        self._mesh_shards = 1
        self._mesh_shard_of: Optional[Callable[[str], int]] = None

    def configure_mesh(self, *, mesh, shards: int, shard_of) -> None:
        """The engine's wiring at warmup (before the first harvest builds
        the pool): the clip rings become one a slot, so a slot's cascade
        state lives where its streams are served. ``shard_of`` maps a
        stream to its slot; track keys are ``stream#track_id``."""
        self._mesh = mesh
        self._mesh_shards = max(1, int(shards))
        self._mesh_shard_of = shard_of

    def repin_mesh(self, *, mesh, shards: int, shard_of) -> Dict[str, int]:
        """A survivor-mesh failover's counted reset of the sharded state:
        the dead slot's rings are gone and the survivors' rows were laid
        out for the old routing, so the whole pool goes. Tracks and their
        event machines clear without firing (an exit event now would be
        invented: the objects did not leave, the device did), and the pool
        is rebuilt at the next harvest under the new routing. Returns the
        counts the engine folds into the failover event."""
        with self._lock:
            n_tracks = len(self._tracks)
            n_streams = len(self._by_stream)
            n_slots = self._pool.slots_in_use() if self._pool is not None else 0
            for key in list(self._tracks):
                self._events.pop(key, None)
            self._tracks.clear()
            self._by_stream.clear()
            self._pool = None
            self._mesh = mesh
            self._mesh_shards = max(1, int(shards))
            self._mesh_shard_of = shard_of
        return {"cascade_tracks": n_tracks, "cascade_streams": n_streams,
                "cascade_slots": n_slots}

    def _resolve(self) -> None:
        """The tile geometry and the pool, at the first harvest."""
        if self._pool is not None:
            return
        from ..engine.collector import CanvasPacker
        from ..models import registry

        spec = registry.get(self.model)
        self.side = int(self._crop or spec.input_size)
        self.clip_len = int(self._clip_len or spec.clip_len or 4)
        # One tile a pack: the canvas is the tile, no gap to keep; the
        # power-of-two decimation, min_crop and the 114-gray letterbox
        # background carry over.
        self._packer = CanvasPacker(side=self.side, gap=0, max_canvases=1,
                                    min_crop=min(16, self.side))
        if self._mesh is not None:
            # Any mesh (dp=1 too) takes the sharded pool: the head steps
            # a slot's rows on that slot.
            stream_shard_of = self._mesh_shard_of

            def key_shard(key: str) -> int:
                return stream_shard_of(key.split("#", 1)[0])

            self._pool = ShardedTrackStatePool(self.side, self.clip_len, mesh=self._mesh,
                                               shards=self._mesh_shards, shard_of=key_shard,
                                               buckets=BUCKETS)
        else:
            self._pool = TrackStatePool(self.side, self.clip_len, device=self._device)

    # -- the stream-keyed dict protocol (the engine's GC) -----------------------

    def __bool__(self) -> bool:
        return bool(self._by_stream)

    def __len__(self) -> int:
        return len(self._by_stream)

    def __iter__(self):
        with self._lock:
            return iter(list(self._by_stream))

    def pop(self, stream: str, default=None):
        """Drop all of a stream's tracks (it left the bus): their rows go
        back to the free list, their event machines clear without firing."""
        with self._lock:
            keys = self._by_stream.pop(stream, None)
            if not keys:
                return default
            for key in keys:
                self._tracks.pop(key, None)
                if self._pool is not None:
                    self._pool.pop(key, None)
                self._events.pop(key, None)
            return keys

    # -- the drain thread's tap ---------------------------------------------------

    def harvest(self, stream: str, frame: np.ndarray, detections, meta=None) -> int:
        """Tap one emitted detect slot: each tracked detection's box,
        letterboxed into its track's tile, waits for the next tick's
        scatter. ``frame`` is the leased host buffer: the blit copies out
        of it and nothing keeps a reference."""
        tracked = [d for d in detections if getattr(d, "track_id", "")]
        if not tracked:
            return 0
        self._resolve()
        n = 0
        with self._lock:
            tick = self.ticks
            for det in tracked:
                x0, y0 = det.box.left, det.box.top
                box = (x0, y0, x0 + det.box.width, y0 + det.box.height)
                key = f"{stream}#{det.track_id}"
                canvases, placements, overflow = self._packer.pack([(key, meta, frame, box)])
                if overflow or not placements:
                    continue
                rec = self._tracks.get(key)
                if rec is None:
                    rec = _Track(stream=stream, track_id=str(det.track_id))
                    rec.history = deque(maxlen=self._history_keep or 2 * self.clip_len)
                    self._tracks[key] = rec
                    self._by_stream.setdefault(stream, set()).add(key)
                rec.tile = canvases[0]
                rec.updated = True
                rec.placement = placements[0]
                rec.meta = meta
                rec.last_seen = tick
                rec.history.append(canvases[0])
                n += 1
            self.harvested += n
        return n

    def set_stretch(self, factor: int) -> bool:
        """Set the cadence stretch; True when it changed (the engine
        journals the edge)."""
        factor = max(1, int(factor))
        with self._lock:
            changed = factor != self.stretch
            self.stretch = factor
        return changed

    # -- the tick thread -------------------------------------------------------------

    def tick(self) -> CascadeTickResult:
        """One engine tick: the batched scatter of harvested tiles, TTL
        expiry, and on cadence ticks the head and the hysteresis. Returns
        the events fired and the (stream, meta) of the tracks the head
        read."""
        events: List[dict] = []
        head_tracks: List[Tuple[str, object]] = []
        head_ms: Optional[float] = None
        due: List[str] = []
        with self._lock:
            self.ticks += 1
            tick = self.ticks
            if self.perf is not None:
                self.perf.note_cascade_tick()
            updated = [(k, r) for k, r in self._tracks.items() if r.updated]
            if updated:
                self._resolve()
                keys = [k for k, _ in updated]
                tiles = np.stack([r.tile for _, r in updated])
                bucket = bucket_for(len(keys))
                t0 = time.perf_counter()
                aux = self._pool.scatter(keys, tiles, bucket=bucket)
                dt = time.perf_counter() - t0
                if self.perf is not None:
                    # Host seconds to queue the copies (asynchronous on the
                    # card).
                    self.perf.note_h2d(f"cascade/{self.model}", bucket, tiles.nbytes + aux, dt)
                for _, r in updated:
                    r.updated = False
            # TTL: a track the detector stopped matching frees its slot.
            stale = [k for k, r in self._tracks.items() if tick - r.last_seen > self.ttl_ticks]
            for key in stale:
                self._drop_track_locked(key)
            if (self.head is not None and self._pool is not None
                    and tick % (self.every_n * max(1, self.stretch)) == 0):
                due = [k for k in self._tracks if self._pool.full(k)][:BUCKETS[-1]]
                if due:
                    if isinstance(self._pool, ShardedTrackStatePool):
                        # due_rows[i]: the batch row of due[i]; -1: its
                        # slot's segment overflowed, the track stays due.
                        slot_idx, time_idx, due_rows, _ = self._pool.plan(due)
                    else:
                        due_rows = None
                        slot_idx, time_idx = self._pool.gather_indices(due, bucket_for(len(due)))
                    pool = self._pool
        if due:
            # Outside the lock: a first head pass captures its program and
            # must not stall the harvest on the drain thread. The gather
            # reads the pool when the head runs; a scatter between the plan
            # and the gather is impossible (both run on the tick thread).
            try:
                outputs, head_ms = self.head(pool, slot_idx, time_idx, len(due))
            except Exception:
                log.exception("cascade head dispatch failed; continuing")
                outputs = None
            if outputs is not None:
                with self._lock:
                    self.head_dispatches += 1
                    self.head_ticks.append(tick)
                    if self.perf is not None:
                        self.perf.note_cascade_head(len(due))
                    for i, key in enumerate(due):
                        row = due_rows[i] if due_rows is not None else i
                        if row < 0:               # left out by the slot plan
                            continue
                        rec = self._tracks.get(key)
                        if rec is None:           # its stream went mid-dispatch
                            continue
                        score = float(outputs["event_score"][row])
                        rec.last_score = score
                        rec.observed += 1
                        head_tracks.append((rec.stream, rec.meta))
                        kind = self._events.observe(key, score)
                        if kind is None:
                            continue
                        ev = {
                            "kind": kind,
                            "stream": rec.stream,
                            "track_id": rec.track_id,
                            "score": score,
                            "tick": tick,
                            "features": [float(v) for v in outputs["features"][row]],
                            "logits": [float(v) for v in outputs["logits"][row]],
                            "meta": rec.meta,
                            "history": list(rec.history) if kind == "enter" else [],
                        }
                        events.append(ev)
                        self._event_counts[kind] = self._event_counts.get(kind, 0) + 1
                        self._events_log.append({k: v for k, v in ev.items()
                                                 if k not in ("meta", "history")})
        if self.perf is not None and self._pool is not None:
            self.perf.note_cascade_slots(self._pool.slots_in_use(), self._pool.high_water)
        return CascadeTickResult(events, head_tracks, head_ms)

    def _drop_track_locked(self, key: str) -> None:
        rec = self._tracks.pop(key, None)
        if rec is not None:
            keys = self._by_stream.get(rec.stream)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    self._by_stream.pop(rec.stream, None)
        if self._pool is not None:
            self._pool.pop(key, None)
        self._events.pop(key, None)

    # -- introspection -------------------------------------------------------------

    def pool_nbytes(self):
        """Device bytes of the clip ring, 0 before it exists: the engine's
        ``track_state`` pool in ``obs/hbm.py`` (``{shard: bytes}`` under a
        mesh)."""
        return self._pool.nbytes() if self._pool is not None else 0

    def snapshot(self) -> dict:
        """JSON-able state for /api/v1/cascade and /api/v1/stats (no device
        synchronisation)."""
        with self._lock:
            tracks = {
                key: {
                    "stream": rec.stream,
                    "track_id": rec.track_id,
                    "last_seen_tick": rec.last_seen,
                    "last_score": rec.last_score,
                    "observed": rec.observed,
                    "active": self._events.active(key),
                    "clip_full": self._pool.full(key) if self._pool is not None else False,
                }
                for key, rec in self._tracks.items()
            }
            return {
                "model": self.model,
                "every_n": self.every_n,
                "stretch": self.stretch,
                "effective_every_n": self.every_n * max(1, self.stretch),
                "side": self.side,
                "clip_len": self.clip_len,
                "threshold": self._events.threshold,
                "enter_n": self._events.enter_n,
                "exit_n": self._events.exit_n,
                "ticks": self.ticks,
                "harvested": self.harvested,
                "head_dispatches": self.head_dispatches,
                "head_ticks": list(self.head_ticks),
                "head_cadence": (round(self.ticks / self.head_dispatches, 2)
                                 if self.head_dispatches else None),
                "tracks": tracks,
                "slots_in_use": self._pool.slots_in_use() if self._pool is not None else 0,
                "slot_high_water": self._pool.high_water if self._pool is not None else 0,
                "event_counts": dict(self._event_counts),
                "events": list(self._events_log),
            }
