"""Replay-driven determinism, chaos-soak and end-to-end harness
(counterpart of ``video_edge_ai_proxy_tpu/replay/harness.py``).

- :func:`lockstep_checksum`: a trace replayed deterministically through
  bus -> collector -> serving step, folding the content checksum over every
  batch: two runs of one trace are bit-identical.
- :func:`run_fleet_soak`: the in-process chaos soak. Replay-driven cameras
  (6 detect + 5 embed + 5 classify streams by default) on the memory bus,
  one ``InferenceEngine`` with per-stream model routing, the real
  annotation uplink handler (retry, breaker, dead-letter spool) over a
  flaky stand-in cloud, and a scripted ``FaultPlan``; per-family latency,
  bucket fill over time, step-cache stability, cross-family misrouting, and
  the resilience and quality sections.
- :func:`run_e2e`: the whole single-process pipeline, a ``Server`` with a
  ``replay://`` worker subprocess on the shm bus, the engine and the gRPC
  ``Inference`` stream to a client thread, timed publish -> client-receive.

The router, autoscale and fleet-telemetry soaks are later slices.
"""

from __future__ import annotations

import collections
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..bus.interface import FrameBus
from ..bus.memory_bus import MemoryFrameBus
from ..device import resolve_device
from ..engine.collector import Collector
from ..engine.runner import build_serving_step
from ..models import registry
from .checksum import finalize_checksum, fold_checksum, zero_class_prior
from .faults import FaultPlan
from .player import TracePlayer, meta_for
from .recorder import record_synthetic_trace
from .trace import decode_frame

# The north-star fleet split per device: the real models on the card, the
# structurally identical tiny twins on the CPU (the same serving families
# and orchestration load at laptop size).
FLEET_CUDA = {"yolov8n": 6, "resnet50": 5, "vit_b16": 5}
FLEET_CPU = {"tiny_yolov8": 6, "tiny_resnet": 5, "tiny_vit": 5}


def default_fleet(device_type: str) -> dict:
    """The fleet of ``device_type`` (``"cuda"`` or ``"cpu"``)."""
    return dict(FLEET_CUDA) if device_type == "cuda" else dict(FLEET_CPU)


def _pct(values, points=(50, 90, 95, 99)) -> Optional[dict]:
    if not values:
        return None
    arr = np.asarray(values, dtype=np.float64)
    out = {f"p{p}": round(float(np.percentile(arr, p)), 2) for p in points}
    out["n"] = len(values)
    return out


def lockstep_checksum(
    trace_path: str, *, model: str = "tiny_yolov8", device: "str | torch.device" = "cuda",
    generator: Optional[torch.Generator] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.bfloat16, preprocess_dtype: torch.dtype = torch.bfloat16,
    device_id: Optional[str] = None, limit: int = 0,
    perturb: Optional[Callable[[dict], dict]] = None, zero_prior: bool = True,
    on_batch: Optional[Callable] = None, bus: Optional[FrameBus] = None,
) -> dict:
    """Replay a trace deterministically through bus -> collector -> serving
    step and fold the content checksum over every batch's outputs.

    Frames go through the real stages (publish, cursors, pooled-buffer
    assembly, bucket padding), one publish per collect, so latest-wins never
    drops a frame: the fold is exact, and two runs of one trace with the
    same weights are bit-identical. The weights are the registry model's
    from ``generator`` (default seed 0), or ``state_dict``; with
    ``zero_prior`` a detector's class prior is zeroed, then
    ``perturb(state_dict) -> state_dict`` applies (the seeded-fault hook).
    ``on_batch(group, outputs)`` sees every batch as it is served. ``bus``
    (default a fresh ``MemoryFrameBus``, closed at the end) carries the
    frames; a bus passed in (a ``ShmFrameBus`` on an empty ring directory)
    stays open, its owner's to close. The collector is built without
    interest, so every published stream is inferred.

    Returns {"checksum", "frames", "batches", "batch_streams" (streams per
    batch), "model"}."""
    dev = resolve_device(device)
    spec = registry.get(model)
    net = spec.init_params(generator, device=dev, dtype=dtype)
    sd = dict(net.state_dict()) if state_dict is None else dict(state_dict)
    if zero_prior and spec.kind == "detect":
        sd = zero_class_prior(sd)
    if perturb is not None:
        sd = perturb(sd)
    net.load_state_dict(sd, strict=True)
    step = build_serving_step(net, spec, preprocess_dtype=preprocess_dtype)

    player = TracePlayer(trace_path)
    owns_bus = bus is None
    bus = MemoryFrameBus() if owns_bus else bus
    col = Collector(bus, buckets=(1, 2, 4, 8, 16), default_model=spec.name,
                    clip_len=spec.clip_len)
    created: set = set()
    carry = torch.zeros((), dtype=torch.int64, device=dev)
    frames = 0
    batch_streams = []
    try:
        for dev_id, frame, meta in player.iter_frames(device_id):
            if limit and frames >= limit:
                break
            if dev_id not in created:
                bus.create_stream(dev_id, frame.nbytes)
                created.add(dev_id)
            bus.publish(dev_id, frame, meta)
            frames += 1
            for group in col.collect():
                batch_streams.append(len(group.device_ids))
                # A synchronous copy: the pooled buffer is reused next tick.
                outputs = step(torch.from_numpy(group.frames).to(dev))
                carry = fold_checksum(carry, outputs)
                if on_batch is not None:
                    on_batch(group, outputs)
    finally:
        if owns_bus:
            bus.close()
    return {"checksum": finalize_checksum(carry), "frames": frames,
            "batches": len(batch_streams), "batch_streams": batch_streams,
            "model": spec.name}


# ---------------------------------------------------------------------------
# In-process fleet soak
# ---------------------------------------------------------------------------


class StallBus:
    """FrameBus proxy whose publish path can be stalled for a window (the
    ``bus_stall`` fault: a wedged writer) or made to fail fast for a window
    (the ``bus_flap`` fault: publishes raise ``ConnectionError``).
    Everything else delegates."""

    def __init__(self, bus):
        self._bus = bus
        self._stall_until = 0.0
        self._flap_until = 0.0

    def __getattr__(self, name):
        return getattr(self._bus, name)

    def stall_for(self, duration_s: float) -> None:
        self._stall_until = time.monotonic() + duration_s

    def flap_for(self, duration_s: float) -> None:
        self._flap_until = time.monotonic() + duration_s

    def publish(self, device_id, frame, meta):
        while time.monotonic() < self._stall_until:
            time.sleep(0.01)
        if time.monotonic() < self._flap_until:
            raise ConnectionError("bus_flap (scripted fault)")
        return self._bus.publish(device_id, frame, meta)


class _FlakyCloud:
    """CloudClient stand-in for the soak's annotation uplink: delivery is an
    in-memory count, and the ``uplink_down`` fault makes every post raise
    ``URLError`` for a window (the transport failure the real handler
    retries, breaks on and spools). A post either raises before counting or
    delivers, so the conservation check is exact."""

    def __init__(self):
        self.down_until = 0.0
        self.posts = 0
        self.post_failures = 0
        self.delivered = 0

    def post_annotations(self, url, annotations, deadline=None):
        import urllib.error

        self.posts += 1
        if time.monotonic() < self.down_until:
            self.post_failures += 1
            raise urllib.error.URLError("uplink_down (scripted fault)")
        self.delivered += len(annotations)
        return b"{}"


class _RenderMemo:
    """The frames of a trace's events, shared by every camera of a soak: a
    synthetic frame depends only on (h, w, n), so one render serves every
    camera that publishes it (``SyntheticSource.render`` takes milliseconds
    of numpy a 1080p frame). The frames are read-only and byte-equal to
    ``decode_frame``'s. Bounded by ``max_bytes`` (least recently used out);
    a camera that asks for a frame another is rendering waits for it."""

    def __init__(self, max_bytes: int = 1 << 30):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._frames: "collections.OrderedDict[tuple, np.ndarray]" = collections.OrderedDict()
        self._pending: dict = {}
        self._bytes = 0
        self.renders = 0

    def frame(self, ev: dict) -> np.ndarray:
        synth = ev.get("synth")
        if synth is None:
            return decode_frame(ev)
        key = (synth["h"], synth["w"], synth["n"])
        while True:
            with self._lock:
                hit = self._frames.get(key)
                if hit is not None:
                    self._frames.move_to_end(key)
                    return hit
                waiter = self._pending.get(key)
                mine = waiter is None
                if mine:
                    waiter = self._pending[key] = threading.Event()
            if mine:
                break
            waiter.wait()
        frame = None
        try:
            frame = decode_frame(ev)
            frame.setflags(write=False)
        finally:
            with self._lock:
                self.renders += 1
                if frame is not None and frame.nbytes <= self.max_bytes:
                    self._frames[key] = frame
                    self._bytes += frame.nbytes
                    while self._bytes > self.max_bytes:
                        _, old = self._frames.popitem(last=False)
                        self._bytes -= old.nbytes
                if mine:
                    self._pending.pop(key, None)
                    waiter.set()
        return frame


class _ReplayCamera(threading.Thread):
    """One replay-driven camera: publishes its trace stream at the recorded
    cadence (looping past the end), honouring the kill, gap, black and
    frozen fault flags. Frames come from ``memo`` (a fresh ``_RenderMemo``
    when None)."""

    def __init__(self, bus, device_id: str, events: list, stop: threading.Event,
                 memo: Optional[_RenderMemo] = None):
        super().__init__(name=f"replay-cam-{device_id}", daemon=True)
        self.bus = bus
        self.device_id = device_id
        self.events = events
        self.stop_ev = stop
        self.memo = memo if memo is not None else _RenderMemo()
        self.killed = threading.Event()
        self.gap_until = 0.0
        # Output-quality faults: while black_until is open the camera
        # publishes all-zero frames (a lens cap); while frozen_until is open
        # it republishes the window's first frame (a wedged decoder). Both
        # keep the cadence: the stream stays live, only its content degrades.
        self.black_until = 0.0
        self.frozen_until = 0.0
        self._frozen_frame = None
        self.published = 0
        self.suppressed = 0

    def run(self) -> None:
        ev0 = self.events[0]
        base = ev0["t_ms"]
        span = self.events[-1]["t_ms"] - base + (
            self.events[1]["t_ms"] - base if len(self.events) > 1 else 33.0)
        shape = ev0.get("shape") or [ev0["synth"]["h"], ev0["synth"]["w"], 3]
        self.bus.create_stream(self.device_id, shape[0] * shape[1] * shape[2])
        alive = True
        t0 = time.monotonic()
        i = 0
        while not self.stop_ev.is_set():
            ev = self.events[i % len(self.events)]
            due = t0 + ((ev["t_ms"] - base) + (i // len(self.events)) * span) / 1000.0
            delay = due - time.monotonic()
            if delay > 0 and self.stop_ev.wait(delay):
                break
            i += 1
            if self.killed.is_set():
                alive = False
                self.suppressed += 1
                continue
            if not alive:
                # Re-added after a kill: the stream was dropped from the
                # bus; re-create it (a restarted worker does the same).
                self.bus.create_stream(self.device_id, shape[0] * shape[1] * shape[2])
                alive = True
            if time.monotonic() < self.gap_until:
                self.suppressed += 1
                continue
            frame = self.memo.frame(ev)
            now_mono = time.monotonic()
            if now_mono < self.black_until:
                frame = np.zeros_like(frame)
            elif now_mono < self.frozen_until:
                if self._frozen_frame is None:
                    self._frozen_frame = frame
                frame = self._frozen_frame
            else:
                self._frozen_frame = None
            meta = meta_for(ev, frame, timestamp_ms=int(time.time() * 1000))
            try:
                self.bus.publish(self.device_id, frame, meta)
            except ConnectionError:
                # bus_flap: the link dropped the publish, the stream is
                # intact: suppressed, the cursor kept.
                self.suppressed += 1
                continue
            except ValueError:
                # Raced a camera_kill's drop_stream: suppressed, re-created
                # at the next live frame.
                alive = False
                self.suppressed += 1
                continue
            self.published += 1


def _prewarm_entries(assignment: Mapping[str, str], src_hw: tuple,
                     buckets: tuple) -> list:
    """``EngineConfig.prewarm`` for every bucket the degradation ladder can
    shift a soak's model to: each frame model's buckets up to the first that
    holds all its streams."""
    counts: dict = {}
    for name in assignment.values():
        counts[name] = counts.get(name, 0) + 1
    entries = []
    for name, count in counts.items():
        if registry.get(name).clip_len:
            continue
        for b in sorted(buckets):
            entries.append([int(src_hw[0]), int(src_hw[1]), int(b), name])
            if b >= count:
                break
    return entries


def run_fleet_soak(
    *, duration_s: float = 120.0, fleet: Optional[dict] = None,
    src_hw: tuple = (96, 128), fps: float = 30.0, tick_ms: int = 10,
    trace_path: Optional[str] = None, fault_plan: Optional[FaultPlan] = None,
    warmup_timeout_s: float = 1800.0, sample_every_s: float = 2.0,
    timeline_bin_s: float = 10.0, trace_sample_every: int = 4,
    profile_on_burn: bool = False, prof_dir: Optional[str] = None,
    quality_kinds: tuple = (), engine_overrides: Optional[dict] = None,
    device: "str | torch.device" = "cuda",
) -> dict:
    """The chaos soak; returns the artifact's "soak" section, as the JAX
    harness's.

    ``profile_on_burn`` arms the triggered captures (``obs/prof.py``) at
    soak scale (200 ms captures, a 5 s rate limit, a 10 s SLO warmup); the
    bundle manifests land in the "prof" section.

    ``quality_kinds`` schedules output-quality faults (``faults.py``
    ``QUALITY_KINDS``: black_frame on the first camera, frozen_frame on the
    second, a global score_drift) and arms the quality plane at soak scale:
    0.6 s verdict hysteresis, a recorded canary trace in the live engine
    (golden adopted from its first cycle), and the default detector's class
    prior zeroed so the fleet produces real detections. The prior is zeroed
    in place, before any graph is captured, so graph replays read the
    zeroed weights. The "quality" section holds each fault's detection
    latency and the false positives outside the fault windows.

    The ladder's buckets are prewarmed through ``EngineConfig.prewarm`` (the
    engine builds them in ``start()``, before its threads run), not by
    calling steps from the harness. ``device``: the engine's (the card
    unless the caller asks for the CPU)."""
    from ..engine.runner import InferenceEngine
    from ..obs import registry as obs_registry
    from ..obs import tracer
    from ..obs.spans import stage_breakdown
    from ..resilience import CircuitBreaker, DeadLetterSpool, RetryPolicy
    from ..uplink.cloud import make_batch_handler
    from ..uplink.queue import AnnotationQueue
    from ..utils.config import EngineConfig

    dev = resolve_device(device)
    fleet = fleet or default_fleet(dev.type)
    h, w = src_hw

    assignment = {}
    i = 0
    for name, count in fleet.items():
        for _ in range(count):
            assignment[f"fleet{i:02d}"] = name
            i += 1
    family_of = {name: registry.get(name).kind for name in fleet}

    # Deterministic traffic: one synthetic trace shared by every camera.
    own_trace = trace_path is None
    if own_trace:
        trace_path = os.path.join(tempfile.gettempdir(), f"vep_soak_trace_{os.getpid()}.vtrace")
        record_synthetic_trace(
            trace_path, sorted(assignment), width=w, height=h, fps=fps,
            gop=30, frames=max(60, int(min(duration_s, 30.0) * fps)))
    player = TracePlayer(trace_path)
    memo = _RenderMemo()

    # Frame lineage across the soak; the prior tracer config is restored
    # at the end (the soak runs beside other users of the tracer).
    prev_trace = (tracer.enabled, tracer.sample_every)
    tracer.configure(enabled=True, sample_every=max(1, trace_sample_every))

    inner_bus = MemoryFrameBus()
    bus = StallBus(inner_bus)
    default_model = next(iter(fleet))

    # The real batch handler (retry, breaker, dead-letter spool) over a
    # flaky transport, at soak-scale timings, so an uplink_down window
    # runs through retries, the breaker, the spool and the drain.
    ann_cloud = _FlakyCloud()
    spool_dir = tempfile.mkdtemp(prefix="vep_soak_spool_")
    ann_spool = DeadLetterSpool(spool_dir, max_bytes=8 << 20)
    ann_handler = make_batch_handler(
        None, "soak://annotate", client=ann_cloud, spool=ann_spool,
        retry=RetryPolicy(max_attempts=2, base_s=0.01, cap_s=0.05),
        breaker=CircuitBreaker("uplink_soak", failure_threshold=2, recovery_timeout_s=0.5),
        post_deadline_s=5.0,
    )
    ann_q = AnnotationQueue(
        ann_handler, max_batch_size=299, poll_duration_ms=100,
        unacked_limit=100_000, requeue_interval_s=0.5,
    )
    ann_q.start()

    if profile_on_burn and prof_dir is None:
        prof_dir = tempfile.mkdtemp(prefix="vep_soak_prof_")
    has_quality = bool(quality_kinds)
    qcfg = {}
    canary_trace = None
    if has_quality:
        # Verdicts must enter and exit within a 20 s smoke; the canary
        # trace shares the fleet's geometry, so its batches use programs
        # already built. 2 fps over a 6-frame loop: one integrity verdict
        # every 3 s, served losslessly by a loaded engine.
        canary_trace = os.path.join(tempfile.gettempdir(), f"vep_canary_{os.getpid()}.vtrace")
        record_synthetic_trace(canary_trace, ["_canary"], width=w, height=h, fps=fps,
                               gop=6, frames=6)
        qcfg = dict(quality_enter_s=0.6, quality_exit_s=0.6, quality_window_s=2.0,
                    quality_canary=canary_trace, quality_canary_fps=2.0)
    buckets = (1, 2, 4, 8, 16)
    eng_cfg = EngineConfig(
        model=default_model, tick_ms=tick_ms, stage_trace=True,
        batch_buckets=buckets, track=False,
        annotation_emit="all",   # firehose: conservation needs volume
        # Profiling only for the --profile-on-burn legs (a capture pauses
        # the measured window), with soak-scale trigger knobs.
        prof=profile_on_burn,
        prof_dir=prof_dir or "",
        prof_trigger=profile_on_burn,
        prof_trigger_ms=200,
        prof_trigger_min_interval_s=5.0,
        slo_warmup_s=10.0 if (profile_on_burn or has_quality) else 60.0,
        prewarm=_prewarm_entries(assignment, src_hw, buckets),
        **qcfg,
    )
    if engine_overrides:
        import dataclasses

        eng_cfg = dataclasses.replace(eng_cfg, **engine_overrides)
    eng = InferenceEngine(
        bus, eng_cfg, device=dev,
        model_resolver=lambda d: assignment.get(d, ""),
        annotations=ann_q,
    )

    # device_stall: while its window is open every step call takes 50 ms
    # more (per call, so consecutive over-budget ticks build the sustained
    # pressure the ladder's hysteresis needs). score_drift: while its window
    # is open every detect batch's scores are scaled by 0.75 (boxes and
    # counts intact), which only the canary and the drift scorer can see.
    stall = {"until": 0.0}
    drift = {"until": 0.0}
    _orig_step = eng._step

    def _stalled_step(src_hw, bucket, model=None):
        fn = _orig_step(src_hw, bucket, model)

        def slow(*a, **k):
            if time.monotonic() < stall["until"]:
                time.sleep(0.05)
            out = fn(*a, **k)
            if time.monotonic() < drift["until"] and "scores" in out:
                out = dict(out)
                out["scores"] = out["scores"] * 0.75
            return out

        return slow

    eng._step = _stalled_step
    eng.warmup()
    if has_quality:
        # Random-init detect scores sit near 1e-5, below the NMS floor: no
        # detections, no drift signal, an all-zero canary fold. Zeroing the
        # class prior gives content-dependent detections. In place: the
        # module's tensors are the ones every graph captures.
        spec0 = registry.get(default_model)
        if spec0.kind == "detect" and eng._model is not None:
            with torch.no_grad():
                eng._model.load_state_dict(zero_class_prior(eng._model.state_dict()))
    eng.start()

    stop = threading.Event()
    cams = {
        d: _ReplayCamera(bus, d, player.frame_events(d), stop, memo)
        for d in sorted(assignment)
    }

    # Result sink: one subscriber over all streams; latencies per family,
    # the misrouting check; paused by the slow_subscriber fault.
    lat_by_family: dict = {k: [] for k in set(family_of.values())}
    lat_lock = threading.Lock()
    misrouted: list = []
    results = {"n": 0}
    slow_until = [0.0]
    measuring = threading.Event()

    def sink() -> None:
        for res in eng.subscribe(timeout=0.5):
            while time.monotonic() < slow_until[0] and not stop.is_set():
                time.sleep(0.05)   # slow subscriber: stop draining
            if stop.is_set():
                break
            expected = assignment.get(res.device_id)
            if expected is not None and res.model != expected:
                misrouted.append((res.device_id, res.model, expected))
            if not measuring.is_set():
                continue
            results["n"] += 1
            fam = family_of.get(res.model)
            if fam is not None:
                with lat_lock:
                    lat_by_family[fam].append(res.latency_ms)

    sink_thread = threading.Thread(target=sink, name="soak-sink", daemon=True)
    sink_thread.start()

    # Warmup: the first frame of each camera, until every stream has a
    # result (the programs were built by start()).
    for d, cam in cams.items():
        ev = cam.events[0]
        frame = memo.frame(ev)
        inner_bus.create_stream(d, frame.nbytes)
        inner_bus.publish(d, frame, meta_for(ev, frame, timestamp_ms=int(time.time() * 1000)))
    warm_deadline = time.monotonic() + warmup_timeout_s
    while time.monotonic() < warm_deadline:
        if len(eng.stats()) >= len(assignment):
            break
        time.sleep(1.0)
    warmup_s = warmup_timeout_s - (warm_deadline - time.monotonic())
    eng.stage_records.clear()
    # The measured window starts clean: warmup builds would otherwise count
    # as recompile episodes and skew the span breakdown.
    tracer.clear()
    eng.watchdog.reset()
    if eng.quality is not None:
        # Warmup frames (one per camera, then silence) would seep into the
        # window as flatline or freeze priors. The canary is not reset: the
        # golden it adopted is the measured window's reference.
        eng.quality.reset()

    if fault_plan is not None:
        events = list(fault_plan.events)
    elif has_quality:
        # The quality smoke runs without the churn script: kills and stalls
        # would starve the streams whose verdicts are being timed.
        events = []
    else:
        events = list(FaultPlan.default_churn(sorted(assignment), duration_s).events)
    if has_quality:
        events += FaultPlan.quality(duration_s, sorted(assignment), quality_kinds).events
    plan = FaultPlan(events)
    plan.reset()

    measuring.set()
    for cam in cams.values():
        cam.start()

    t0 = time.monotonic()
    t0_wall = time.time()   # stage_records carry wall-clock stamps
    faults_applied = []
    step_cache_samples = []
    timeline: dict = {}
    seen_submits: dict = {}
    next_sample = 0.0

    def drain_stage_records() -> None:
        while True:
            try:
                r = eng.stage_records.popleft()
            except IndexError:
                break
            b = int(max(0.0, r["t_emitted"] - t0_wall) // timeline_bin_s)
            slot = timeline.setdefault(b, {"real": 0, "padded": 0})
            slot["real"] += 1
            # one batch contributes its bucket once (keyed by submit time)
            key = r["t_submit"]
            if key not in seen_submits:
                seen_submits[key] = r["bucket"]
                slot["padded"] += r["bucket"]

    while True:
        now_s = time.monotonic() - t0
        if now_s >= duration_s:
            break
        for ev in plan.pop_due(now_s):
            faults_applied.append({
                "at_s": round(now_s, 2), "kind": ev.kind,
                "device_id": ev.device_id, "duration_s": ev.duration_s,
            })
            if ev.kind == "camera_kill":
                cams[ev.device_id].killed.set()
                bus.drop_stream(ev.device_id)
            elif ev.kind == "camera_restore":
                cams[ev.device_id].killed.clear()
            elif ev.kind == "frame_gap":
                cams[ev.device_id].gap_until = time.monotonic() + ev.duration_s
            elif ev.kind == "bus_stall":
                bus.stall_for(ev.duration_s)
            elif ev.kind == "slow_subscriber":
                slow_until[0] = time.monotonic() + ev.duration_s
            elif ev.kind == "uplink_down":
                ann_cloud.down_until = time.monotonic() + ev.duration_s
            elif ev.kind == "bus_flap":
                bus.flap_for(ev.duration_s)
            elif ev.kind == "device_stall":
                stall["until"] = time.monotonic() + ev.duration_s
            elif ev.kind == "black_frame":
                cams[ev.device_id].black_until = time.monotonic() + ev.duration_s
            elif ev.kind == "frozen_frame":
                cams[ev.device_id].frozen_until = time.monotonic() + ev.duration_s
            elif ev.kind == "score_drift":
                drift["until"] = time.monotonic() + ev.duration_s
        if now_s >= next_sample:
            step_cache_samples.append(
                {"t_s": round(now_s, 1), "programs": len(eng._step_cache)})
            drain_stage_records()
            next_sample = now_s + sample_every_s
        time.sleep(0.25)

    measuring.clear()
    stop.set()
    for cam in cams.values():
        cam.join(timeout=5)
    drain_stage_records()
    stats = eng.stats()
    subscriber_drops = eng.subscriber_drops
    programs_final = len(eng._step_cache)
    ticks = eng.ticks
    span_events = tracer.events()
    obs_section = {
        "metrics": obs_registry.snapshot(),
        "watch": eng.watchdog.snapshot(),
        "stage_breakdown": stage_breakdown(span_events),
        "trace": {
            "sample_every": tracer.sample_every,
            "events": len(span_events),
            "streams": len(tracer.streams()),
        },
        "quality": eng.quality.snapshot() if eng.quality is not None else None,
    }
    canary_snapshot = eng.canary.snapshot() if eng.canary is not None else None
    tracer.configure(enabled=prev_trace[0], sample_every=prev_trace[1])
    ladder_snapshot = eng.ladder.snapshot() if eng.ladder is not None else None
    shed_frames = eng.shed_frames
    perf_section = eng.perf.snapshot()
    slo_section = eng.slo.snapshot() if eng.slo is not None else None
    # Let a triggered capture in flight finish its bundle first.
    prof_section = None
    if eng.prof is not None:
        eng.prof.join_trigger()
        prof_section = eng.prof.snapshot()
    eng.stop()
    sink_thread.join(timeout=5)
    inner_bus.close()

    # Final uplink drain, the uplink healthy again: every queued and every
    # spooled batch must go out (both depths at zero).
    ann_cloud.down_until = 0.0
    drain_deadline = time.monotonic() + 30.0
    while ann_q.depth() > 0 and time.monotonic() < drain_deadline:
        ann_q.requeue_rejected()
        if ann_q.drain_once() == 0:
            time.sleep(0.05)
    while ann_spool.pending() > 0 and time.monotonic() < drain_deadline:
        ann_handler([])   # an empty batch drains the spool through cloud.py
    ann_q.stop()
    spool_snapshot = ann_spool.snapshot()
    shutil.rmtree(spool_dir, ignore_errors=True)
    for path in ((trace_path if own_trace else None), canary_trace):
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass
    # Conservation: everything the engine enqueued was delivered exactly
    # once, less only the spool's explicit evictions.
    conserved = (ann_cloud.delivered + spool_snapshot["dropped_events"] == ann_q.published)
    resilience_section = {
        "ladder": ladder_snapshot,
        "shed_frames": shed_frames,
        "uplink": {
            "published": ann_q.published,
            "acked": ann_q.acked,
            "queue_dropped": ann_q.dropped,
            "rejected_batches": ann_q.rejected_batches,
            "posts": ann_cloud.posts,
            "post_failures": ann_cloud.post_failures,
            "delivered_events": ann_cloud.delivered,
            "final_queue_depth": ann_q.depth(),
            "breaker": ann_handler.breaker.snapshot(),
            "spool": spool_snapshot,
            "conserved": conserved,
        },
    }

    # Each injected quality fault against the verdict transition (or the
    # canary mismatch) that answers it. Transitions carry the tracker's
    # monotonic clock and faults_applied offsets from t0: one clock. A
    # non-ok transition outside every expected window is a false positive.
    quality_section = None
    if has_quality and obs_section["quality"] is not None:
        qsnap = obs_section["quality"]
        enter_s = qcfg["quality_enter_s"]
        exit_s = qcfg["quality_exit_s"]
        verdict_for = {"black_frame": "black", "frozen_frame": "frozen"}
        expected: dict = {}
        fault_reports = []
        episodes = obs_section["watch"].get("episodes", {})
        canary_episodes = episodes.get("canary_integrity", 0)
        for f in faults_applied:
            if f["kind"] not in verdict_for and f["kind"] != "score_drift":
                continue
            fault_mono = t0 + f["at_s"]
            report = dict(f)
            if f["kind"] == "score_drift":
                # Detected: the canary mismatched and opened a watchdog
                # episode (cycle accounting, not timestamps).
                mism = (canary_snapshot or {}).get("mismatch_cycles", 0)
                report["detected"] = bool(mism and canary_episodes)
                report["mismatch_cycles"] = mism
                report["latency_s"] = None
                report["latency_ticks"] = None
            else:
                want = verdict_for[f["kind"]]
                trans = qsnap["streams"].get(f["device_id"], {}).get("transitions", [])
                hit = next((t for t, v in trans if v == want and t >= fault_mono - 0.5), None)
                report["detected"] = hit is not None
                report["latency_s"] = round(hit - fault_mono, 3) if hit is not None else None
                report["latency_ticks"] = (
                    int(round((hit - fault_mono) / (tick_ms / 1000.0)))
                    if hit is not None else None)
                expected.setdefault(f["device_id"], []).append(
                    (fault_mono - 0.5, fault_mono + f["duration_s"] + enter_s + exit_s + 3.0))
            fault_reports.append(report)
        false_positives = []
        for name, st in qsnap["streams"].items():
            for t, v in st["transitions"]:
                if v == "ok":
                    continue
                if any(lo <= t <= hi for lo, hi in expected.get(name, ())):
                    continue
                false_positives.append({"stream": name, "verdict": v,
                                        "at_s": round(t - t0, 2)})
        quality_section = {
            "faults": fault_reports,
            "false_positives": false_positives,
            "canary": canary_snapshot,
            "canary_watchdog_episodes": canary_episodes,
            "tick_ms": tick_ms,
        }

    bucket_fill_timeline = [
        {
            "t_s": int(b * timeline_bin_s),
            "real": slot["real"],
            "padded": slot["padded"],
            "fill": round(slot["real"] / slot["padded"], 3) if slot["padded"] else None,
        }
        for b, slot in sorted(timeline.items())
    ]
    # Stable: the program set stopped growing before the soak ended.
    step_cache_samples.append({"t_s": round(duration_s, 1), "programs": programs_final})
    tail = [s["programs"] for s in step_cache_samples[-5:]]
    with lat_lock:
        per_family = {fam: _pct(vals) for fam, vals in sorted(lat_by_family.items())}
    return {
        "backend": dev.type,
        "duration_s": duration_s,
        "fleet": fleet,
        "streams": len(assignment),
        "src_hw": [h, w],
        "trace": os.path.basename(trace_path),
        "warmup_s": round(warmup_s, 1),
        "ticks": ticks,
        "results_measured": results["n"],
        "per_family_latency_ms": per_family,
        "bucket_fill_timeline": bucket_fill_timeline,
        "step_cache": {
            "samples": step_cache_samples,
            "final": programs_final,
            "stable": len(set(tail)) <= 1 if tail else False,
        },
        "misrouted_results": len(misrouted),
        "misrouted_examples": misrouted[:5],
        "subscriber_drops": subscriber_drops,
        "published": {d: c.published for d, c in cams.items()},
        "suppressed": {d: c.suppressed for d, c in cams.items()},
        "streams_with_results": len(stats),
        "faults_applied": faults_applied,
        "obs": obs_section,
        "resilience": resilience_section,
        "perf": perf_section,
        "slo": slo_section,
        "prof": prof_section,
        "quality": quality_section,
    }


# ---------------------------------------------------------------------------
# Full single-process pipeline e2e
# ---------------------------------------------------------------------------


def run_e2e(
    *, duration_s: float = 30.0, warmup_s: float = 8.0,
    width: int = 128, height: int = 96, fps: float = 30.0,
    model: str = "tiny_yolov8", workdir: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Replay a trace through the whole pipeline: a ``replay://`` worker
    subprocess -> shm bus -> collector -> engine -> gRPC ``Inference``
    stream -> a client thread, and record publish -> client-receive latency
    percentiles over ``duration_s`` after ``warmup_s`` (the worker's boot
    and the first geometry's build). ``device``: the engine's. Returns the
    payload JAX's ``run_e2e`` returns, with "backend" the device type."""
    import grpc

    from ..obs import registry as obs_registry
    from ..obs import tracer
    from ..obs.spans import stage_breakdown
    from ..proto import video_streaming_pb2 as pb
    from ..proto import video_streaming_pb2_grpc as pb_grpc
    from ..serve.models import StreamProcess
    from ..serve.server import Server
    from ..utils.config import Config

    backend = resolve_device(device).type
    tmp = workdir or tempfile.mkdtemp(prefix="vep_e2e_")
    trace_path = os.path.join(tmp, "e2e.vtrace")
    record_synthetic_trace(trace_path, ["e2e0"], width=width, height=height, fps=fps, gop=30,
                           frames=max(90, int(fps * 10)))

    cfg = Config()
    shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    cfg.bus.shm_dir = os.path.join(shm_root, f"vep_torch_e2e_{os.getpid()}")
    cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"   # no egress
    # The run owns its worker: the server's stop() ends it (a detached
    # worker would outlive the run and its removed ring directory).
    cfg.worker_adoption = False
    cfg.engine.model = model
    cfg.engine.track = False
    # The one camera's program is built in the engine's start(), before the
    # worker publishes (JAX's warmup window covers its first compile).
    cfg.engine.prewarm = [[height, width, 1]]
    # The Server configures the process-wide tracer from cfg.obs: the
    # payload carries the stage breakdown (the ingest leg through the
    # collect spans' pub_ms; the publish span lives in the worker).
    cfg.obs.trace = True
    cfg.obs.sample_every = 4
    srv = Server(cfg, data_dir=tmp, grpc_port=0, rest_port=0, enable_engine=True,
                 device=device)
    srv.start()
    lat: list = []
    lat_all: list = []
    lat_lock = threading.Lock()
    stop = threading.Event()
    measure_after = [float("inf")]

    def client() -> None:
        channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
        stub = pb_grpc.ImageStub(channel)
        while not stop.is_set():
            try:
                for res in stub.Inference(pb.InferenceRequest(), timeout=5):
                    if stop.is_set():
                        break
                    if not res.timestamp:
                        continue
                    sample = time.time() * 1000 - res.timestamp
                    with lat_lock:
                        lat_all.append(sample)
                        if time.monotonic() >= measure_after[0]:
                            lat.append(sample)
            except grpc.RpcError:
                if not stop.is_set():
                    time.sleep(0.5)
        channel.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        srv.process_manager.start(StreamProcess(
            name="e2e0",
            rtsp_endpoint=f"replay://{trace_path}?device=e2e0&pace=1&loop=1",
        ))
        time.sleep(warmup_s)
        tracer.clear()   # the measured window's spans only
        measure_after[0] = time.monotonic()
        time.sleep(duration_s)
    finally:
        stop.set()
        t.join(timeout=10)
        span_events = tracer.events()
        eng = srv.engine
        obs_section = {
            "metrics": obs_registry.snapshot(),
            "watch": eng.watchdog.snapshot() if eng is not None else None,
            "stage_breakdown": stage_breakdown(span_events),
            "trace": {
                "sample_every": tracer.sample_every,
                "events": len(span_events),
            },
            "perf": eng.perf.snapshot() if eng is not None else None,
            "slo": eng.slo.snapshot() if eng is not None and eng.slo is not None else None,
        }
        tracer.configure(enabled=False)
        srv.stop()
        shutil.rmtree(cfg.bus.shm_dir, ignore_errors=True)
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    with lat_lock:
        measured = list(lat)
        total = len(lat_all)
    return {
        "metric": f"e2e_single_path_latency_{model}_{backend}",
        "pipeline": "replay://(worker subprocess) -> shm bus -> collector "
                    "-> engine -> gRPC Inference stream -> client",
        "backend": backend,
        "model": model,
        "src_hw": [height, width],
        "fps": fps,
        "duration_s": duration_s,
        "warmup_s": warmup_s,
        "results_total": total,
        "results_measured": len(measured),
        "latency_ms": _pct(measured),
        "unit": "ms publish->client-receive",
        "obs": obs_section,
    }
