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

- The fleet tier's soaks, each over member servers in processes of their
  own (``_fleet_member_main``; several members share one card):
  :func:`run_fleet_obs` (N members, one ``FleetAggregator``: the merged
  page, member health, stitched traces, conserved counters),
  :func:`run_router_soak` (a ``StreamRouter`` over serve-only members
  through a burn leg and a kill leg: ``shed_to_fleet`` before
  ``bucket_downshift``, re-placement within a scrape, the conservation
  ledger) and :func:`run_autoscale_soak` (a ``FleetSupervisor`` spawning
  and retiring real members over a :class:`LoadShape`).

A member runs as ``python -m video_edge_ai_proxy_tpu_torch.replay.harness
--instance m0 --workdir DIR --spans-out FILE --device cuda|cpu ...``.
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


# -- the fleet tier's soaks: member servers in processes of their own -------------


def _member_counts(srv, device: str) -> dict:
    """A member's kernel launches, detector batches and device time, for
    its last line: each wrapper's launch count (``nms_keep_mask``, the
    flash kernels), the batches per model (``vep_device_batch_ms``), the
    step's device ms at p50 per (model, bucket) (``vep_perf_device_ms``:
    the CUDA-event span on the card), the card's peak reserved bytes, the
    process's torch threads, the engine's subscriber drops and its graphs'
    capture seconds, and the pids of its camera workers."""
    from ..kernels import launch_counters
    from ..obs import registry as obs_registry

    fams = {f.name: f for f in obs_registry.families()}

    def children(name):
        fam = fams.get(name)
        return fam.children() if fam is not None else []

    # Read at rest: a batch in flight has launched its keep mask and not
    # yet counted as a batch.
    launches, batches = srv.engine.at_rest(lambda: (
        {w.__name__.removesuffix("_cuda"): int(w.launches) for w in launch_counters()},
        {labels[0]: h.count for labels, h in children("vep_device_batch_ms")}))
    return {
        "launches": launches,
        "batches": batches,
        "device_ms_p50": {f"{labels[0]}/{labels[1]}": h.percentile(50)
                          for labels, h in children("vep_perf_device_ms") if h.count},
        "max_memory_reserved": (int(torch.cuda.max_memory_reserved())
                                if device == "cuda" else None),
        "torch_threads": torch.get_num_threads(),
        "subscriber_drops": srv.engine.subscriber_drops,
        "capture_s": {f"{c['model']}|{c['geometry']}|{c['bucket']}": c.get("compile_s")
                       for c in srv.engine.perf.snapshot().get("compiles", [])},
        "worker_pids": sorted(e.proc.pid for e in list(srv.process_manager._entries.values())
                              if e.proc is not None),
    }


def _reap_orphan_workers(pids, wait_s: float = 5.0) -> list:
    """The camera workers of a SIGKILLed member still alive ``wait_s``
    after it died, SIGKILLed: their parent-death signal should have ended
    them. Returns their pids (the soak reports them)."""
    import signal

    def alive(pid):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                return b"ingest.worker" in f.read()
        except OSError:
            return False

    deadline = time.monotonic() + wait_s
    left = [p for p in pids if alive(p)]
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = [p for p in left if alive(p)]
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return left


def _member_shm_dir(pid: int) -> str:
    """The ring directory of the fleet member of process ``pid``."""
    shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(shm_root, f"vep_torch_fleet_{pid}")


def _fleet_member_main(argv=None) -> None:
    """One fleet-soak member in a process of its own, spawned by
    :func:`run_fleet_obs`, :func:`run_router_soak` and
    :func:`run_autoscale_soak`: a ``Server`` with its engine on ``--device``
    (the card unless ``cpu`` is asked for; several members share one card),
    its own shm bus, REST and gRPC on ephemeral ports.

    Protocol over stdout (JSON lines; the server logs to stderr):
    ``{"ready": ..., "rest_port", "grpc_port", "torch_threads",
    "boot_split_s", "counts"}`` after boot (``counts``: the launches and
    batches of :func:`_member_counts` at that point, the base of the served
    window's); without ``--serve-only``, the member starts its own ``replay://``
    stream (``--trace``, ``--stream``), serves it for ``--warmup`` +
    ``--duration`` s, stops it and prints ``{"quiesced": ...}`` once the
    engine drained (its counters static: the parent's conservation
    window), then waits on stdin. ``--serve-only``: no stream of its own
    (the fleet router places streams over REST) and a stdin command loop,
    each command acked with a JSON line: ``burn`` forces the engine's
    SLO-burn verdict on (pair with ``--slo-off`` so nothing recomputes
    it), ``calm`` clears it, ``counts`` answers :func:`_member_counts`,
    ``exit`` releases the member. On release the member dumps its span
    rings to ``--spans-out``, stops, and prints
    ``{"exit_counts": ..., **_member_counts}``.

    The JAX member's ``--device`` names its stream; here ``--stream`` does,
    and ``--device`` is the engine's device. ``--torch-threads`` sets the
    process's intra-op threads (several members share the host's cores).
    Without ``--prewarm`` and with ``--aot-cache`` the member prewarms what
    the shared prewarm manifest records (the spawned member's path)."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--instance", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--trace", default="",
                    help="replay trace of the self-started stream (not with --serve-only)")
    ap.add_argument("--stream", default="",
                    help="the self-started stream's name (not with --serve-only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the engine's device")
    ap.add_argument("--torch-threads", type=int, default=0,
                    help="torch intra-op threads of this process (0: torch's default)")
    ap.add_argument("--model", default="tiny_yolov8")
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--warmup", type=float, default=8.0,
                    help="replay seconds before the measured window (the worker's boot "
                         "and the first geometry's build)")
    ap.add_argument("--spans-out", required=True)
    ap.add_argument("--serve-only", action="store_true")
    ap.add_argument("--slo-off", action="store_true",
                    help="no SLO engine: the burn flag is the script's alone")
    ap.add_argument("--ladder-escalate", type=float, default=None,
                    help="engine.ladder_escalate_after_s (the router soak spaces the rungs "
                         "so migration lands between shed_to_fleet and bucket_downshift)")
    ap.add_argument("--shed-staleness-ms", type=float, default=None,
                    help="engine.shed_staleness_ms (set high: the shed rung drops nothing "
                         "and the conservation ledger reads migration alone)")
    ap.add_argument("--batch-bucket", type=int, default=0,
                    help="one collector bucket, so a migrated stream never needs a new "
                         "program mid-soak")
    ap.add_argument("--ladder-slo-only", action="store_true",
                    help="the ladder's queue-depth and tick-lag inputs out of reach: the "
                         "injected SLO burn is its only driver")
    ap.add_argument("--trace-every", type=int, default=None, help="obs.sample_every")
    ap.add_argument("--prewarm", action="append", default=[], metavar="HxWxB[:model]",
                    help="build this program at boot (repeatable)")
    ap.add_argument("--aot-cache", default="",
                    help="shared prewarm manifest directory (engine.aot_cache + "
                         "aot_cache_dir)")
    ap.add_argument("--capacity", action="store_true", help="engine.capacity on")
    ap.add_argument("--capacity-fast-window", type=float, default=None,
                    help="engine.capacity_fast_window_s")
    args = ap.parse_args(argv)
    if not args.serve_only and (not args.trace or not args.stream):
        ap.error("--trace/--stream required without --serve-only")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fleet member: --device cuda but no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    if args.torch_threads > 0:
        torch.set_num_threads(args.torch_threads)
    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from ..obs import tracer
    from ..serve.models import StreamProcess
    from ..serve.server import Server
    from ..utils.config import Config

    cfg = Config()
    cfg.bus.shm_dir = _member_shm_dir(os.getpid())
    cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"   # no egress
    # The member owns its workers: they end with it (parent-death signal),
    # a SIGKILLed member included.
    cfg.worker_adoption = False
    cfg.engine.model = args.model
    cfg.engine.track = False
    cfg.obs.trace = True
    cfg.obs.sample_every = 4
    cfg.obs.instance = args.instance   # the constant instance label on /metrics
    if args.slo_off:
        cfg.engine.slo = False
    if args.ladder_escalate is not None:
        cfg.engine.ladder_escalate_after_s = args.ladder_escalate
    if args.shed_staleness_ms is not None:
        cfg.engine.shed_staleness_ms = args.shed_staleness_ms
    if args.batch_bucket:
        cfg.engine.batch_buckets = (args.batch_bucket,)
    if args.trace_every is not None:
        cfg.obs.sample_every = args.trace_every
    if args.prewarm:
        entries = []
        for spec in args.prewarm:
            geom, _, mdl = spec.partition(":")
            h, w, b = (int(v) for v in geom.split("x"))
            entries.append([h, w, b, mdl] if mdl else [h, w, b])
        cfg.engine.prewarm = entries
    if args.aot_cache:
        cfg.engine.aot_cache = True
        cfg.engine.aot_cache_dir = args.aot_cache
    if args.capacity:
        cfg.engine.capacity = True
    if args.capacity_fast_window is not None:
        cfg.engine.capacity_fast_window_s = args.capacity_fast_window
    t_main = time.monotonic()
    srv = Server(cfg, data_dir=args.workdir, grpc_port=0, rest_port=0, enable_engine=True,
                 device=args.device)
    t_built = time.monotonic()
    # The engine's model and kernels (warmup, the first thing its start
    # does), timed apart from the rest of the start.
    real_warmup, warmup_s = srv.engine.warmup, []

    def timed_warmup():
        t = time.monotonic()
        real_warmup()
        warmup_s.append(time.monotonic() - t)

    srv.engine.warmup = timed_warmup
    srv.start()
    srv.engine.warmup = real_warmup
    if args.ladder_slo_only and srv.engine is not None and srv.engine.ladder is not None:
        srv.engine.ladder.depth_threshold = 10**9
        srv.engine.ladder.lag_factor = 10**9
    t_started = time.monotonic()
    ready_counts = _member_counts(srv, args.device)
    print(json.dumps({"ready": True, "instance": args.instance,
                      "rest_port": srv._rest.bound_port, "grpc_port": srv.bound_grpc_port,
                      "torch_threads": torch.get_num_threads(),
                      # main -> Server built -> the engine's model and
                      # kernels -> started (the prewarm, the serving path's
                      # warm-up batches, the wire)
                      "boot_split_s": [round(t_built - t_main, 3), round(warmup_s[0], 3),
                                       round(t_started - t_built - warmup_s[0], 3)],
                      # the base of the served window's counts: launches
                      # and batches of the boot (captures, warm-ups) are
                      # not the window's
                      "counts": {k: ready_counts[k] for k in ("launches", "batches")}}),
          flush=True)
    try:
        if args.serve_only:
            for line in sys.stdin:
                cmd = line.strip()
                if cmd == "burn":
                    srv.engine._slo_burning = True
                elif cmd == "calm":
                    srv.engine._slo_burning = False
                elif cmd == "counts":
                    print(json.dumps({"ack": "counts", "instance": args.instance,
                                      **_member_counts(srv, args.device)}), flush=True)
                    continue
                elif cmd == "exit":
                    print(json.dumps({"ack": "exit", "instance": args.instance}), flush=True)
                    break
                else:
                    continue
                print(json.dumps({"ack": cmd, "instance": args.instance}), flush=True)
        else:
            srv.process_manager.start(StreamProcess(
                name=args.stream,
                rtsp_endpoint=f"replay://{args.trace}?device={args.stream}&pace=1&loop=1"))
            time.sleep(args.warmup + args.duration)
            srv.process_manager.stop(args.stream)
            time.sleep(1.0)   # the engine drains: counters static after this
            print(json.dumps({"quiesced": True, "instance": args.instance}), flush=True)
            sys.stdin.readline()   # the parent's conservation scrapes are done
    finally:
        events = tracer.events()
        with open(args.spans_out, "w") as f:
            json.dump({"events": events}, f)
        tracer.configure(enabled=False)
        counts = _member_counts(srv, args.device)
        srv.stop()
        shutil.rmtree(cfg.bus.shm_dir, ignore_errors=True)
        print(json.dumps({"exit_counts": True, "instance": args.instance, **counts}),
              flush=True)


def _member_cmd(instance: str, workdir: str, spans_out: str, *, model: str, device: str,
                torch_threads: int, extra: list) -> list:
    import sys

    cmd = [sys.executable, "-m", "video_edge_ai_proxy_tpu_torch.replay.harness",
           "--instance", instance, "--workdir", workdir, "--spans-out", spans_out,
           "--model", model, "--device", device]
    if torch_threads:
        cmd += ["--torch-threads", str(int(torch_threads))]
    return cmd + list(extra)


def _read_msg(proc, key: str, timeout_s: float, where: str) -> dict:
    """The member's next stdout JSON line carrying ``key`` (other lines
    skipped). SystemExit when the member dies or ``timeout_s`` passes;
    ``where`` names the stderr files to read."""
    import json

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"fleet member died (rc={proc.poll()}); see {where}")
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if key in msg:
            return msg
    raise SystemExit(f"fleet member: no {key!r} within {timeout_s}s; see {where}")


def _release(proc, where: str, timeout_s: float = 120.0) -> Optional[dict]:
    """Send ``exit``, read the member's ``exit_counts`` line, reap it.
    None when the member had already ended."""
    if proc.poll() is not None:
        return None
    try:
        proc.stdin.write("exit\n")
        proc.stdin.flush()
    except (BrokenPipeError, OSError):
        return None
    try:
        counts = _read_msg(proc, "exit_counts", timeout_s, where)
    except SystemExit:
        counts = None
    try:
        proc.stdin.close()
    except (BrokenPipeError, OSError):
        pass
    try:
        proc.wait(timeout=60)
    except Exception:  # noqa: BLE001 -- reaped below by kill
        proc.kill()
        proc.wait(timeout=30)
    return counts


def run_fleet_obs(
    *, n_members: int = 3, duration_s: float = 12.0, warmup_s: float = 8.0,
    width: int = 128, height: int = 96, fps: float = 30.0,
    model: str = "tiny_yolov8", device: str = "cuda", torch_threads: int = 0,
    workdir: Optional[str] = None,
) -> dict:
    """The fleet telemetry soak: N member servers in processes of their own
    (each with its replay worker process, shm bus, engine, gRPC and REST),
    one ``FleetAggregator`` scraping them and one gRPC client per member
    recording the ``InferenceResult.trace_id`` echo. The payload of JAX's
    ``run_fleet_obs`` (``FLEETOBS_r01.json``) with its gates:

    - ``merged_lint_clean`` / ``member_lint_clean``: the aggregator's one
      page and every member's pass ``lint_exposition``;
    - ``all_members_present``: every member up and fresh at quiesce;
    - ``stitched_traces`` >= 1: a trace id minted in a member's worker
      process, seen by the engine's collect/device/emit spans and received
      by the client;
    - ``counters_conserved``: after quiesce every merged counter equals the
      members' sum (over the families static across the window);
    - ``fleet_trace_valid``: the members' spans as one valid Chrome trace.

    ``device``: the members' engines' (several members share one card);
    ``torch_threads``: each member's intra-op threads. The payload adds
    ``backend`` and per-member ``boot_s``, ``first_frame_s`` (Popen to the
    first result at the client), the member's counts at its ready line
    (``ready_counts``) and its last counts (:func:`_member_counts`)."""
    import json as _json
    import subprocess
    import urllib.request

    import grpc

    from ..obs.fleet import FleetAggregator, _strip_label, parse_exposition
    from ..obs.metrics import lint_exposition
    from ..obs.spans import to_chrome_trace, validate_chrome_trace
    from ..proto import video_streaming_pb2 as pb
    from ..proto import video_streaming_pb2_grpc as pb_grpc

    backend = resolve_device(device).type
    tmp = workdir or tempfile.mkdtemp(prefix="vep_torch_fleetobs_")
    os.makedirs(tmp, exist_ok=True)
    where = f"{tmp}/m*.stderr"
    procs: list = []
    spans_paths: list = []
    t_popen: list = []
    counts: list = [None] * n_members
    try:
        for i in range(n_members):
            stream = f"fleet{i}"
            trace_path = os.path.join(tmp, f"{stream}.vtrace")
            record_synthetic_trace(trace_path, [stream], width=width, height=height, fps=fps,
                                   gop=30, frames=max(90, int(fps * 10)))
            spans_out = os.path.join(tmp, f"m{i}_spans.json")
            spans_paths.append(spans_out)
            member_dir = os.path.join(tmp, f"m{i}")
            os.makedirs(member_dir, exist_ok=True)
            # The one stream's program (bucket 1) is built at boot, as
            # run_e2e's is: on the card its graph is captured before the
            # ready line, not on the first frame.
            cmd = _member_cmd(f"m{i}", member_dir, spans_out, model=model, device=backend,
                              torch_threads=torch_threads,
                              extra=["--trace", trace_path, "--stream", stream,
                                     "--duration", str(duration_s), "--warmup", str(warmup_s),
                                     "--prewarm", f"{height}x{width}x1"])
            t_popen.append(time.monotonic())
            procs.append(subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(os.path.join(tmp, f"m{i}.stderr"), "w"), text=True))

        boots = [_read_msg(p, "ready", 300.0, where) for p in procs]
        boot_s = [round(time.monotonic() - t, 3) for t in t_popen]
        rest_ports = [b["rest_port"] for b in boots]
        grpc_ports = [b["grpc_port"] for b in boots]

        agg = FleetAggregator([f"m{i}=http://127.0.0.1:{rest_ports[i]}"
                               for i in range(n_members)], scrape_interval_s=1.0)
        agg.start()

        client_tids: list = [set() for _ in range(n_members)]
        results_count = [0] * n_members
        first_rx: list = [None] * n_members
        stop = threading.Event()

        def client(i: int) -> None:
            channel = grpc.insecure_channel(f"127.0.0.1:{grpc_ports[i]}")
            stub = pb_grpc.ImageStub(channel)
            while not stop.is_set():
                try:
                    for res in stub.Inference(pb.InferenceRequest(), timeout=5):
                        if stop.is_set():
                            break
                        if first_rx[i] is None:
                            first_rx[i] = time.monotonic()
                        results_count[i] += 1
                        if res.trace_id:
                            client_tids[i].add(res.trace_id)
                except grpc.RpcError:
                    if not stop.is_set():
                        time.sleep(0.5)
            channel.close()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n_members)]
        for t in threads:
            t.start()
        for p in procs:
            _read_msg(p, "quiesced", warmup_s + duration_s + 120.0, where)
        stop.set()
        for t in threads:
            t.join(timeout=10)

        # The conservation window: streams stopped and drained; heartbeat
        # counters (the tick loop) still move, so the gate holds the
        # families static across two direct scrapes around the
        # aggregator's.
        def scrape_pages():
            pages = []
            for port in rest_ports:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    pages.append(r.read().decode())
            return pages

        def counter_sums(pages):
            out: dict = {}
            for page in pages:
                for fam in parse_exposition(page):
                    if fam["kind"] != "counter":
                        continue
                    for _name, labels, value in fam["samples"]:
                        key = (fam["name"], _strip_label(labels, "instance"))
                        out[key] = out.get(key, 0.0) + value
            return out

        pages_before = scrape_pages()
        agg.scrape_once()
        pages_after = scrape_pages()
        member_lint = [lint_exposition(p) for p in pages_after]
        before = counter_sums(pages_before)
        after = counter_sums(pages_after)
        static_keys = sorted(k for k, v in before.items() if after.get(k) == v)
        merged_counters = agg.fleet_stats()["counters"]
        mismatches = []
        for fam_name, labels in static_keys:
            want = before[(fam_name, labels)]
            got = merged_counters.get(fam_name, {}).get(labels, {}).get("value")
            if got is None or abs(got - want) > 1e-6:
                mismatches.append({"family": fam_name, "labels": labels,
                                   "member_sum": want, "merged": got})

        merged_text = agg.merged_exposition()
        lint_errors = lint_exposition(merged_text)
        health = agg.health()
        all_present = (len(health) == n_members
                       and all(h["up"] and not h["stale"] for h in health))

        for i, p in enumerate(procs):
            counts[i] = _release(p, where)
        agg.stop()

        member_spans = []
        for path in spans_paths:
            with open(path) as f:
                member_spans.append(_json.load(f).get("events", []))
        merged_events: list = []
        for i, evs in enumerate(member_spans):
            merged_events.extend(to_chrome_trace(
                evs, pid=i + 1, process_name=f"m{i}")["traceEvents"])
        fleet_trace = {"traceEvents": merged_events, "displayTimeUnit": "ms"}
        trace_problems = validate_chrome_trace(fleet_trace)

        stitched = []
        for i, evs in enumerate(member_spans):
            stages_by_tid: dict = {}
            for ev in evs:
                tid = ev.get("trace_id")
                if tid:
                    stages_by_tid.setdefault(tid, set()).add(ev["stage"])
            for tid, stages in sorted(stages_by_tid.items()):
                if {"collect", "device", "emit"} <= stages and tid in client_tids[i]:
                    stitched.append({"member": f"m{i}", "trace_id": tid,
                                     "stages": sorted(stages)})

        return {
            "metric": f"fleet_obs_{n_members}x_{model}",
            "pipeline": (f"{n_members}x [replay worker -> shm bus -> engine -> gRPC/REST] -> "
                         "FleetAggregator + per-member clients"),
            "backend": backend,
            "members": n_members,
            "duration_s": duration_s,
            "model": model,
            "src_hw": [height, width],
            "fps": fps,
            "gates": {
                "merged_lint_clean": not lint_errors,
                "member_lint_clean": all(not e for e in member_lint),
                "all_members_present": all_present,
                "stitched_traces": len(stitched),
                "counters_conserved": bool(static_keys) and not mismatches,
                "fleet_trace_valid": not trace_problems,
            },
            "lint_errors": lint_errors[:10],
            "counters_gated": len(static_keys),
            "counter_mismatches": mismatches[:10],
            "trace_problems": trace_problems[:10],
            "health": health,
            "stitched_example": stitched[0] if stitched else None,
            "client_results": results_count,
            "client_trace_ids": [len(s) for s in client_tids],
            "merged_exposition_lines": len(merged_text.splitlines()),
            "merged_counter_families": len(merged_counters),
            "fleet_trace_events": len(merged_events),
            "span_events_per_member": [len(s) for s in member_spans],
            "member_runs": {
                f"m{i}": {"boot_s": boot_s[i], "boot_split_s": boots[i]["boot_split_s"],
                          "torch_threads": boots[i]["torch_threads"],
                          "ready_counts": boots[i]["counts"],
                          "first_frame_s": (round(first_rx[i] - t_popen[i], 3)
                                            if first_rx[i] is not None else None),
                          "counts": counts[i]}
                for i in range(n_members)},
        }
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()   # by PID through the Popen handle
                p.wait(timeout=30)
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def _stitched(member_spans: dict, tids: dict, mname: str, stream: str) -> bool:
    """A trace id with the whole collect+device+emit span chain on
    ``mname`` that ``mname``'s gRPC client also received for ``stream``:
    worker -> bus -> engine -> client under one id."""
    stages_by_tid: dict = {}
    for ev in member_spans.get(mname, []):
        tid = ev.get("trace_id")
        if tid:
            stages_by_tid.setdefault(tid, set()).add(ev["stage"])
    want = tids.get(mname, {}).get(stream, set())
    return any({"collect", "device", "emit"} <= stages and tid in want
               for tid, stages in stages_by_tid.items())


def run_router_soak(
    *, n_members: int = 3, streams_per_member: int = 2,
    width: int = 128, height: int = 96, fps: float = 2.0,
    model: str = "tiny_yolov8", scrape_interval_s: float = 1.0,
    ladder_escalate_s: float = 8.0, device: str = "cuda", torch_threads: int = 0,
    workdir: Optional[str] = None,
) -> dict:
    """The fleet-router soak (JAX's ``run_router_soak``, the
    ``ROUTER_r01.json`` payload): N serve-only members in processes of
    their own, one ``StreamRouter`` placing ``n_members *
    streams_per_member`` replay streams on them, then two legs:

    - **burn**: the first member's SLO-burn verdict forced on (stdin
      ``burn``; the member runs ``--slo-off``). Its ladder walks shed ->
      shed_to_fleet and the router migrates its streams away (drain ->
      cutover -> resume at the replay cursor). Gate: at migration's end
      the member's ladder shows ``shed_to_fleet >= 1`` and
      ``bucket_downshift == 0`` transitions.
    - **kill**: the last member SIGKILLed. Gates: every stream re-placed,
      detection -> resumed within one scrape interval, kill -> resumed
      within the interval + 1 s. Its camera workers still alive 5 s later
      are SIGKILLed and listed (``kill.orphan_workers_reaped``).

    Across both: the conservation ledger balances for every stream
    (packet ids gap-free from the first delivery, no duplicate), every
    completed migration has a stitched lineage, and the router's
    ``vep_router_*`` families are lint-clean.

    As in JAX: one pinned batch bucket, its program prewarmed at boot (on
    the card, its graph captured) so no mid-soak build drops a frame;
    shed staleness above the soak; ``ladder_escalate_s`` spacing the
    rungs; ``--ladder-slo-only`` members. ``device``/``torch_threads``:
    the members'. The payload adds ``backend`` and ``member_runs`` (boot
    s, first frame s, each member's counts at its ready line and its last
    counts, the killed member's taken just before the kill)."""
    import json as _json
    import subprocess
    import urllib.request

    import grpc

    from ..obs import registry as obs_registry
    from ..obs.metrics import lint_exposition
    from ..proto import video_streaming_pb2 as pb
    from ..proto import video_streaming_pb2_grpc as pb_grpc
    from ..serve.router import StreamRouter

    backend = resolve_device(device).type
    tmp = workdir or tempfile.mkdtemp(prefix="vep_torch_router_")
    os.makedirs(tmp, exist_ok=True)
    where = f"{tmp}/m*.stderr"
    member_names = [f"m{i}" for i in range(n_members)]
    bucket = 1
    while bucket < n_members * streams_per_member + 2:
        bucket *= 2
    procs: list = []
    spans_paths: list = []
    t_popen: list = []
    first_rx: dict = {}
    counts: dict = {}
    router: Optional[StreamRouter] = None
    stop = threading.Event()
    threads: list = []
    try:
        for mname in member_names:
            spans_out = os.path.join(tmp, f"{mname}_spans.json")
            spans_paths.append(spans_out)
            member_dir = os.path.join(tmp, mname)
            os.makedirs(member_dir, exist_ok=True)
            cmd = _member_cmd(mname, member_dir, spans_out, model=model, device=backend,
                              torch_threads=torch_threads, extra=[
                                  "--serve-only", "--slo-off", "--ladder-slo-only",
                                  "--ladder-escalate", str(ladder_escalate_s),
                                  "--shed-staleness-ms", "60000",
                                  "--batch-bucket", str(bucket), "--trace-every", "1",
                                  "--prewarm", f"{height}x{width}x{bucket}"])
            t_popen.append(time.monotonic())
            procs.append(subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(os.path.join(tmp, f"{mname}.stderr"), "w"), text=True))

        def send_cmd(idx: int, cmd: str, ack: bool = True):
            procs[idx].stdin.write(cmd + "\n")
            procs[idx].stdin.flush()
            if ack:
                return _read_msg(procs[idx], "ack", 60.0, where)
            return None

        boots = [_read_msg(p, "ready", 300.0, where) for p in procs]
        boot_s = [round(time.monotonic() - t, 3) for t in t_popen]
        rest_ports = [b["rest_port"] for b in boots]
        grpc_ports = [b["grpc_port"] for b in boots]

        router = StreamRouter(
            [f"{m}=http://127.0.0.1:{rest_ports[i]}" for i, m in enumerate(member_names)],
            scrape_interval_s=scrape_interval_s,
            max_moves_per_pass=n_members * streams_per_member,
            # The drain's poll and settle cover a whole tick: a frame
            # collected just before the stop lands on the source's counter
            # up to a tick after it first reads static.
            drain_timeout_s=5.0, drain_poll_s=0.5)
        router.run_pass()
        attach_errors = {k: v for k, v in router.attach().items() if v}

        # A balanced first placement by the names: the first
        # streams_per_member candidates that hash onto each member.
        per_member: dict = {m: [] for m in member_names}
        cand = 0
        while any(len(v) < streams_per_member for v in per_member.values()):
            name = f"cam{cand:03d}"
            cand += 1
            owner = router.ring.place(name)
            if owner and len(per_member[owner]) < streams_per_member:
                per_member[owner].append(name)
            if cand > 10_000:
                raise SystemExit("hash search failed to balance placement")
        stream_names = [n for m in member_names for n in per_member[m]]
        # One long trace per stream: frames outlast the soak (a loop would
        # deliver packet ids again and fake a conservation fault).
        for name in stream_names:
            record_synthetic_trace(os.path.join(tmp, f"{name}.vtrace"), [name], width=width,
                                   height=height, fps=fps, gop=30, frames=int(fps * 240))

        tids: dict = {m: {} for m in member_names}

        def client(i: int) -> None:
            mname = member_names[i]
            channel = grpc.insecure_channel(f"127.0.0.1:{grpc_ports[i]}")
            stub = pb_grpc.ImageStub(channel)
            while not stop.is_set():
                try:
                    # No deadline: a re-subscribe gap would lose results and
                    # fake ledger losses; a dead member raises instead.
                    for res in stub.Inference(pb.InferenceRequest()):
                        if stop.is_set():
                            break
                        if not res.device_id:
                            continue
                        first_rx.setdefault(mname, time.monotonic())
                        router.ledger.note_delivery(res.device_id, mname, res.frame_packet,
                                                    res.trace_id)
                        if res.trace_id:
                            tids[mname].setdefault(res.device_id, set()).add(res.trace_id)
                except grpc.RpcError:
                    if not stop.is_set():
                        time.sleep(0.25)
            channel.close()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n_members)]
        for t in threads:
            t.start()

        for name in stream_names:
            placed = router.add_stream(
                name, f"replay://{tmp}/{name}.vtrace?device={name}&pace=1&loop=0",
                priority=stream_names.index(name))
            if placed not in per_member or name not in per_member[placed]:
                raise SystemExit(f"{name} placed on {placed}, not where its hash put it")

        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            if all(router.ledger.next_cursor(n) is not None for n in stream_names):
                break
            time.sleep(0.25)
        else:
            raise SystemExit(f"warmup: not every stream delivered results; see {where}")
        time.sleep(2.0)                         # the pipeline settles
        router.start()

        # -- burn leg: m0 burns; the ladder hands off before downshift.
        burn_member = member_names[0]
        burn_streams = list(per_member[burn_member])
        send_cmd(0, "burn")
        t_burn = time.monotonic()
        deadline = t_burn + 2 * ladder_escalate_s + 3 * scrape_interval_s + 10.0
        while time.monotonic() < deadline:
            if not router.streams_on(burn_member):
                break
            time.sleep(0.05)
        burn_evacuated = not router.streams_on(burn_member)
        t_burn_done = time.monotonic()
        with urllib.request.urlopen(f"http://127.0.0.1:{rest_ports[0]}/api/v1/router",
                                    timeout=5) as r:
            burn_ladder = _json.loads(r.read())
        send_cmd(0, "calm")
        burn_transitions = burn_ladder.get("transitions", {})
        # The ladder's recovery walk: while the burn member still reads
        # shed_to_fleet or above, the router would shed onto it again.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"http://127.0.0.1:{rest_ports[0]}/api/v1/router",
                                        timeout=5) as r:
                if _json.loads(r.read()).get("rung") in ("normal", "shed"):
                    break
            time.sleep(0.25)
        time.sleep(3.0)                         # resumed streams deliver

        # -- kill leg: SIGKILL the last member.
        kill_idx = n_members - 1
        kill_member = member_names[kill_idx]
        kill_streams = list(router.streams_on(kill_member))
        counts[kill_member] = {k: v for k, v in send_cmd(kill_idx, "counts").items()
                               if k not in ("ack", "instance")}
        procs[kill_idx].kill()   # by PID through the Popen handle
        procs[kill_idx].wait(timeout=10)
        t_kill = time.monotonic()
        deadline = t_kill + 3 * scrape_interval_s + 10.0
        while time.monotonic() < deadline:
            if not router.streams_on(kill_member):
                break
            time.sleep(0.02)
        kill_wall_s = time.monotonic() - t_kill
        kill_evacuated = not router.streams_on(kill_member)
        time.sleep(4.0)                         # resumed streams deliver
        # A killed member leaves its ring directory behind, and any worker
        # its parent-death signal did not end.
        orphans = _reap_orphan_workers(counts[kill_member].get("worker_pids") or [])
        shutil.rmtree(_member_shm_dir(procs[kill_idx].pid), ignore_errors=True)

        router.stop()
        migrations = list(router.ledger.migrations)
        kill_migs = [m for m in migrations if m["reason"] == "member_dead"]
        burn_migs = [m for m in migrations if m["src"] == burn_member and m["ok"]]
        kill_detect_s = max((m["replace_s"] for m in kill_migs if m.get("ok")), default=None)

        stop.set()
        for t in threads:
            t.join(timeout=10)
        balance = router.ledger.balance()

        for i, p in enumerate(procs):
            if i != kill_idx:
                counts[member_names[i]] = _release(p, where)

        member_spans: dict = {}
        for mname, path in zip(member_names, spans_paths):
            if not os.path.exists(path):
                member_spans[mname] = []
                continue
            with open(path) as f:
                member_spans[mname] = _json.load(f).get("events", [])

        lineage = []
        for m in migrations:
            if not m.get("ok"):
                continue
            row = {"stream": m["stream"], "src": m["src"], "dst": m["dst"],
                   "reason": m["reason"],
                   "dst_stitched": _stitched(member_spans, tids, m["dst"], m["stream"])}
            if (not row["dst_stitched"] and m["dst"] == kill_member
                    and not member_spans.get(kill_member)):
                # A burn-leg migration onto the member the kill leg later
                # SIGKILLs: its span dump is lost, so the trace ids its
                # client did receive for the stream are the lineage left.
                row["dst_stitched"] = bool(tids.get(kill_member, {}).get(m["stream"]))
                row["dst_evidence"] = "client-delivered trace ids (span dump lost to kill)"
            if m["src"] != kill_member:
                row["src_stitched"] = _stitched(member_spans, tids, m["src"], m["stream"])
            lineage.append(row)
        lineage_ok = bool(lineage) and all(
            r["dst_stitched"] and r.get("src_stitched", True) for r in lineage)

        exposition = obs_registry.render()
        lint_errors = lint_exposition(exposition)
        router_families = sorted({line.split()[2] for line in exposition.splitlines()
                                  if line.startswith("# TYPE vep_router_")})

        gates = {
            "attach_clean": not attach_errors,
            "burn_streams_evacuated": burn_evacuated and bool(burn_migs),
            "burn_shed_to_fleet_before_downshift": (
                burn_transitions.get("shed_to_fleet", 0) >= 1
                and burn_transitions.get("bucket_downshift", 0) == 0),
            "kill_streams_replaced": (kill_evacuated and bool(kill_streams)
                                      and all(m.get("ok") for m in kill_migs)),
            "kill_replace_within_scrape": (kill_detect_s is not None
                                           and kill_detect_s <= scrape_interval_s),
            "kill_replace_wall_bounded": kill_wall_s <= scrape_interval_s + 1.0,
            "ledger_balanced": balance["balanced"],
            "migrated_lineage_stitched": lineage_ok,
            "router_metrics_lint_clean": not lint_errors and len(router_families) >= 6,
        }
        return {
            "metric": f"fleet_router_{n_members}x{streams_per_member}_{model}",
            "pipeline": (f"{n_members}x serve-only member <- StreamRouter (consistent hash + "
                         "burn/kill migration) <- per-member gRPC clients -> conservation "
                         "ledger"),
            "backend": backend,
            "members": n_members,
            "streams": len(stream_names),
            "fps": fps,
            "model": model,
            "src_hw": [height, width],
            "scrape_interval_s": scrape_interval_s,
            "ladder_escalate_s": ladder_escalate_s,
            "gates": gates,
            "placement": per_member,
            "burn": {"member": burn_member, "streams": burn_streams,
                     "migrate_s": round(t_burn_done - t_burn, 3),
                     "transitions_at_migration": burn_transitions, "ladder": burn_ladder,
                     "migrations": burn_migs},
            "kill": {"member": kill_member, "streams": kill_streams,
                     "replace_detect_s": kill_detect_s, "replace_wall_s": round(kill_wall_s, 3),
                     "migrations": kill_migs, "orphan_workers_reaped": orphans},
            "ledger": {"balanced": balance["balanced"], "lost": balance["lost"],
                       "duplicated": balance["duplicated"], "streams": balance["streams"]},
            "lineage": lineage,
            "lint_errors": lint_errors[:10],
            "router_families": router_families,
            "router_snapshot": router.snapshot(),
            "member_runs": {
                m: {"boot_s": boot_s[i], "boot_split_s": boots[i]["boot_split_s"],
                    "torch_threads": boots[i]["torch_threads"],
                    "ready_counts": boots[i]["counts"],
                    "first_frame_s": (round(first_rx[m] - t_popen[i], 3)
                                      if m in first_rx else None),
                    "counts": counts.get(m)}
                for i, m in enumerate(member_names)},
        }
    finally:
        stop.set()
        if router is not None:
            router.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()   # by PID through the Popen handle
                p.wait(timeout=30)
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


class LoadShape:
    """Production-shaped churn schedule for the autoscale soak (JAX's).

    Four shapes the reference deployments actually see, folded into one
    deterministic timetable (no RNG — reruns hit identical schedules):

    - **diurnal ramp** — ``ramp_streams`` cameras connect one every
      ``ramp_interval_s`` on top of the ``base_streams`` steady tenants:
      the morning build-up whose utilization *slope* the capacity
      forecast extrapolates into ``time_to_saturation_s`` — the signal
      the supervisor must act on BEFORE saturation, not after. The ramp
      deliberately outlasts a spawned member's boot, so the arrivals
      still connecting when the fresh member comes up land on it (the
      headroom-tiered admission prefers the emptiest member) — scale-out
      absorbs the tail of the very build-up that triggered it.
    - **connect/disconnect storm** — ``storm_streams`` cameras connect
      within seconds (an NVR rebooting, a site coming back from a
      network partition) and later disconnect just as fast. The storm
      lands AFTER the ramp so a forecast-driven scale-out has already
      added capacity when it hits.
    - **hot-spot camera** — the first base stream runs ``hot_fps``
      against everyone else's ``base_fps``: one member always carries
      visibly more load than its peers, so placement/retire decisions
      ride on real per-member skew, not uniform load.
    - **mixed model tenants** — stream specs rotate through ``models``
      (``""`` = the member default), so members serve multiple device
      programs and the AOT prewarm manifest has to carry the full
      program SET, not one geometry.

    ``specs()`` lists every stream (name, fps, model, phase);
    ``events()`` is the sorted ``{"t", "op", "stream"}`` timetable
    relative to the soak's post-warmup t=0 (base connects at t<=0 run
    before the supervisor starts).
    """

    def __init__(
        self, *, base_streams: int = 3, ramp_streams: int = 6,
        ramp_start_s: float = 2.0, ramp_interval_s: float = 4.0,
        storm_streams: int = 6, storm_start_s: float = 28.0,
        storm_spacing_s: float = 0.4, storm_hold_s: float = 18.0,
        drain_interval_s: float = 0.8,
        base_fps: float = 0.5, hot_fps: float = 1.5,
        models: tuple = ("", "tiny_mobilenet_v2"),
    ):
        if base_streams < 1 or storm_streams < 1:
            raise ValueError("need at least one base and one storm stream")
        if storm_start_s <= ramp_start_s + ramp_streams * ramp_interval_s:
            raise ValueError(
                "storm must start after the ramp finishes (the shape's "
                "point is that forecast-driven scale-out lands first)")
        self.base_streams = int(base_streams)
        self.ramp_streams = int(ramp_streams)
        self.ramp_start_s = float(ramp_start_s)
        self.ramp_interval_s = float(ramp_interval_s)
        self.storm_streams = int(storm_streams)
        self.storm_start_s = float(storm_start_s)
        self.storm_spacing_s = float(storm_spacing_s)
        self.storm_hold_s = float(storm_hold_s)
        self.drain_interval_s = float(drain_interval_s)
        self.base_fps = float(base_fps)
        self.hot_fps = float(hot_fps)
        self.models = tuple(models)

    def specs(self) -> list:
        out = []
        tenant = 0
        for phase, count, prefix in (
                ("base", self.base_streams, "base"),
                ("ramp", self.ramp_streams, "ramp"),
                ("storm", self.storm_streams, "storm")):
            for i in range(count):
                hot = phase == "base" and i == 0
                out.append({
                    "stream": f"{prefix}{i:03d}",
                    "phase": phase,
                    "hot": hot,
                    "fps": self.hot_fps if hot else self.base_fps,
                    "model": self.models[tenant % len(self.models)],
                })
                tenant += 1
        return out

    def events(self) -> list:
        ev = []
        for spec in self.specs():
            name, phase = spec["stream"], spec["phase"]
            i = int(name[-3:])
            if phase == "base":
                ev.append({"t": 0.0, "op": "connect", "stream": name})
            elif phase == "ramp":
                t_on = self.ramp_start_s + i * self.ramp_interval_s
                ev.append({"t": t_on, "op": "connect", "stream": name})
                # Ramp sheds after the storm has fully drained: the
                # surplus the retire leg waits on is sustained, not a
                # lull between waves.
                t_off = (self.storm_start_s + self.storm_hold_s
                         + self.storm_streams * self.drain_interval_s
                         + 1.0 + i * self.drain_interval_s)
                ev.append({"t": t_off, "op": "disconnect", "stream": name})
            else:
                t_on = self.storm_start_s + i * self.storm_spacing_s
                ev.append({"t": t_on, "op": "connect", "stream": name})
                t_off = (self.storm_start_s + self.storm_hold_s
                         + i * self.drain_interval_s)
                ev.append({"t": t_off, "op": "disconnect", "stream": name})
        ev.sort(key=lambda e: (e["t"], e["stream"], e["op"]))
        return ev

    @property
    def duration_s(self) -> float:
        return max(e["t"] for e in self.events())


def run_autoscale_soak(
    *, width: int = 128, height: int = 96, model: str = "tiny_yolov8",
    scrape_interval_s: float = 1.0,
    capacity_scrape_interval_s: float = 30.0,
    decision_interval_s: float = 1.0, spawn_horizon_s: float = 1800.0,
    surplus_headroom: float = 0.3, surplus_hold_s: float = 8.0,
    spawn_cooldown_s: float = 12.0, retire_cooldown_s: float = 60.0,
    capacity_fast_window_s: float = 5.0,
    storm_admission_bound_s: float = 12.0,
    shape: Optional[LoadShape] = None,
    ref_spawn_headroom: Optional[float] = None,
    device: str = "cuda", torch_threads: int = 0,
    workdir: Optional[str] = None,
) -> dict:
    """The autoscale soak (JAX's ``run_autoscale_soak``, the
    ``AUTOSCALE_r01.json`` payload): a ``FleetSupervisor`` with a real
    subprocess spawner over a :class:`LoadShape` churn schedule.

    Two members boot one after the other on a shared prewarm manifest
    directory (m0 records its program set there; m1 prewarms the same).
    The spawned member boots with no ``--prewarm`` flag: its program set
    comes from the manifest. The port keeps no compiled program on disk
    (a CUDA graph cannot be saved), so the member captures each program
    anew at boot; ``spawn_prewarm_from_manifest`` reads, as in JAX, that
    the manifest supplied every recorded program (``aot_cache`` on) and
    the prewarm completed.

    Gates (JAX's eleven): ``attach_clean``, ``scale_out_on_forecast`` (the
    one spawn's reason is ``saturation_forecast``), ``scale_out_beats_burn``
    (it fired with positive headroom), ``spawn_prewarm_from_manifest``,
    ``spawn_first_frame_within_scrape`` (Popen -> the spawned member's first
    served frame within ``capacity_scrape_interval_s``),
    ``storm_admission_bounded`` (connect -> first frame p99 under
    ``storm_admission_bound_s``), ``retire_on_surplus``, ``no_flap`` (one
    spawn, one retire, back at two members), ``ledger_balanced``,
    ``no_admission_errors``, ``supervisor_metrics_lint_clean``.

    ``ref_spawn_headroom``: the fleet's min headroom at the spawn of the
    run the shape's rates and ``spawn_horizon_s`` were set on
    (``AUTOSCALE_r01.json``'s ``spawn.event.min_headroom``, the JAX tool on
    the CPU). The forecast is headroom over the utilization's slope, and
    at equal traffic both utilization and slope scale with a frame's device
    cost. So with the members' min headroom ``h`` read at the end of the
    base warmup (``base_min_headroom``), the horizon used is
    ``spawn_horizon_s * (h / ref) * ((1 - ref) / (1 - h))``: the decision
    falls at the point of the shape where it fell on the reference run,
    with the headroom of this device there (about ``h``). Both values are
    in the payload's ``config``.
    ``device``/``torch_threads``: the members'."""
    import itertools
    import json as _json
    import subprocess
    import urllib.request

    import grpc

    from ..obs import registry as obs_registry
    from ..obs.metrics import lint_exposition
    from ..proto import video_streaming_pb2 as pb
    from ..proto import video_streaming_pb2_grpc as pb_grpc
    from ..serve.router import StreamRouter
    from ..serve.supervisor import FleetSupervisor

    backend = resolve_device(device).type
    shape = shape or LoadShape()
    tmp = workdir or tempfile.mkdtemp(prefix="vep_torch_autoscale_")
    os.makedirs(tmp, exist_ok=True)
    where = f"{tmp}/*.stderr"
    aot_dir = os.path.join(tmp, "aot_cache")
    bucket = 8
    specs = {s["stream"]: s for s in shape.specs()}
    tenant_models = sorted({s["model"] for s in shape.specs() if s["model"]})

    stop = threading.Event()
    rx_lock = threading.Lock()
    first_rx: dict = {}          # stream -> monotonic of its first delivery
    member_first_rx: dict = {}   # member -> monotonic of its first served frame
    t_admit: dict = {}           # stream -> monotonic at admit()
    admitted: dict = {}          # stream -> the member admit() placed it on
    procs_by_name: dict = {}
    boots: dict = {}             # member -> boot_s, ports, prewarm flags
    spawn_info: dict = {}
    retire_info: dict = {}
    counts: dict = {}
    failures: list = []
    threads: list = []
    router: Optional[StreamRouter] = None
    sup: Optional[FleetSupervisor] = None

    def _boot_member(mname: str, *, prewarm: bool):
        """Popen -> ready; (base_url, grpc_port). ``prewarm=False``: no
        --prewarm flag, the program set comes from the manifest."""
        member_dir = os.path.join(tmp, mname)
        os.makedirs(member_dir, exist_ok=True)
        extra = ["--serve-only", "--slo-off", "--ladder-slo-only",
                 "--shed-staleness-ms", "600000", "--batch-bucket", str(bucket),
                 "--capacity", "--capacity-fast-window", str(capacity_fast_window_s),
                 "--aot-cache", aot_dir]
        if prewarm:
            extra += ["--prewarm", f"{height}x{width}x{bucket}"]
            for mdl in tenant_models:
                extra += ["--prewarm", f"{height}x{width}x{bucket}:{mdl}"]
        cmd = _member_cmd(mname, member_dir, os.path.join(tmp, f"{mname}_spans.json"),
                          model=model, device=backend, torch_threads=torch_threads,
                          extra=extra)
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=open(os.path.join(tmp, f"{mname}.stderr"), "w"),
                                text=True)
        procs_by_name[mname] = proc
        msg = _read_msg(proc, "ready", 300.0, where)
        boots[mname] = {"t_popen": t0, "boot_s": round(time.monotonic() - t0, 3),
                        "rest_port": msg["rest_port"], "grpc_port": msg["grpc_port"],
                        "torch_threads": msg["torch_threads"],
                        "boot_split_s": msg["boot_split_s"], "ready_counts": msg["counts"],
                        "prewarm_flags": prewarm}
        return f"http://127.0.0.1:{msg['rest_port']}", msg["grpc_port"]

    def _start_client(mname: str, grpc_port: int) -> None:
        def _client():
            channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
            stub = pb_grpc.ImageStub(channel)
            while not stop.is_set():
                try:
                    for res in stub.Inference(pb.InferenceRequest()):
                        if stop.is_set():
                            break
                        if not res.device_id:
                            continue
                        now = time.monotonic()
                        router.ledger.note_delivery(res.device_id, mname, res.frame_packet,
                                                    res.trace_id)
                        with rx_lock:
                            first_rx.setdefault(res.device_id, now)
                            member_first_rx.setdefault(mname, now)
                except grpc.RpcError:
                    if not stop.is_set():
                        time.sleep(0.25)
            channel.close()

        t = threading.Thread(target=_client, daemon=True, name=f"autoscale-client-{mname}")
        threads.append(t)
        t.start()

    def _send_exit(mname: str) -> None:
        proc = procs_by_name.get(mname)
        if proc is not None and mname not in counts:
            counts[mname] = _release(proc, where)

    def _min_headroom(urls: dict) -> Optional[float]:
        """The members' least forecast headroom (their capacity planes)."""
        heads = []
        for url in urls.values():
            with urllib.request.urlopen(f"{url}/api/v1/capacity", timeout=5) as r:
                head = _json.loads(r.read()).get("headroom")
            if head is not None:
                heads.append(float(head))
        return min(heads) if heads else None

    try:
        for spec in shape.specs():
            record_synthetic_trace(os.path.join(tmp, f"{spec['stream']}.vtrace"),
                                   [spec["stream"]], width=width, height=height,
                                   fps=spec["fps"], gop=30, frames=int(spec["fps"] * 240))

        # m0 boots first and records the manifest; m1 boots on it.
        urls = {}
        for mname in ("m0", "m1"):
            urls[mname], _ = _boot_member(mname, prewarm=True)

        router = StreamRouter([f"{m}={urls[m]}" for m in ("m0", "m1")],
                              scrape_interval_s=scrape_interval_s, max_moves_per_pass=16,
                              drain_timeout_s=5.0, drain_poll_s=0.5)
        router.run_pass()
        attach_errors = {k: v for k, v in router.attach().items() if v}
        for mname in ("m0", "m1"):
            _start_client(mname, boots[mname]["grpc_port"])
        router.start()

        admit_seq = itertools.count()

        def _admit(name: str) -> None:
            url = f"replay://{tmp}/{name}.vtrace?device={name}&pace=1&loop=0"
            t_admit[name] = time.monotonic()
            try:
                admitted[name] = router.admit(name, url, priority=next(admit_seq),
                                              inference_model=specs[name]["model"])
            except Exception as exc:  # noqa: BLE001 -- a gate, not an abort
                failures.append(f"admit {name}: {type(exc).__name__}: {exc}")

        events = shape.events()
        for ev in [e for e in events if e["t"] <= 0.0]:
            _admit(ev["stream"])
        base_names = [s["stream"] for s in shape.specs() if s["phase"] == "base"]
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            with rx_lock:
                if all(n in first_rx for n in base_names):
                    break
            time.sleep(0.25)
        else:
            raise SystemExit(f"warmup: base streams never all delivered; see {where}")
        # The connect transient leaves the fast burn window: the supervisor
        # sees the ramp's slope, not the base warmup's.
        time.sleep(2.0 * capacity_fast_window_s)
        base_headroom = _min_headroom(urls)
        horizon = spawn_horizon_s
        if ref_spawn_headroom is not None and base_headroom is not None \
                and 0.0 < base_headroom < 1.0:
            horizon = (spawn_horizon_s * (base_headroom / ref_spawn_headroom)
                       * ((1.0 - ref_spawn_headroom) / (1.0 - base_headroom)))

        spawn_seq = itertools.count()

        def spawner():
            mname = f"a{next(spawn_seq)}"
            t0 = time.monotonic()
            url, grpc_port = _boot_member(mname, prewarm=False)
            _start_client(mname, grpc_port)
            # The manifest-driven prewarm block at ready.
            prewarm = None
            try:
                with urllib.request.urlopen(f"{url}/api/v1/stats", timeout=5) as r:
                    prewarm = _json.loads(r.read())["engine"]["prewarm"]
            except Exception:  # noqa: BLE001 -- the gate reads None
                pass
            spawn_info[mname] = {"t_spawn": t0, "boot_s": round(time.monotonic() - t0, 3),
                                 "prewarm": prewarm}
            return mname, url

        def retirer(mname: str) -> None:
            retire_info[mname] = {"t_retire": time.monotonic()}
            _send_exit(mname)

        sup = FleetSupervisor(
            router, spawner=spawner, retirer=retirer, min_members=2, max_members=3,
            decision_interval_s=decision_interval_s, spawn_horizon_s=horizon,
            surplus_headroom=surplus_headroom, surplus_hold_s=surplus_hold_s,
            spawn_cooldown_s=spawn_cooldown_s, retire_cooldown_s=retire_cooldown_s)
        sup.start()

        t0 = time.monotonic()
        for ev in [e for e in events if e["t"] > 0.0]:
            wait = t0 + ev["t"] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            if ev["op"] == "connect":
                _admit(ev["stream"])
            else:
                router.remove_stream(ev["stream"])

        # The retire leg: sustained surplus after the drain.
        deadline = time.monotonic() + surplus_hold_s + retire_cooldown_s + 60.0
        while time.monotonic() < deadline:
            if any(e["action"] == "retire" for e in list(sup.events)):
                break
            time.sleep(0.25)
        # Long enough after the retire for a flap to show.
        time.sleep(max(4.0, 3.0 * decision_interval_s))
        sup.stop()
        sup_snapshot = sup.snapshot()
        router.stop()

        stop.set()
        for t in threads:
            t.join(timeout=10)
        balance = router.ledger.balance()

        spawns = [e for e in sup.events if e["action"] == "spawn"]
        retires = [e for e in sup.events if e["action"] == "retire"]
        spawned = spawns[0]["member"] if spawns else None
        spawn_first_frame_s = None
        if spawned and spawned in spawn_info:
            with rx_lock:
                served = member_first_rx.get(spawned)
            if served is not None:
                spawn_first_frame_s = round(served - spawn_info[spawned]["t_spawn"], 3)
        spawn_prewarm = spawn_info.get(spawned, {}).get("prewarm") if spawned else None

        storm_names = [s["stream"] for s in shape.specs() if s["phase"] == "storm"]
        with rx_lock:
            storm_lat = sorted(round(first_rx[n] - t_admit[n], 3) for n in storm_names
                               if n in first_rx and n in t_admit)
        storm_p99 = (storm_lat[max(0, min(len(storm_lat) - 1,
                                          int(round(0.99 * (len(storm_lat) - 1)))))]
                     if storm_lat else None)

        for mname in list(procs_by_name):
            _send_exit(mname)
        exposition = obs_registry.render()
        lint_errors = lint_exposition(exposition)
        sup_families = sorted({line.split()[2] for line in exposition.splitlines()
                               if line.startswith("# TYPE vep_supervisor_")})

        gates = {
            "attach_clean": not attach_errors,
            "scale_out_on_forecast": bool(spawns) and spawns[0]["reason"] == "saturation_forecast",
            "scale_out_beats_burn": bool(spawns) and (spawns[0].get("min_headroom") or 0.0) > 0.0,
            "spawn_prewarm_from_manifest": bool(
                spawn_prewarm and spawn_prewarm.get("aot_cache")
                and spawn_prewarm.get("complete")
                and spawn_prewarm.get("required", 0) >= 1 + len(tenant_models)),
            "spawn_first_frame_within_scrape": (
                spawn_first_frame_s is not None
                and spawn_first_frame_s <= capacity_scrape_interval_s),
            "storm_admission_bounded": (len(storm_lat) == len(storm_names)
                                        and storm_p99 <= storm_admission_bound_s),
            "retire_on_surplus": bool(retires),
            "no_flap": len(spawns) == 1 and len(retires) == 1 and len(router.clients) == 2,
            "ledger_balanced": balance["balanced"],
            "no_admission_errors": not failures,
            "supervisor_metrics_lint_clean": not lint_errors and len(sup_families) >= 6,
        }
        return {
            "metric": (f"autoscale_{shape.base_streams}b{shape.ramp_streams}"
                       f"r{shape.storm_streams}s_{model}"),
            "pipeline": ("2 members + FleetSupervisor (subprocess spawner, shared prewarm "
                         "manifest) <- LoadShape ramp/storm/hot-spot/mixed-tenant churn <- "
                         "per-member gRPC clients -> conservation ledger"),
            "backend": backend,
            "model": model,
            "src_hw": [height, width],
            "shape": {"base": shape.base_streams, "ramp": shape.ramp_streams,
                      "storm": shape.storm_streams, "base_fps": shape.base_fps,
                      "hot_fps": shape.hot_fps, "models": list(shape.models),
                      "duration_s": shape.duration_s},
            "config": {
                "scrape_interval_s": scrape_interval_s,
                "capacity_scrape_interval_s": capacity_scrape_interval_s,
                "decision_interval_s": decision_interval_s,
                "spawn_horizon_s": spawn_horizon_s,
                "spawn_horizon_s_used": horizon,
                "ref_spawn_headroom": ref_spawn_headroom,
                "base_min_headroom": base_headroom,
                "surplus_headroom": surplus_headroom,
                "surplus_hold_s": surplus_hold_s,
                "capacity_fast_window_s": capacity_fast_window_s,
                "storm_admission_bound_s": storm_admission_bound_s,
                "bucket": bucket,
            },
            "gates": gates,
            "boots": {m: {k: v for k, v in b.items() if k != "t_popen"}
                      for m, b in boots.items()},
            "spawn": {
                "member": spawned,
                "event": spawns[0] if spawns else None,
                "boot_s": spawn_info.get(spawned, {}).get("boot_s") if spawned else None,
                "first_frame_s": spawn_first_frame_s,
                "prewarm": spawn_prewarm,
            },
            "storm": {"streams": len(storm_names), "admitted_first_frame_s": storm_lat,
                      "p99_s": storm_p99},
            "retire": {"member": retires[0]["member"] if retires else None,
                       "event": retires[0] if retires else None},
            "ledger": {"balanced": balance["balanced"], "lost": balance["lost"],
                       "duplicated": balance["duplicated"], "streams": balance["streams"]},
            "failures": failures,
            "lint_errors": lint_errors[:10],
            "supervisor_families": sup_families,
            "supervisor_snapshot": sup_snapshot,
            "admitted": admitted,
            "migrations": list(router.ledger.migrations),
            "member_runs": {
                m: {"boot_s": b["boot_s"], "boot_split_s": b["boot_split_s"],
                    "torch_threads": b["torch_threads"], "ready_counts": b["ready_counts"],
                    "first_frame_s": (round(member_first_rx[m] - b["t_popen"], 3)
                                      if m in member_first_rx else None),
                    "counts": counts.get(m)}
                for m, b in boots.items()},
        }
    finally:
        stop.set()
        if sup is not None:
            sup.stop()
        if router is not None:
            router.stop()
        for mname in list(procs_by_name):
            _send_exit(mname)
        for proc in procs_by_name.values():
            if proc.poll() is None:
                proc.kill()   # by PID through the Popen handle
                proc.wait(timeout=30)
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    _fleet_member_main()
