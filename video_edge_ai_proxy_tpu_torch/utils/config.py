"""Configuration: the subset of ``video_edge_ai_proxy_tpu/utils/config.py``
that the port's bus, ingest workers, engine and server read, with the same
defaults and the same YAML loading (``load_config``: explicit path, else
``$VEP_TPU_CONF``, else ``/data/chrysalis/conf.yaml``, else the defaults;
keys of sections the port lacks are ignored). ``yaml`` is imported only
when there is a file to read."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

DEFAULT_CONFIG_PATH = "/data/chrysalis/conf.yaml"


@dataclass
class BusConfig:
    """Frame-bus connection: the defaults of ``open_bus`` and of the ingest
    workers' environment contract."""

    backend: str = "shm"  # "shm" (native ring) | "redis" | "memory" (in-process, tests)
    # Directory holding the shared-memory segments (one ring per camera,
    # the control KV, the publish doorbell).
    shm_dir: str = "/dev/shm/vep_tpu"
    # The Redis connection of backend "redis" and of the workers'
    # environment contract.
    redis_addr: str = "127.0.0.1:6379"
    redis_password: str = ""
    redis_db: int = 0


@dataclass
class AnnotationConfig:
    """Annotation uplink batching (the reference's defaults)."""

    endpoint: str = "https://event.chryscloud.com/api/v1/annotate"
    unacked_limit: int = 1000
    poll_duration_ms: int = 300
    max_batch_size: int = 299
    # Dead-letter spool for batches that exhaust the uplink's retries:
    # "" = <data_dir>/annotation_spool.
    spool_dir: str = ""
    spool_max_bytes: int = 64 << 20


@dataclass
class ApiConfig:
    """Cloud REST endpoint (the Storage toggle's signed PUT)."""

    endpoint: str = "https://api.chryscloud.com"


@dataclass
class BufferConfig:
    """The disk buffer: ``on_disk`` turns on the archive clean-up cron."""

    on_disk: bool = False
    on_disk_folder: str = "/data/chrysalis/archive"
    on_disk_clean_older_than: str = "5m"
    on_disk_schedule: str = "@every 5m"


@dataclass
class RunnerConfig:
    """Worker isolation runner. The port runs ``subprocess`` workers
    (RLIMIT_AS and nice); the container runner and its settings are not
    ported."""

    kind: str = "subprocess"


@dataclass
class EngineConfig:
    model: str = "yolov8n"
    # Bucketed batch sizes: the serving step sees a small closed set of
    # batch shapes as streams come and go.
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32, 64)
    # Collector tick: stack whatever arrived, pad to bucket, go.
    tick_ms: int = 10
    # Seconds a stream keeps being inferred after the last consumer of its
    # results went away (the linger of interest gating); mirrors the
    # workers' 10 s decode gate.
    active_window_s: float = 10.0
    dtype: str = "bfloat16"
    # msgpack params checkpoint (tools/torch_import_weights.py writes one,
    # engine.save_checkpoint too); empty = random init. Loaded at warmup,
    # its metadata's conf_threshold is the default model's serving floor.
    checkpoint_path: str = ""
    # H2D prefetch stage: batches are placed on the device by a transfer
    # thread (a side CUDA stream on the card), double-buffered, so the copy
    # of batch t+1 overlaps the compute of batch t. False = the tick thread
    # places each batch itself, through the same placement.
    prefetch: bool = True
    # Programs to capture at start() instead of on a geometry's first
    # batch: [height, width, bucket], [height, width, bucket, model] or
    # [height, width, bucket, model, stem]. On the card each is one CUDA
    # graph of the serving step; a capture takes seconds, and prewarming
    # moves it out of the hot path.
    prewarm: list = field(default_factory=list)
    # Prewarm manifest (engine/aot_cache.py): every program this engine
    # (or another sharing aot_cache_dir) served is recorded there, and
    # start() prewarms the recorded set too. "" with aot_cache=True is
    # off, as in the JAX package, where the server resolves the dir.
    aot_cache: bool = False
    aot_cache_dir: str = ""
    # health() flags the tick loop wedged when no tick completed this long.
    health_stale_after_s: float = 300.0
    # Per-stream SORT-style tracker filling Detection.track_id.
    track: bool = True
    # Per-frame stage timestamps (publish -> collect -> submit -> drain ->
    # emit) appended to engine.stage_records, bounded. Off in production.
    stage_trace: bool = False
    # End-to-end latency (capture -> result emit) above this increments
    # vep_frames_late_total for the stream.
    obs_late_ms: float = 1000.0
    # "int8": weight-only int8 serving (models/quantize.py): the device
    # holds int8 weights and per-channel scales, dequantized inside the
    # step. "int8_act" (detect family): that, plus int8 x int8 convs in
    # every ConvBN but the stem against input ranges calibrated at warmup
    # on synthetic frames. "" = full precision.
    quantize: str = ""
    # Detect-family stem: "classic" (stride-2 3x3) or "s2d" (the fused
    # letterbox + space-to-depth preprocess and a stride-1 2x2 stem;
    # classic weights fold in losslessly). Every program is keyed by it.
    stem: str = "classic"
    # Dense bf16 peak TFLOP/s of the card for the live MFU gauges
    # (obs/perf.py). 0 = resolve from the card's name at warmup; an
    # unknown card then raises. On the CPU there is no MFU.
    peak_tflops: float = 0.0
    # Overload degradation ladder: normal -> shed stale frames -> cap the
    # batch bucket one size down -> pause admission for half the streams.
    # Driven by drain-queue depth, tick lag and SLO burn; escalates after
    # ladder_escalate_after_s of continuous pressure, recovers one rung per
    # ladder_recover_after_s without.
    ladder: bool = True
    ladder_escalate_after_s: float = 0.5
    ladder_recover_after_s: float = 2.0
    # Rung shed: frames older than this at dispatch are dropped.
    shed_staleness_ms: float = 500.0
    # Capacity attribution plane (obs/capacity.py): each measured batch's
    # device time attributed to its occupant streams (full slots equally,
    # ROI canvases by packed area, the cascade head amortized over its
    # cadence), utilization rings per (model, geometry, bucket), the
    # time_to_saturation_s forecast and fast/slow burn rates; the headroom
    # signal the fleet merges and StreamRouter.admit consults.
    # capacity=False (default): no tap in the emit path, /api/v1/capacity
    # answers 400.
    capacity: bool = False
    capacity_fast_window_s: float = 60.0     # fast burn window
    capacity_slow_window_s: float = 1800.0   # slow burn window (30 m)
    # Sustainable utilization: burn = utilization over this; burning when
    # both windows exceed 1.0.
    capacity_util_objective: float = 0.8
    capacity_eval_interval_s: float = 1.0    # forecast refresh throttle
    # Device-memory plane (obs/hbm.py): program footprints, live pool
    # ledgers (thumbs, track_state, prefetch, collector_host) and a time-
    # to-OOM forecast against the budget that feeds the ladder. hbm=False
    # (default): no tracker, /api/v1/hbm answers 400. hbm_budget_bytes 0 =
    # the card's total memory (torch.cuda.mem_get_info), the synthetic
    # 4 GiB on the CPU.
    hbm: bool = False
    hbm_budget_bytes: int = 0
    hbm_fast_window_s: float = 60.0          # fast high-water window
    hbm_slow_window_s: float = 1800.0        # slow high-water window
    hbm_util_objective: float = 0.9          # burn = window-peak use over this
    hbm_eval_interval_s: float = 1.0         # forecast refresh throttle
    hbm_pressure_horizon_s: float = 120.0    # OOM forecast inside this: pressure
    # Live SLOs: p50 detect latency, aggregate frames/s, stream
    # availability, as multi-window burn rates. No SLO fires before
    # slo_warmup_s of wall time; slo_ladder feeds a sustained burn into the
    # ladder as pressure.
    slo: bool = True
    slo_latency_ms: float = 40.0
    slo_target_fps: float = 1000.0
    slo_warmup_s: float = 60.0
    slo_availability_window_s: float = 5.0
    slo_eval_interval_s: float = 1.0
    slo_ladder: bool = True
    # Triggered device profiling (obs/prof.py): duration-bounded
    # torch.profiler captures on demand (/api/v1/profile?ms=N, the gRPC
    # admin mirror) and, with prof_trigger, once per SLO episode or ladder
    # escalation, written as bundles (device trace, the overlapping spans
    # and journal events, an engine snapshot) into a byte-bounded ring.
    # prof=False disables it; the REST endpoint answers 400.
    prof: bool = True
    prof_dir: str = ""                 # "" = <tempdir>/vep_prof (the server
                                       # uses <data_dir>/prof)
    # Triggered capture is opt-in: the server forks camera workers
    # (restarts), and a trace must not overlap a fork (the JAX profiler
    # segfaulted when one did). Arm it where the engine runs fork-free.
    prof_trigger: bool = False         # capture on burn/escalation
    prof_trigger_ms: int = 500         # duration of triggered captures
    prof_trigger_min_interval_s: float = 60.0  # rate limit between them
    prof_retention_bytes: int = 256 << 20      # ring bound, oldest evicted
    prof_max_ms: int = 10_000          # cap on ?ms= (400 above this)
    # Output-quality verdicts from the device frame statistics and the
    # detections; quality_ladder sheds black/frozen streams first.
    quality: bool = True
    # Luma thumbnail side of the per-frame quality statistics (device
    # state carried per stream across ticks); 0 = off.
    quality_thumb: int = 32
    quality_black_luma: float = 0.04   # black: thumb luma mean below this
    quality_black_var: float = 5e-4    #   ... and luma variance below this
    quality_freeze_diff: float = 1e-6  # frozen: inter-frame MSE below this
    quality_enter_s: float = 2.0       # a condition must hold this long
    quality_exit_s: float = 2.0        # the all-clear must hold this long
    quality_flatline_s: float = 10.0   # zero detections for this long
    quality_window_s: float = 5.0      # drift scoring window
    quality_drift_threshold: float = 0.35
    quality_ladder: bool = True
    # ROI serving: each tick, detect streams are motion-gated from the
    # previous tick's thumbnail diff energy (the quality statistics) and
    # their tracker: "idle" streams (no motion) skip device work and emit
    # tracker-coasted results; "roi" streams (motion, live tracks) send
    # crops around their predicted track boxes, shelf-packed with other
    # streams' crops onto a few shared roi_canvas-square canvases
    # (engine/collector.py CanvasPacker), one more program of the step
    # cache; "full" streams (refresh due, no diff signal yet, or motion
    # with nothing tracked) run the classic full frame. Detections scatter
    # back through each crop's exact inverse (ops/boxes.py uncrop_boxes).
    # roi=False (default) is the kill switch: the classic path unchanged.
    roi: bool = False
    roi_canvas: int = 640              # shared canvas side (geometry)
    roi_gap: int = 8                   # background px between packed crops
    roi_max_canvases: int = 8          # per tick; overflow crops go full
    roi_margin: float = 0.25           # track-box inflation for crops
    roi_min_crop: int = 32             # minimum crop side before packing
    # Diff energy (inter-frame MSE of [0, 1] luma thumbnails) below this is
    # motionless: "no scene change worth a full frame".
    roi_idle_diff: float = 5e-5
    # Full-frame refresh cadence per stream: catches objects outside every
    # tracked ROI and refreshes the diff signal (only full frames carry
    # quality statistics).
    roi_full_interval_ms: int = 1000
    # A coasted detection's confidence decays by this per missed frame; below
    # roi_coast_floor it is not emitted (the track still expires through
    # IoUTracker.max_misses).
    roi_coast_decay: float = 0.9
    roi_coast_floor: float = 0.1
    # Canary integrity loop: a golden trace (replay/recorder.py) replayed
    # into the live engine at low cadence by an engine-owned publisher;
    # each completed loop's host result checksums fold and compare against
    # the golden (0 = adopt the first complete cycle), feeding the
    # canary_integrity SLO and watchdog. "" = no canary.
    quality_canary: str = ""           # trace path ("" = off)
    quality_canary_stream: str = "_canary"
    quality_canary_fps: float = 2.0
    quality_canary_golden: int = 0     # committed fold; 0 = record-only
    # The temporal cascade (temporal/): the detect step runs every tick
    # unchanged; tracked detections' crops accumulate in a device-resident
    # clip ring per track, and the temporal head (cascade_model and a
    # logistic anomaly score over pooled clip features) runs every
    # cascade_every_n ticks as its own program. Needs track=True.
    # cascade=False (default) is the kill switch: no scheduler, no pool.
    cascade: bool = False
    cascade_every_n: int = 4           # temporal-head cadence (ticks)
    cascade_model: str = "videomae_b"  # registry video model of the head
    cascade_crop: int = 0              # track tile side; 0 = model input
    cascade_clip_len: int = 0          # ring depth; 0 = model clip_len
    # Event hysteresis (temporal/events.py): score >= threshold on enter_n
    # consecutive head passes fires "enter"; below it on exit_n, "exit".
    cascade_threshold: float = 0.5
    cascade_enter_n: int = 2
    cascade_exit_n: int = 2
    # score = sigmoid(w . f + b) over [temporal diff energy, clip luma
    # variance, max head softmax probability]; a pixel-static clip scores
    # sigmoid(b) ~ 0.018. The logits ride the event payload.
    cascade_score_w: tuple = (2000.0, 0.0, 0.0)
    cascade_score_b: float = -4.0
    # Ticks without a harvested detection before a track's slot frees.
    cascade_track_ttl_ticks: int = 60
    # Annotation emit policy of the engine's uplink: "all" (every
    # detection of every frame), "keyframe" (GOP heads only), "on_change"
    # (the tracked object set changed, or a confidence moved more than
    # annotation_confidence_delta), "min_interval" (at most one frame's
    # annotations per annotation_min_interval_ms). Per-stream override:
    # StreamProcess.annotation_policy.
    annotation_emit: str = "on_change"
    annotation_min_interval_ms: int = 1000
    annotation_confidence_delta: float = 0.15
    # Control-plane decision journal (obs/journal.py): a bounded ring of
    # causally linked events from the ladder, the SLOs, the shed excursion
    # and the watchdog, served at /api/v1/journal and /api/v1/why. On by
    # default (recording is off the per-frame path); journal=False leaves
    # no hook anywhere and /api/v1/journal answers 400.
    journal: bool = True
    journal_capacity: int = 4096       # ring slots (events retained)
    # The cascade's cadence under pressure: while the ladder is off
    # "normal" the head runs every cascade_every_n * this ticks (1 = off).
    cascade_stretch_factor: int = 2


@dataclass
class ObsConfig:
    """Frame-lineage tracing (obs/spans.py). Metrics are always on; tracing
    is opt-in because span dicts allocate."""

    trace: bool = False       # record sampled per-frame lineage spans
    sample_every: int = 16    # trace 1 in N frames (by packet id, so spans
                              # join into lineages)
    trace_ring: int = 1024    # span events buffered per stream
    # Fleet telemetry (obs/fleet.py). instance: this member's identity, a
    # constant label on every /metrics sample when set. fleet_members:
    # "name=http://host:port" specs; when set this process also runs a
    # FleetAggregator and serves /api/v1/fleet/*.
    instance: str = ""
    fleet_members: tuple = ()
    fleet_scrape_s: float = 2.0
    fleet_stale_s: float = 0.0   # 0 -> one scrape interval


@dataclass
class RouterConfig:
    """Fleet router (serve/router.py): consistent-hash stream placement
    across engine members and burn-driven live migration. Read by the
    router process (``python -m video_edge_ai_proxy_tpu_torch.serve.router``)
    and by a server whose supervisor is on."""

    members: tuple = ()             # "name=http://host:port" specs
    port: int = 9091                # router admin plane (/metrics, stats)
    scrape_interval_s: float = 1.0  # health poll + decision-pass cadence
    vnodes: int = 64                # virtual nodes per member at weight 1
    max_moves_per_pass: int = 2     # graceful migrations per pass
    min_healthy_age_s: float = 0.0  # a new healthy member waits this long
    drain_timeout_s: float = 8.0    # max wait for the source to flush
    ema_alpha: float = 0.4          # health-score smoothing
    healthy_above: float = 0.7      # hysteresis band: healthy at/above
    unhealthy_below: float = 0.4    # ... unhealthy at/below; hold between


@dataclass
class SupervisorConfig:
    """Autoscaling supervisor (serve/supervisor.py): spawns a member when
    the fleet's time_to_saturation_s forecast falls inside the horizon,
    retires the emptiest after a sustained headroom surplus, within
    min/max bounds and cooldowns. enabled=True in a server runs it
    advisory over ``router.members`` (decisions in /api/v1/supervisor and
    vep_supervisor_*); enabled=False: /api/v1/supervisor answers 400."""

    enabled: bool = False
    min_members: int = 1
    max_members: int = 4
    decision_interval_s: float = 2.0
    spawn_horizon_s: float = 120.0
    surplus_headroom: float = 0.6
    surplus_hold_s: float = 30.0
    spawn_cooldown_s: float = 10.0
    retire_cooldown_s: float = 30.0


@dataclass
class Config:
    port: int = 8080
    grpc_port: int = 50001
    # Worker re-adoption across server restarts: workers log to
    # <data_dir>/worker_logs, survive the server, and resume() re-adopts
    # them; False: workers pipe to the server, die with it, resume =
    # respawn.
    worker_adoption: bool = True
    bus: BusConfig = field(default_factory=BusConfig)
    runner: RunnerConfig = field(default_factory=RunnerConfig)
    annotation: AnnotationConfig = field(default_factory=AnnotationConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    buffer: BufferConfig = field(default_factory=BufferConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    router: RouterConfig = field(default_factory=RouterConfig)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)


def _merge(dc: Any, data: dict) -> Any:
    """Overlay a dict onto a dataclass, recursing into nested dataclasses;
    keys that name no field are ignored."""
    kwargs: dict = {}
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        cur = getattr(dc, f.name)
        val = data[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kwargs[f.name] = _merge(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, list):
            kwargs[f.name] = tuple(val)
        else:
            kwargs[f.name] = val
    return dataclasses.replace(dc, **kwargs)


def load_config(path: Optional[str] = None) -> Config:
    """Explicit path > $VEP_TPU_CONF > the default path > the defaults. A
    missing file is not an error."""
    cfg = Config()
    candidate = path or os.environ.get("VEP_TPU_CONF") or DEFAULT_CONFIG_PATH
    if candidate and os.path.isfile(candidate):
        import yaml

        with open(candidate, "r", encoding="utf-8") as fh:
            data = yaml.safe_load(fh) or {}
        if not isinstance(data, dict):
            raise ValueError(f"config root must be a mapping: {candidate}")
        cfg = _merge(cfg, data)
    return cfg
