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

    backend: str = "shm"  # "shm" (native ring) | "memory" (in-process, tests)
    # Directory holding the shared-memory segments (one ring per camera,
    # the control KV, the publish doorbell).
    shm_dir: str = "/dev/shm/vep_tpu"
    # The Redis connection of the workers' environment contract (the
    # port's buses are shm and memory; the redis bus is not ported).
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
    # Canary integrity loop: a golden trace (replay/recorder.py) replayed
    # into the live engine at low cadence by an engine-owned publisher;
    # each completed loop's host result checksums fold and compare against
    # the golden (0 = adopt the first complete cycle), feeding the
    # canary_integrity SLO and watchdog. "" = no canary.
    quality_canary: str = ""           # trace path ("" = off)
    quality_canary_stream: str = "_canary"
    quality_canary_fps: float = 2.0
    quality_canary_golden: int = 0     # committed fold; 0 = record-only
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


@dataclass
class ObsConfig:
    """Frame-lineage tracing (obs/spans.py). Metrics are always on; tracing
    is opt-in because span dicts allocate."""

    trace: bool = False       # record sampled per-frame lineage spans
    sample_every: int = 16    # trace 1 in N frames (by packet id, so spans
                              # join into lineages)
    trace_ring: int = 1024    # span events buffered per stream


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
