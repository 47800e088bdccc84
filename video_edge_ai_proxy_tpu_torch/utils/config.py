"""Configuration: the subsets of ``video_edge_ai_proxy_tpu/utils/config.py``
``BusConfig`` and ``EngineConfig`` that the port's bus, ingest workers and
serving engine read, with the same defaults."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BusConfig:
    """Frame-bus connection: the defaults of ``open_bus`` and of the ingest
    workers' environment contract."""

    backend: str = "shm"  # "shm" (native ring) | "memory" (in-process, tests)
    # Directory holding the shared-memory segments (one ring per camera,
    # the control KV, the publish doorbell).
    shm_dir: str = "/dev/shm/vep_tpu"


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
