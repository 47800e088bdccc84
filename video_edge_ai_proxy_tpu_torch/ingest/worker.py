"""Per-camera ingest worker (counterpart of ``video_edge_ai_proxy_tpu/ingest/worker.py``).

One OS process per camera:

    python -m video_edge_ai_proxy_tpu_torch.ingest.worker

configured by the reference's environment contract (``rtsp_endpoint``,
``device_id``, ``in_memory_buffer``, ``vep_shm_dir``, ``vep_bus_backend``,
...; ``WorkerConfig.from_env``) or the matching flags. The worker opens
its source, creates the camera's ring on the bus (``slots =
max(2, in_memory_buffer + 1)``) and loops: grab a packet (cheap), decode
it only when the gate says so, publish the frame with its ``FrameMeta``,
and write a status heartbeat into the bus KV once a second.

Decode gate (the reference's lazy decode):
- keyframes always decode;
- the frames between keyframes decode only while someone touched the
  stream's ``last_query`` key within ``active_window_s`` (10 s): a client,
  or the engine, which touches exactly the streams it infers
  (``Collector.keep_streams_hot``);
- keyframe-only mode (the per-device KV flag) restricts decoding to
  keyframes.

Failure semantics: a failed first connect exits with code 2 (a supervisor
restarts the worker); an end of stream mid-run re-opens the source every
second, forever (``max_frames`` bounds a run for tests). SIGTERM and
SIGINT stop the loop and the process exits 0.

The worker imports no ``torch`` unless its flight recorder is on
(``trace_dir``) or it plays a trace (``replay://``), and never touches a
GPU. The archive (``disk_buffer_path``) and the RTMP pass-through
(``rtmp_endpoint``) need the libav shim and are a later slice: a non-empty
value raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..bus import FrameBus, FrameMeta, RingSlotTooSmall, open_bus
from ..obs import registry as obs_registry, trace_id_for, tracer
from ..utils.config import BusConfig
from .sources import VideoSource, open_source

log = logging.getLogger("vep.torch.ingest.worker")

# Heartbeats older than this are stale: a crashed worker must not report
# healthy off its last write.
STATUS_FRESH_MS = 5000


def parse_fresh_status(raw, now_ms: int) -> dict:
    """Worker heartbeat JSON -> dict if it parses to an object and is
    fresh, else {}."""
    if not raw:
        return {}
    try:
        hb = json.loads(raw)
    except ValueError:
        return {}
    if not isinstance(hb, dict):
        return {}
    return hb if now_ms - hb.get("ts_ms", 0) < STATUS_FRESH_MS else {}


KEY_STATUS_PREFIX = "stream_status_"   # the worker's heartbeat key
RECONNECT_DELAY_S = 1.0
STATUS_INTERVAL_S = 1.0


@dataclass
class WorkerConfig:
    rtsp_endpoint: str
    device_id: str
    rtmp_endpoint: str = ""
    in_memory_buffer: int = 1
    disk_buffer_path: str = ""
    active_window_s: float = 10.0
    shm_dir: str = BusConfig.shm_dir
    bus_backend: str = BusConfig.backend
    redis_addr: str = "127.0.0.1:6379"
    redis_password: str = ""
    redis_db: int = 0
    max_frames: int = 0  # 0 = endless; tests set a bound
    # Flight recorder (replay/recorder.py): non-empty = write
    # <trace_dir>/<device_id>.vtrace with every published frame (the
    # pattern seed for synthetic sources) for replay through replay://.
    trace_dir: str = ""

    @classmethod
    def from_env(cls) -> "WorkerConfig":
        """The environment contract a supervisor starts a worker with (the
        reference's process manager sets the same variables)."""
        env = os.environ
        return cls(
            rtsp_endpoint=env.get("rtsp_endpoint", ""),
            device_id=env.get("device_id", ""),
            rtmp_endpoint=env.get("rtmp_endpoint", ""),
            in_memory_buffer=int(env.get("in_memory_buffer", "1") or 1),
            disk_buffer_path=env.get("disk_buffer_path", ""),
            shm_dir=env.get("vep_shm_dir", BusConfig.shm_dir),
            bus_backend=env.get("vep_bus_backend", BusConfig.backend),
            redis_addr=env.get("vep_redis_addr", "127.0.0.1:6379"),
            redis_password=env.get("vep_redis_password", ""),
            redis_db=int(env.get("vep_redis_db", "0") or 0),
            max_frames=int(env.get("vep_max_frames", "0") or 0),
            trace_dir=env.get("vep_trace_dir", ""),
        )


class IngestWorker:
    def __init__(self, cfg: WorkerConfig, bus: Optional[FrameBus] = None,
                 source: Optional[VideoSource] = None):
        for name in ("disk_buffer_path", "rtmp_endpoint"):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r}: the archive and the RTMP pass-through "
                    "need the libav shim, which comes in a later slice")
        self.cfg = cfg
        self._owns_bus = bus is None
        self.bus = bus or open_bus(cfg.bus_backend, cfg.shm_dir, cfg.redis_addr,
                                   cfg.redis_password, cfg.redis_db)
        try:
            self.source = source or open_source(cfg.rtsp_endpoint)
        except Exception:
            if self._owns_bus:
                self.bus.close()
            raise
        self._stop = threading.Event()
        self._packets = 0
        self._keyframes = 0
        self._decoded = 0
        self._published = 0
        self._last_status = 0.0
        self._fps_window: list = []
        self._recorder = None  # flight recorder (cfg.trace_dir), built in run()
        dev = (cfg.device_id,)
        self._m_packets = obs_registry.counter(
            "vep_ingest_packets_total", "Video packets demuxed", ("stream",)).labels(*dev)
        self._m_decoded = obs_registry.counter(
            "vep_ingest_decoded_total", "Frames decoded", ("stream",)).labels(*dev)
        self._m_published = obs_registry.counter(
            "vep_ingest_published_total", "Frames published to the bus",
            ("stream",)).labels(*dev)
        self._m_corrupt = obs_registry.counter(
            "vep_ingest_corrupt_total", "Corrupt packets flagged by demux",
            ("stream",)).labels(*dev)
        self._m_reconnects = obs_registry.counter(
            "vep_ingest_reconnects_total", "Mid-stream EOF reconnect loops",
            ("stream",)).labels(*dev)
        # A worker process inherits the tracing intent through the
        # environment (the server's tracer does not cross the exec).
        if os.environ.get("VEP_OBS_TRACE"):
            tracer.configure(enabled=True,
                             sample_every=int(os.environ.get("VEP_OBS_SAMPLE_EVERY") or 16))

    # -- control-plane reads (per packet; a KV load on the shm bus) --

    def _client_active(self, now_ms: int) -> bool:
        last = self.bus.last_query_ms(self.cfg.device_id)
        return last is not None and (now_ms - last) < self.cfg.active_window_s * 1000

    def _should_decode(self, is_keyframe: bool, now_ms: int) -> bool:
        if is_keyframe:
            return True
        if self.bus.keyframe_only(self.cfg.device_id):
            return False
        return self._client_active(now_ms)

    # -- status heartbeat --

    def _publish_status(self, now: float, error: str = "", force: bool = False) -> None:
        if now - self._last_status < STATUS_INTERVAL_S and not (error or force):
            return
        self._last_status = now
        window = [t for t in self._fps_window if now - t < 5.0]
        self._fps_window = window
        status = {
            "pid": os.getpid(),
            "running": not self._stop.is_set(),
            "packets": self._packets,
            "audio_packets": 0,       # the port's sources carry no audio
            "keyframes": self._keyframes,
            "decoded": self._decoded,
            "published": self._published,
            "fps": round(len(window) / 5.0, 2),
            "width": self.source.width,
            "height": self.source.height,
            "source": getattr(self.source, "kind", ""),
            "error": error,
            "ts_ms": int(time.time() * 1000),  # epoch: readers check staleness
        }
        self.bus.kv_set(KEY_STATUS_PREFIX + self.cfg.device_id,
                        json.dumps(status, separators=(",", ":")))

    # -- main loop --

    def _open_recorder(self) -> None:
        from ..replay.recorder import TraceRecorder

        cfg = self.cfg
        os.makedirs(cfg.trace_dir, exist_ok=True)
        self._recorder = TraceRecorder(os.path.join(cfg.trace_dir, f"{cfg.device_id}.vtrace"))
        self._recorder.record_stream(
            cfg.device_id, width=self.source.width, height=self.source.height,
            fps=self.source.fps, gop=getattr(self.source, "gop", 0),
            kind=getattr(self.source, "kind", ""))

    def _reconnect(self) -> bool:
        """Mid-stream end: close, wait RECONNECT_DELAY_S, re-open (a failed
        re-open is retried on the next end). False when stopped meanwhile."""
        log.warning("stream %s EOF/gone; reconnecting in %.0fs", self.cfg.device_id,
                    RECONNECT_DELAY_S)
        self._m_reconnects.inc()
        self.source.close()
        if self._stop.wait(RECONNECT_DELAY_S):
            return False
        try:
            self.source.open()
        except ConnectionError:
            pass
        return True

    def _publish(self, frame, pkt) -> None:
        cfg = self.cfg
        meta = FrameMeta(
            width=frame.shape[1],
            height=frame.shape[0],
            channels=frame.shape[2] if frame.ndim == 3 else 1,
            timestamp_ms=pkt.timestamp_ms,
            # A source that supplied no pts/dts ships 0.
            pts=pkt.pts if pkt.pts is not None else 0,
            dts=pkt.dts if pkt.dts is not None else 0,
            packet=pkt.packet,
            keyframe_cnt=self._keyframes,
            is_keyframe=pkt.is_keyframe,
            is_corrupt=pkt.is_corrupt,
            frame_type="I" if pkt.is_keyframe else "P",
            time_base=pkt.time_base,
            # Deterministic lineage id, stamped once here.
            trace_id=trace_id_for(cfg.device_id, pkt.packet),
        )
        slots = max(2, cfg.in_memory_buffer + 1)
        try:
            self.bus.publish(cfg.device_id, frame, meta)
        except RingSlotTooSmall:
            # The source under-reported its geometry at open, or the camera
            # switched to a larger mode: the worker owns the ring, so it
            # grows it in place rather than die into a restart loop.
            log.warning("ring slot too small for %s (%d B); recreating", cfg.device_id,
                        frame.nbytes)
            self.bus.create_stream(cfg.device_id, frame.nbytes, slots=slots)
            self.bus.publish(cfg.device_id, frame, meta)
        self._published += 1
        self._m_published.inc()
        if tracer.sampled(meta.packet):
            # The lineage's origin: the frame id (the packet number) is
            # stamped here and flows unchanged to the result.
            tracer.record(cfg.device_id, "publish", meta.packet, trace_id=meta.trace_id)
        if self._recorder is not None:
            # Synthetic frames are a function of (w, h, n): the trace keeps
            # the seed, not the pixels.
            synth = None
            if getattr(self.source, "kind", "") == "synthetic":
                synth = {"w": frame.shape[1], "h": frame.shape[0], "n": pkt.packet}
            self._recorder.record_frame(cfg.device_id, frame, meta, synth=synth)
        self._fps_window.append(time.monotonic())

    def run(self) -> None:
        cfg = self.cfg
        try:
            self.source.open()
        except ConnectionError as exc:
            # Exit hard: the supervisor's restart policy takes over.
            log.error("initial connect failed for %s: %s", cfg.device_id, exc)
            self._publish_status(time.monotonic(), error=str(exc))
            raise SystemExit(2)
        frame_bytes = max(self.source.width * self.source.height * 3, 1920 * 1080 * 3)
        self.bus.create_stream(cfg.device_id, frame_bytes,
                               slots=max(2, cfg.in_memory_buffer + 1))
        if cfg.trace_dir:
            self._open_recorder()
        log.info("ingest worker up: device=%s source=%s %dx%d@%.1ffps", cfg.device_id,
                 cfg.rtsp_endpoint, self.source.width, self.source.height, self.source.fps)
        try:
            while not self._stop.is_set():
                pkt = self.source.grab()
                if pkt is None:
                    if cfg.max_frames and self._packets >= cfg.max_frames:
                        break
                    if not self._reconnect():
                        break
                    continue
                self._packets += 1
                self._m_packets.inc()
                if pkt.is_corrupt:
                    self._m_corrupt.inc()
                if pkt.is_keyframe:
                    self._keyframes += 1
                if self._should_decode(pkt.is_keyframe, pkt.timestamp_ms):
                    frame = self.source.retrieve()
                    if frame is None:
                        continue
                    self._decoded += 1
                    self._m_decoded.inc()
                    self._publish(frame, pkt)
                self._publish_status(time.monotonic())
                if cfg.max_frames and self._packets >= cfg.max_frames:
                    break
        finally:
            # Every teardown step runs even when an earlier one raises.
            def _safe(what, fn):
                try:
                    fn()
                except Exception:
                    log.exception("worker teardown: %s failed", what)

            _safe("status", lambda: self._publish_status(time.monotonic(), force=True))
            if self._recorder is not None:
                _safe("trace recorder", self._recorder.close)
            _safe("source", self.source.close)
            log.info("ingest worker down: device=%s packets=%d decoded=%d", cfg.device_id,
                     self._packets, self._decoded)
            if self._owns_bus:
                _safe("bus", self.bus.close)

    def stop(self) -> None:
        self._stop.set()


def main(argv: Optional[list] = None) -> None:
    """Command line: every flag falls back to the environment contract."""
    env_cfg = WorkerConfig.from_env()
    p = argparse.ArgumentParser(description="per-camera ingest worker")
    p.add_argument("--rtsp", default=env_cfg.rtsp_endpoint)
    p.add_argument("--device_id", default=env_cfg.device_id)
    p.add_argument("--rtmp", default=env_cfg.rtmp_endpoint)
    p.add_argument("--memory_buffer", type=int, default=env_cfg.in_memory_buffer)
    p.add_argument("--disk_buffer_path", default=env_cfg.disk_buffer_path)
    p.add_argument("--shm_dir", default=env_cfg.shm_dir)
    p.add_argument("--bus_backend", default=env_cfg.bus_backend)
    p.add_argument("--redis_addr", default=env_cfg.redis_addr)
    # No --redis_password: argv is world-readable through /proc; the
    # credential travels only through the environment.
    p.add_argument("--redis_db", type=int, default=env_cfg.redis_db)
    p.add_argument("--max_frames", type=int, default=env_cfg.max_frames)
    p.add_argument("--trace_dir", default=env_cfg.trace_dir,
                   help="flight-recorder output dir (replay/)")
    args = p.parse_args(argv)
    if not args.rtsp or not args.device_id:
        p.error("--rtsp and --device_id are required (or the environment contract)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg = WorkerConfig(
        rtsp_endpoint=args.rtsp,
        device_id=args.device_id,
        rtmp_endpoint=args.rtmp,
        in_memory_buffer=args.memory_buffer,
        disk_buffer_path=args.disk_buffer_path,
        shm_dir=args.shm_dir,
        bus_backend=args.bus_backend,
        redis_addr=args.redis_addr,
        redis_password=env_cfg.redis_password,
        redis_db=args.redis_db,
        max_frames=args.max_frames,
        trace_dir=args.trace_dir,
    )
    worker = IngestWorker(cfg)

    import signal

    def _sig(_s, _f):
        worker.stop()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    worker.run()


if __name__ == "__main__":
    main()
