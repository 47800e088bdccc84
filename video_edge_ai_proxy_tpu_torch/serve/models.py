"""Server-side records (reference ``server/models/StreamProcess.go``,
``Settings.go``). JSON field names match the reference so portal/REST clients
written against it keep working."""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

PREFIX_RTSP_PROCESS = "/rtspprocess/"   # StreamProcess.go:23-25
PREFIX_SETTINGS = "/settings/"
SETTINGS_DEFAULT_KEY = "default"


@dataclass
class RTMPStreamStatus:
    streaming: bool = False
    storing: bool = False


@dataclass
class ProcessState:
    """Worker process state; shape mirrors the Docker ContainerState the
    reference embeds (``StreamProcess.go:33``) with subprocess semantics."""

    status: str = ""          # running | exited | restarting | created
    running: bool = False
    pid: int = 0
    exit_code: int = 0
    error: str = ""
    oom_killed: bool = False
    dead: bool = False
    restarting: bool = False
    failing_streak: int = 0


@dataclass
class StreamProcess:
    name: str = ""
    image_tag: str = ""                 # kept for API parity; unused by the
                                        # subprocess runner (Docker is an ops
                                        # choice, not core — SURVEY.md §7)
    rtsp_endpoint: str = ""
    rtmp_endpoint: str = ""
    container_id: str = ""              # subprocess: "<pid>@<hostname>"
    status: str = ""
    state: Optional[ProcessState] = None
    logs: Optional[dict] = None         # {"stdout": [...], "stderr": [...]}
    created: int = 0                    # epoch ms
    modified: int = 0
    rtmp_stream_status: Optional[RTMPStreamStatus] = None
    # New (no reference counterpart): per-stream inference toggle + model.
    # Registry model name, "" = engine default, "none" = inference off for
    # this stream (it drops out of the device batch and its decode gate
    # closes — SURVEY §2.3 P6).
    inference_model: str = ""
    # Per-stream annotation emit policy override:
    # all | keyframe | on_change | min_interval ("" = engine default,
    # EngineConfig.annotation_emit).
    annotation_policy: str = ""
    # Resource limits applied to the worker process (reference caps
    # containers via CPUShares + json-file log limits,
    # ``rtsp_process_manager.go:71-78``); filled by Info, not persisted.
    limits: Optional[dict] = None
    # Media path the worker heartbeat reports: packet | opencv (degraded
    # fallback with fabricated keyframes/pts) | synthetic; filled by
    # Info from the live heartbeat, not persisted.
    source: str = ""
    # Full parsed fresh heartbeat (Info fills it; {} = stale/absent) so
    # consumers (ListStreams health) don't re-fetch the bus key per
    # record. Transient: _persist round-trips every write through
    # from_json (process_manager.py::_persist), which ignores this
    # field, so it never reaches storage even when an info()-derived
    # record is passed to update_record.
    heartbeat: Optional[dict] = None
    # PERSISTED live-worker descriptor for re-adoption across server
    # restarts (reference re-attaches to still-running containers on boot,
    # ``rtsp_process_manager.go:191-233``): {"pid", "starttime" (the
    # /proc/<pid>/stat birth tick — guards against pid reuse), "log_path"}.
    # Filled by the spawn path when adoption is enabled; None otherwise.
    runtime: Optional[dict] = None

    def to_json(self) -> bytes:
        def drop_none(obj: Any) -> Any:
            if isinstance(obj, dict):
                return {k: drop_none(v) for k, v in obj.items() if v is not None}
            return obj

        return json.dumps(drop_none(asdict(self)), separators=(",", ":")).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "StreamProcess":
        data = json.loads(raw)
        state = data.get("state")
        rss = data.get("rtmp_stream_status")
        return cls(
            name=data.get("name", ""),
            image_tag=data.get("image_tag", ""),
            rtsp_endpoint=data.get("rtsp_endpoint", ""),
            rtmp_endpoint=data.get("rtmp_endpoint", ""),
            container_id=data.get("container_id", ""),
            status=data.get("status", ""),
            state=ProcessState(**state) if state else None,
            logs=data.get("logs"),
            created=data.get("created", 0),
            modified=data.get("modified", 0),
            rtmp_stream_status=RTMPStreamStatus(**rss) if rss else None,
            inference_model=data.get("inference_model", ""),
            annotation_policy=data.get("annotation_policy", ""),
            limits=data.get("limits"),
            runtime=data.get("runtime"),
        )

    @staticmethod
    def now_ms() -> int:
        return int(time.time() * 1000)


@dataclass
class Settings:
    """Edge credentials (reference ``Settings.go:23-29``)."""

    name: str = SETTINGS_DEFAULT_KEY
    edge_key: str = ""
    edge_secret: str = ""
    created: int = 0
    modified: int = 0

    def to_json(self) -> bytes:
        return json.dumps(asdict(self), separators=(",", ":")).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Settings":
        data = json.loads(raw)
        return cls(**{k: data.get(k, "") for k in ("name", "edge_key", "edge_secret")},
                   created=data.get("created", 0), modified=data.get("modified", 0))
