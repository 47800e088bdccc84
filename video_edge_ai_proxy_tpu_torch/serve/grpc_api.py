"""gRPC ``Image`` service, the data and ML plane (counterpart of
``video_edge_ai_proxy_tpu/serve/grpc_api.py``).

Wire and behaviour of the reference handler:

- ``VideoLatestImage`` (bidi): per request, write the keyframe-only flag
  and the last-query stamp to the control plane, read the newest frame
  past the connection's cursor (at most ``FRAME_WAIT_RETRIES`` tries,
  latest-frame-wins) and send it. Cursors are per connection. The stream
  ends with DEADLINE_EXCEEDED after ``stream_deadline_s`` (the reference's
  15 s).
- ``ListStreams``: one health record per registered camera, from the
  worker heartbeat and the supervisor's state.
- ``Annotate``: edge key required, start timestamp within ±7 days,
  ack-on-enqueue of the request's wire bytes into the uplink queue.
- ``Proxy`` / ``Storage``: the RTMP pass-through and cloud-storage toggles.
- ``Inference``: server-streams the engine's results. The port's engine
  yields ``engine.runner.InferenceResult`` dataclasses; they become
  ``pb.InferenceResult`` here, field by field.

Imports ``grpc`` and ``google.protobuf``: only ``Server.start`` imports
this module.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator

import grpc

from ..bus import FrameBus
from ..obs import registry as obs_registry
from ..proto import video_streaming_pb2 as pb
from ..uplink.queue import AnnotationQueue
from ..utils.parsing import parse_rtmp_key
from .process_manager import ProcessError, ProcessManager
from .settings import SettingsManager

log = logging.getLogger("vep.torch.serve.grpc")

FRAME_WAIT_RETRIES = 3          # reference grpc_api.go:187 (retry <= 3)
FRAME_WAIT_SLEEP_S = 0.016     # reference 16 ms sleep between tries (:228)
FRAME_BLOCK_S = 1.0            # reference XREAD Block=1s (:191)
ANNOTATION_TS_WINDOW_MS = 7 * 24 * 3600 * 1000  # ±7 days (:26-33)


class ImageServicer:
    def __init__(
        self,
        bus: FrameBus,
        process_manager: ProcessManager,
        settings: SettingsManager,
        annotations: AnnotationQueue,
        engine=None,                      # Optional[InferenceEngine]
        stream_deadline_s: float = 15.0,  # reference hard 15 s (:135)
        api_endpoint: str = "",
    ):
        self._bus = bus
        self._pm = process_manager
        self._settings = settings
        self._annotations = annotations
        self._engine = engine
        self._deadline = stream_deadline_s
        self._api_endpoint = api_endpoint
        self._m_frames_served = obs_registry.counter(
            "vep_grpc_frames_served_total",
            "VideoLatestImage frames streamed to clients", ("stream",))
        self._m_results_streamed = obs_registry.counter(
            "vep_grpc_results_streamed_total",
            "Inference results streamed to clients", ("stream",))

    # -- VideoLatestImage: the hot path --

    def VideoLatestImage(self, request_iterator, context) -> Iterator[pb.VideoFrame]:
        started = time.monotonic()
        cursors: dict = {}  # per connection
        for req in request_iterator:
            if self._deadline > 0 and time.monotonic() - started > self._deadline:
                # Clients run reconnect loops, as with the reference's 15 s
                # stream deadline.
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "stream deadline reached")
            device_id = req.device_id
            self._bus.set_keyframe_only(device_id, req.key_frame_only)
            self._bus.touch_query(device_id)
            frame = self._wait_latest(device_id, cursors.get(device_id, 0))
            if frame is None:
                continue  # nothing on a miss; serve the next request
            cursors[device_id] = frame.seq
            self._m_frames_served.labels(device_id).inc()
            yield frame_to_proto(device_id, frame)

    def _wait_latest(self, device_id: str, cursor: int):
        for attempt in range(FRAME_WAIT_RETRIES):
            frame = self._bus.read_latest_blocking(device_id, min_seq=cursor,
                                                   timeout_s=FRAME_BLOCK_S)
            if frame is not None:
                return frame
            if attempt < FRAME_WAIT_RETRIES - 1:
                time.sleep(FRAME_WAIT_SLEEP_S)
        return None

    # -- ListStreams --

    def ListStreams(self, request, context) -> Iterator[pb.ListStream]:
        for record in self._pm.list():
            state = record.state
            hb = record.heartbeat or {}
            health = "healthy" if hb.get("fps", 0) > 0 else (
                "starting" if state and state.running else "unhealthy")
            yield pb.ListStream(
                name=record.name,
                status=record.status,
                failing_streak=state.failing_streak if state else 0,
                health_status=health,
                dead=state.dead if state else False,
                exit_code=state.exit_code if state else 0,
                pid=state.pid if state else 0,
                running=state.running if state else False,
                paused=False,
                restarting=state.restarting if state else False,
                oomkilled=state.oom_killed if state else False,
                error=state.error if state else "",
                source=hb.get("source", ""),
            )

    # -- Annotate --

    def Annotate(self, request, context) -> pb.AnnotateResponse:
        edge_key, _ = self._settings.edge_credentials()
        if not edge_key:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "edge key/secret not configured (settings)")
        now_ms = int(time.time() * 1000)
        if abs(request.start_timestamp - now_ms) > ANNOTATION_TS_WINDOW_MS:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "start_timestamp outside +-7 day window")
        # Ack-on-enqueue (reference grpc_annotation_api.go:40-56).
        self._annotations.publish(request.SerializeToString())
        return pb.AnnotateResponse(
            device_name=request.device_name,
            remote_stream_id=request.remote_stream_id,
            type=request.type,
            start_timestamp=request.start_timestamp,
        )

    # -- Proxy / Storage toggles --

    def Proxy(self, request, context) -> pb.ProxyResponse:
        # Validate before writing control-plane state: a typo'd device_id
        # must not leave orphaned toggle keys in the shared KV.
        try:
            record = self._pm.info(request.device_id)
        except ProcessError:
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown device")
            raise
        self._bus.set_proxy_rtmp(request.device_id, request.passthrough)
        self._bus.touch_query(request.device_id)
        if record.rtmp_stream_status is not None:
            record.rtmp_stream_status.streaming = request.passthrough
            self._pm.update_record(record)
        return pb.ProxyResponse(device_id=request.device_id, passthrough=request.passthrough)

    def Storage(self, request, context) -> pb.StorageResponse:
        try:
            record = self._pm.info(request.device_id)
        except ProcessError:
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown device")
            raise
        if not record.rtmp_endpoint:
            # The stream key comes from the RTMP endpoint
            # (grpc_storage_api.go:27-34).
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "device has no RTMP endpoint")
        stream_key = parse_rtmp_key(record.rtmp_endpoint)
        from ..uplink.cloud import CloudClient

        client = CloudClient(self._settings, api_endpoint=self._api_endpoint)
        try:
            client.set_storage(stream_key, request.start)
        except Exception as exc:
            context.abort(grpc.StatusCode.UNAVAILABLE, f"cloud call failed: {exc}")
        self._bus.hset("last_access_time_" + request.device_id, "store",
                       "true" if request.start else "false")
        if record.rtmp_stream_status is not None:
            record.rtmp_stream_status.storing = request.start
            self._pm.update_record(record)
        return pb.StorageResponse(device_id=request.device_id, start=request.start)

    # -- Inference --

    def Inference(self, request, context) -> Iterator[pb.InferenceResult]:
        if self._engine is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "inference engine not running")
        from ..models import registry

        if request.model and request.model not in registry.names():
            # Fail fast: a typo'd filter would otherwise hang the stream
            # forever, indistinguishable from "no frames yet".
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"unknown model {request.model!r}; registered: {registry.names()}")
        for result in self._engine.subscribe(device_ids=list(request.device_ids),
                                             context=context):
            # A non-empty filter narrows a subscription that carries several
            # models' results to one of them.
            if request.model and result.model != request.model:
                continue
            self._m_results_streamed.labels(result.device_id).inc()
            yield result_to_proto(result, registry.get(result.model).kind == "detect")


def result_to_proto(result, boxed: bool) -> pb.InferenceResult:
    """The engine's InferenceResult dataclass -> ``pb.InferenceResult``.
    ``boxed``: a detector's result, whose detections carry their box (a
    classifier's carry none, as in the JAX engine's messages)."""
    return pb.InferenceResult(
        device_id=result.device_id,
        timestamp=result.timestamp,
        model=result.model,
        model_version="0",
        detections=[
            pb.Detection(
                box=(pb.BoundingBox(top=d.box.top, left=d.box.left, width=d.box.width,
                                    height=d.box.height) if boxed else None),
                confidence=d.confidence,
                class_id=d.class_id,
                class_name=d.class_name,
                embedding=d.embedding,
                track_id=d.track_id,
            )
            for d in result.detections
        ],
        latency_ms=result.latency_ms,
        batch_size=result.batch_size,
        frame_packet=result.frame_packet,
        trace_id=result.trace_id,
        parent_span=result.parent_span,
    )


def frame_to_proto(device_id: str, frame) -> pb.VideoFrame:
    meta = frame.meta
    shape = pb.ShapeProto(dim=[
        pb.ShapeProto.Dim(size=meta.height, name="height"),
        pb.ShapeProto.Dim(size=meta.width, name="width"),
        pb.ShapeProto.Dim(size=meta.channels, name="channels"),
    ])
    return pb.VideoFrame(
        width=meta.width,
        height=meta.height,
        data=frame.data.tobytes(),
        timestamp=meta.timestamp_ms,
        is_keyframe=meta.is_keyframe,
        pts=meta.pts,
        dts=meta.dts,
        frame_type=meta.frame_type,
        is_corrupt=meta.is_corrupt,
        time_base=meta.time_base,
        shape=shape,
        device_id=device_id,
        packet=meta.packet,
        keyframe=meta.keyframe_cnt,
        trace_id=meta.trace_id,
        parent_span=meta.parent_span,
    )
