"""Signed cloud client + annotation batch consumer.

Reference counterparts: ``server/services/edge_service.go`` (signed HTTPS
calls), ``server/batch/annotation_consumer.go`` (proto -> cloud annotation
mapping + batch POST), ``server/grpcapi/grpc_storage_api.go:63-88`` (storage
toggle PUT).

Deliberate divergence (resilience layer): the reference does one naked
POST per batch and drops it on failure (``annotation_consumer.go:90-93``
rejects; rmq re-delivers forever for transport errors, and the original
``make_batch_handler`` here just lost the batch). Posts now run through a
``RetryPolicy`` (decorrelated-jitter backoff under a ``Deadline`` budget)
inside a per-dependency ``CircuitBreaker``; classification: 401/403
(:class:`ForbiddenError`) and other 4xx are terminal, 5xx and transport
errors (``URLError``/socket) retry. A batch that exhausts its retries is
persisted to a bounded on-disk :class:`~..resilience.spool.DeadLetterSpool`
and re-drained oldest-first once a later post succeeds — a cloud outage
costs latency, not annotations.

The queued items are ``AnnotateRequest`` wire bytes, decoded here by the
port's own codec (``proto/annotate.py``): the same events, the same JSON.
"""

from __future__ import annotations

import logging
import urllib.error
import urllib.request
from typing import Optional

from ..proto.annotate import AnnotateRequest, decode
from ..resilience.breaker import BreakerOpen, CircuitBreaker
from ..resilience.policy import Deadline, DeadlineExceeded, RetryPolicy
from ..resilience.spool import DeadLetterSpool
from ..utils.signing import sign_request

log = logging.getLogger("vep.torch.uplink.cloud")


class ForbiddenError(RuntimeError):
    """401/403 from the cloud (reference ``ErrForbidden``,
    ``edge_service.go:58-61``)."""


class CloudHTTPError(RuntimeError):
    """Non-auth HTTP error from the cloud; ``retryable`` iff 5xx."""

    def __init__(self, code: int, detail: str = ""):
        super().__init__(f"cloud API error {code}: {detail}")
        self.code = code

    @property
    def retryable(self) -> bool:
        return self.code >= 500


def _transport_retryable(exc: BaseException) -> bool:
    """Retry classification for cloud posts: 5xx/transport yes; auth,
    other 4xx, open breaker, and spent deadline no."""
    if isinstance(exc, (ForbiddenError, BreakerOpen, DeadlineExceeded)):
        return False
    if isinstance(exc, CloudHTTPError):
        return exc.retryable
    return True  # URLError, socket timeouts, connection resets


class CloudClient:
    def __init__(self, settings, api_endpoint: str = "", timeout_s: float = 10.0):
        self._settings = settings
        self._endpoint = api_endpoint.rstrip("/")
        self._timeout = timeout_s

    def call(self, method: str, url: str, body,
             deadline: Optional[Deadline] = None) -> bytes:
        """One signed HTTP call. A ``deadline`` clamps the socket timeout
        to the caller's remaining budget, so nested retries can never
        out-wait the top-level deadline."""
        timeout = self._timeout
        if deadline is not None:
            deadline.check("cloud call")
            timeout = deadline.clamp(self._timeout)
        edge_key, edge_secret = self._settings.edge_credentials()
        payload, headers = sign_request(body, edge_key, edge_secret)
        req = urllib.request.Request(url, data=payload, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                raise ForbiddenError(f"cloud rejected credentials: {exc.code}")
            raise CloudHTTPError(exc.code, repr(exc.read()[:200]))

    def set_storage(self, stream_key: str, enable: bool) -> bytes:
        # Signed PUT <api>/api/v1/edge/storage/<key>?enable=
        # (grpc_storage_api.go:63-88).
        url = f"{self._endpoint}/api/v1/edge/storage/{stream_key}"
        return self.call("PUT", url, {"enabled": enable})

    def post_annotations(self, url: str, annotations: list[dict],
                         deadline: Optional[Deadline] = None) -> bytes:
        return self.call("POST", url, annotations, deadline=deadline)


def annotation_to_cloud(req: AnnotateRequest) -> dict:
    """proto -> cloud event mapping (reference ``RequestToAnnotation``,
    ``annotation_consumer.go:124-175``)."""
    out: dict = {
        "device_name": req.device_name,
        "remote_stream_id": req.remote_stream_id,
        "type": req.type,
        "start_timestamp": req.start_timestamp,
        "end_timestamp": req.end_timestamp,
        "object_type": req.object_type,
        "object_id": req.object_id,
        "object_tracking_id": req.object_tracking_id,
        "confidence": req.confidence,
        "ml_model": req.ml_model,
        "ml_model_version": req.ml_model_version,
        "width": req.width,
        "height": req.height,
        "is_keyframe": req.is_keyframe,
        "video_type": req.video_type,
        "offset_timestamp": req.offset_timestamp,
        "offset_duration": req.offset_duration,
        "offset_frame_id": req.offset_frame_id,
        "offset_packet_id": req.offset_packet_id,
        "custom_meta_1": req.custom_meta_1,
        "custom_meta_2": req.custom_meta_2,
        "custom_meta_3": req.custom_meta_3,
        "custom_meta_4": req.custom_meta_4,
        "custom_meta_5": req.custom_meta_5,
    }
    if req.object_bouding_box is not None:
        bb = req.object_bouding_box
        out["bounding_box"] = {
            "top": bb.top, "left": bb.left,
            "width": bb.width, "height": bb.height,
        }
    if req.location is not None:
        out["location"] = {"lat": req.location.lat, "lon": req.location.lon}
    if req.object_coordinate is not None:
        c = req.object_coordinate
        out["object_coordinate"] = {"x": c.x, "y": c.y, "z": c.z}
    if req.mask:
        out["mask"] = [{"x": c.x, "y": c.y, "z": c.z} for c in req.mask]
    if req.object_signature:
        out["object_signature"] = list(req.object_signature)
    return out


def _decode_batch(batch: list[bytes]) -> list[dict]:
    events = []
    for raw in batch:
        try:
            events.append(annotation_to_cloud(decode(raw)))
        except Exception as exc:
            log.error("dropping undecodable annotation: %s", exc)
    return events


def make_batch_handler(
    settings,
    annotation_endpoint: str,
    *,
    client=None,
    spool: Optional[DeadLetterSpool] = None,
    retry: Optional[RetryPolicy] = None,
    breaker: Optional[CircuitBreaker] = None,
    post_deadline_s: float = 30.0,
):
    """Build the AnnotationQueue batch handler: deserialize, map, signed
    POST through retry + breaker, dead-letter spool on exhaustion.

    Contract per batch:
    - success: POST the live batch, then drain any spooled backlog
      oldest-first through the now-healthy uplink; returns True (ack).
    - transient failure (5xx / transport / breaker open): the RAW batch
      is persisted to ``spool`` and acked (persisted == not lost); with
      no spool (or a full one) returns False so the queue requeues it.
    - ForbiddenError: terminal — the consumer disables itself once
      (credentials do not heal by retrying; reference ``ErrForbidden``
      semantics) and acks subsequent batches without posting.

    ``client``/``retry``/``breaker`` are injectable for tests and the
    chaos harness; attributes ``handle.state`` / ``handle.breaker`` /
    ``handle.spool`` expose the wiring for artifacts.
    """
    client = client or CloudClient(settings)
    retry = retry or RetryPolicy(max_attempts=3, base_s=0.5, cap_s=5.0)
    breaker = breaker or CircuitBreaker(
        "annotation_uplink", failure_threshold=5, recovery_timeout_s=15.0
    )
    state = {"disabled": False}

    def _post(events: list[dict]) -> None:
        deadline = Deadline.after(post_deadline_s)
        retry.run(
            lambda: breaker.call(
                lambda: client.post_annotations(
                    annotation_endpoint, events, deadline=deadline
                ),
                # An auth rejection means the dependency ANSWERED: it
                # must not trip the breaker open.
                excluded=(ForbiddenError,),
            ),
            should_retry=_transport_retryable,
            deadline=deadline,
        )

    def _drain_spool() -> None:
        if spool is None or spool.pending() == 0:
            return

        def deliver(items: list[bytes]) -> bool:
            events = _decode_batch(items)
            if not events:
                return True  # nothing decodable left in this batch
            try:
                _post(events)
                return True
            except ForbiddenError:
                raise  # handled by the caller: terminal disable
            except Exception:
                return False  # uplink unhealthy again; stop, retry later

        n = spool.drain(deliver)
        if n:
            log.info("re-delivered %d spooled annotation batch(es)", n)

    def handle(batch: list[bytes]) -> bool:
        if state["disabled"]:
            return True  # terminally disabled (logged once below)
        events = _decode_batch(batch)
        try:
            if events:
                _post(events)
            _drain_spool()
            return True
        except ForbiddenError:
            state["disabled"] = True
            log.error(
                "cloud rejected edge credentials; annotation uplink disabled"
                " (batches will be acked and dropped)"
            )
            return True  # reference acks-on-forbidden would retry forever;
            # credentials won't heal by retrying — drop and surface in logs
        except Exception as exc:
            if spool is not None:
                if spool.put(batch) is not None:
                    log.warning(
                        "annotation uplink failed (%s); batch spooled", exc
                    )
                    return True  # persisted == acked; drained on recovery
                log.error(
                    "annotation uplink failed and spool is full; requeueing"
                )
                return False
            log.warning("annotation uplink failed (%s); will requeue", exc)
            return False

    handle.state = state
    handle.breaker = breaker
    handle.spool = spool
    return handle
