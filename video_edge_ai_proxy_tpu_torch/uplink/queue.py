"""Annotation uplink queue.

Semantics parity with the reference's rmq-backed pipeline
(``server/grpcapi/grpc_api.go:69-75``, ``server/batch/annotation_consumer.go``):

- producers ``publish`` serialized events and return immediately
  (ack-on-enqueue, ``grpc_annotation_api.go:51-56``);
- a consumer thread polls every ``poll_duration_ms`` and hands off batches of
  up to ``max_batch_size`` (reference defaults 300 ms / 299,
  ``server/main.go:59-64``);
- failed batches are rejected and re-queued after ``requeue_interval_s``
  (reference: 5 s ticker returning rejected deliveries,
  ``annotation_consumer.go:33-52``) so the uplink survives internet outages;
- total unacked is bounded by ``unacked_limit`` (``main.go:63``) — beyond it,
  publishes are dropped with a log (backpressure by shedding, matching rmq's
  bounded-unacked behavior).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("vep.torch.uplink.queue")

BatchHandler = Callable[[list[bytes]], bool]  # True = ack, False = reject


class AnnotationQueue:
    def __init__(
        self,
        handler: Optional[BatchHandler] = None,
        *,
        max_batch_size: int = 299,
        poll_duration_ms: int = 300,
        unacked_limit: int = 1000,
        requeue_interval_s: float = 5.0,
    ):
        self._handler = handler
        self._max_batch = max_batch_size
        self._poll_s = poll_duration_ms / 1000.0
        self._unacked_limit = unacked_limit
        self._requeue_s = requeue_interval_s
        self._queue: deque[bytes] = deque()
        self._rejected: deque[bytes] = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.published = 0
        self.acked = 0
        self.dropped = 0
        self.rejected_batches = 0

    # -- producer side --

    def publish(self, payload: bytes) -> bool:
        with self._lock:
            if len(self._queue) + len(self._rejected) >= self._unacked_limit:
                self.dropped += 1
                if self.dropped % 100 == 1:
                    log.warning(
                        "annotation queue full (%d unacked); dropping",
                        self._unacked_limit,
                    )
                return False
            self._queue.append(payload)
            self.published += 1
            return True

    def depth(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._rejected)

    # -- consumer side --

    def start(self) -> None:
        if self._handler is None:
            raise ValueError("no batch handler configured")
        self._thread = threading.Thread(
            target=self._run, name="annotation-consumer", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        last_requeue = time.monotonic()
        while not self._stop.wait(self._poll_s):
            now = time.monotonic()
            if now - last_requeue >= self._requeue_s:
                # Return rejected deliveries to the ready queue
                # (annotation_consumer.go:33-52).
                self.requeue_rejected()
                last_requeue = now
            self.drain_once()

    def drain_once(self) -> int:
        """Consume one batch synchronously; returns number acked (tests call
        this directly to avoid timing dependence)."""
        with self._lock:
            batch = [
                self._queue.popleft()
                for _ in range(min(self._max_batch, len(self._queue)))
            ]
        if not batch:
            return 0
        assert self._handler is not None
        try:
            ok = self._handler(batch)
        except Exception as exc:
            log.error("annotation batch handler raised: %s", exc)
            ok = False
        if ok:
            self.acked += len(batch)
            return len(batch)
        self.rejected_batches += 1
        with self._lock:
            self._rejected.extend(batch)
        return 0

    def requeue_rejected(self) -> None:
        with self._lock:
            while self._rejected:
                self._queue.appendleft(self._rejected.pop())

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
