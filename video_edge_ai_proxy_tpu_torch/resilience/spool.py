"""Bounded on-disk dead-letter spool for annotation batches.

Fixes a reference data-loss path: the reference drops an annotation
batch on any cloud POST failure (``grpc_server.go:204-217`` logs and
moves on). Here a batch that exhausts its retries is persisted as one
file under the spool directory and re-drained oldest-first once the
uplink recovers, so a cloud outage costs latency, not data.

Format: per batch, one ``<seq>.batch`` file — magic header, ``<I`` item
count, then per item ``<I`` length + raw bytes (the serialized
AnnotateRequest protos exactly as queued). Writes are atomic (tmp file +
``os.replace``) so a crash mid-write never leaves a torn batch; drain
nevertheless tolerates one (external truncation, non-atomic copies) by
salvaging the intact item prefix and counting only the torn tail as
dropped — a damaged file costs its tail, not the whole batch. The
spool is bounded by ``max_bytes``/``max_batches``; when full, the
*oldest* batches are evicted (and counted in ``dropped_batches``) so
accounting still balances: published = delivered + queue-dropped +
spool-dropped + pending.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from typing import Callable, List, Optional, Sequence

from ..obs import registry as obs_registry

log = logging.getLogger(__name__)

__all__ = ["DeadLetterSpool"]

_MAGIC = b"VEPSPOOL1\n"
_U32 = struct.Struct("<I")


class DeadLetterSpool:
    """One directory of length-prefixed batch files, oldest-first drain."""

    SUFFIX = ".batch"

    def __init__(
        self,
        directory: str,
        *,
        max_bytes: int = 64 << 20,
        max_batches: int = 4096,
    ):
        self.directory = directory
        self.max_bytes = int(max_bytes)
        self.max_batches = int(max_batches)
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        existing = self._files_locked()
        self._seq = 0
        if existing:
            self._seq = int(os.path.basename(existing[-1]).split(".")[0]) + 1
        # Conservation counters (batches and events) for soak artifacts.
        self.spooled_batches = 0
        self.spooled_events = 0
        self.drained_batches = 0
        self.drained_events = 0
        self.dropped_batches = 0
        self.dropped_events = 0
        self.truncated_batches = 0
        self._m_pending = obs_registry.gauge(
            "vep_spool_pending_batches", "Dead-letter batches awaiting re-drain", ("spool",)
        ).labels(os.path.basename(directory) or "spool")
        self._m_spooled = obs_registry.counter(
            "vep_spool_spooled_total", "Batches persisted to the dead-letter spool", ("spool",)
        ).labels(os.path.basename(directory) or "spool")
        self._m_drained = obs_registry.counter(
            "vep_spool_drained_total", "Spooled batches re-delivered on recovery", ("spool",)
        ).labels(os.path.basename(directory) or "spool")
        self._m_dropped = obs_registry.counter(
            "vep_spool_dropped_total", "Spooled batches evicted by size bounds", ("spool",)
        ).labels(os.path.basename(directory) or "spool")
        self._m_truncated = obs_registry.counter(
            "vep_spool_truncated_total",
            "Spooled batches with a torn tail salvaged on drain",
            ("spool",),
        ).labels(os.path.basename(directory) or "spool")
        self._m_pending.set(len(existing))

    # -- internal ---------------------------------------------------------

    def _files_locked(self) -> List[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.directory) if n.endswith(self.SUFFIX)
            )
        except FileNotFoundError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    @staticmethod
    def _encode(batch: Sequence[bytes]) -> bytes:
        parts = [_MAGIC, _U32.pack(len(batch))]
        for item in batch:
            parts.append(_U32.pack(len(item)))
            parts.append(item)
        return b"".join(parts)

    @staticmethod
    def _salvage(blob: bytes) -> tuple:
        """(items, missing) — the valid item prefix of a batch blob plus
        how many declared items the tail lost. A crash mid-write (or
        external truncation) tears the file at an arbitrary byte: every
        length-prefixed item before the tear is intact and recoverable,
        only the torn tail is gone. (None, 0) when nothing is usable —
        bad magic or a header too short to carry the count."""
        if not blob.startswith(_MAGIC):
            return None, 0
        off = len(_MAGIC)
        try:
            (count,) = _U32.unpack_from(blob, off)
        except struct.error:
            return None, 0
        off += _U32.size
        items: List[bytes] = []
        for _ in range(count):
            try:
                (n,) = _U32.unpack_from(blob, off)
            except struct.error:
                break
            off += _U32.size
            item = blob[off : off + n]
            if len(item) != n:
                break
            items.append(item)
            off += n
        return items, count - len(items)

    @staticmethod
    def _decode(blob: bytes) -> Optional[List[bytes]]:
        """Strict decode: a torn tail is corruption (None). The drain
        path uses :meth:`_salvage` instead — skip-and-count."""
        items, missing = DeadLetterSpool._salvage(blob)
        return items if items is not None and not missing else None

    def _evict_locked(self, incoming_bytes: int) -> None:
        files = self._files_locked()
        total = sum(os.path.getsize(p) for p in files)
        while files and (
            total + incoming_bytes > self.max_bytes or len(files) + 1 > self.max_batches
        ):
            victim = files.pop(0)
            try:
                size = os.path.getsize(victim)
                blob = open(victim, "rb").read()
                os.remove(victim)
            except OSError:
                continue
            total -= size
            items = self._decode(blob)
            self.dropped_batches += 1
            self.dropped_events += len(items) if items else 0
            self._m_dropped.inc()
            log.warning(
                "spool %s over bounds; evicted oldest batch %s",
                self.directory,
                os.path.basename(victim),
            )

    # -- public -----------------------------------------------------------

    def put(self, batch: Sequence[bytes]) -> Optional[str]:
        """Persist a batch; returns the file path, or None if it cannot fit."""
        blob = self._encode(batch)
        if len(blob) > self.max_bytes:
            return None
        with self._lock:
            self._evict_locked(len(blob))
            path = os.path.join(self.directory, f"{self._seq:012d}{self.SUFFIX}")
            self._seq += 1
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as fh:
                    fh.write(blob)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
            except OSError as exc:
                log.error("spool write failed (%s); batch not persisted", exc)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            self.spooled_batches += 1
            self.spooled_events += len(batch)
            self._m_spooled.inc()
            self._m_pending.set(len(self._files_locked()))
            return path

    def drain(self, handler: Callable[[List[bytes]], bool]) -> int:
        """Re-deliver spooled batches oldest-first through ``handler``.

        ``handler(items) -> True`` deletes the file and continues; False
        stops the drain so order is preserved for the next attempt (an
        exception propagates with the file likewise left in place).
        Returns the number of batches delivered.

        A batch with a torn tail (crash mid-write, external truncation)
        is *salvaged*, not dropped wholesale: the intact item prefix is
        delivered and only the missing tail items are counted into
        ``dropped_events`` (plus ``truncated_batches``). Files unusable
        past the header (bad magic, short header) are removed and
        counted as dropped batches.
        """
        delivered = 0
        while True:
            with self._lock:
                files = self._files_locked()
                if not files:
                    break
                path = files[0]
                try:
                    blob = open(path, "rb").read()
                except OSError:
                    break
                items, missing = self._salvage(blob)
                if items is None or not items:
                    # Nothing recoverable: bad magic/header, or the tear
                    # landed before the first item survived.
                    log.error("spool: corrupt batch %s removed", os.path.basename(path))
                    os.remove(path)
                    self.dropped_batches += 1
                    self.dropped_events += missing if items is not None else 0
                    self._m_dropped.inc()
                    self._m_pending.set(len(self._files_locked()))
                    continue
                if missing:
                    self.truncated_batches += 1
                    self.dropped_events += missing
                    self._m_truncated.inc()
                    log.warning(
                        "spool: batch %s torn mid-write; salvaged %d of %d items",
                        os.path.basename(path),
                        len(items),
                        len(items) + missing,
                    )
            # Handler runs outside the lock: it may post to the network.
            if not handler(items):
                break
            with self._lock:
                try:
                    os.remove(path)
                except OSError:
                    pass
                self.drained_batches += 1
                self.drained_events += len(items)
                self._m_drained.inc()
                self._m_pending.set(len(self._files_locked()))
            delivered += 1
        return delivered

    def pending(self) -> int:
        with self._lock:
            return len(self._files_locked())

    def pending_bytes(self) -> int:
        with self._lock:
            return sum(os.path.getsize(p) for p in self._files_locked())

    def pending_events(self) -> int:
        with self._lock:
            total = 0
            for path in self._files_locked():
                try:
                    items = self._decode(open(path, "rb").read())
                except OSError:
                    continue
                total += len(items) if items else 0
            return total

    def snapshot(self) -> dict:
        return {
            "dir": self.directory,
            "pending_batches": self.pending(),
            "pending_events": self.pending_events(),
            "spooled_batches": self.spooled_batches,
            "spooled_events": self.spooled_events,
            "drained_batches": self.drained_batches,
            "drained_events": self.drained_events,
            "dropped_batches": self.dropped_batches,
            "dropped_events": self.dropped_events,
            "truncated_batches": self.truncated_batches,
        }
