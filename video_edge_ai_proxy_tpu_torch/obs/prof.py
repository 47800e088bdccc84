"""Triggered device profiling (counterpart of
``video_edge_ai_proxy_tpu/obs/prof.py``): bounded ``torch.profiler``
captures written as bundles.

The lineage spans and the SLO plane say *that* a step is slow; only a
device trace says *where*. ``Profiler.capture`` is the one capture path
behind three surfaces:

- **On demand**: ``POST /api/v1/profile?ms=N`` (serve/rest_api.py) and
  the gRPC admin mirror ``vep.Admin/ProfileCapture`` (serve/server.py): a
  duration-bounded trace written into a self-contained *bundle*: the
  device trace (``device/<bundle>.trace.json``, Chrome trace-event JSON
  by ``export_chrome_trace``), the lineage spans and the decision-journal
  events that overlapped the capture, an engine snapshot and a
  ``manifest.json`` linking them.
- **Triggered**: the engine polls ``Profiler.poll`` off its tick
  (engine/runner.py ``_watch_tick``) with the SLO episode total and the
  ladder's rung; a new episode or an escalation fires ONE rate-limited
  capture. Off by default (``prof_trigger``): the server forks camera
  workers, and a trace must not overlap a fork.
- **Retention ring**: bundles live under one directory bounded by
  ``retention_bytes``; the oldest are evicted first.

Design notes:

- **torch.profiler inside functions.** The default device tracer imports
  it when a capture runs. On an engine on the card it records
  ``ProfilerActivity.CPU`` and ``CUDA``; only an engine the caller put on
  the CPU records ``CPU`` alone. A card capture that recorded no CUDA
  activity raises, and the manifest carries the error: there is no
  CPU-only bundle in its place.
- **Injectable everything.** ``clock``/``wall_clock``/``sleep`` and the
  ``device_tracer`` callable are constructor parameters, so the trigger
  discipline, the rate limit and the ring are tested on fake clocks with
  a stub tracer.
- **One capture at a time.** Bounded captures, triggered captures and the
  unbounded ``start``/``stop`` pair share one busy flag; a second caller
  gets ``RuntimeError`` (REST maps it to 409). The flag covers this
  profiler's captures only; Kineto is process-global, so a capture also
  refuses while any other torch.profiler session runs (a nested session
  would end the outer one), and that surfaces as the capture's
  ``error``. A failed start leaves the flag clear.
- **A capture never kills its caller**: a tracer failure is recorded in
  the manifest and counted (``vep_prof_errors_total``).
- **Idle cost is a poll**: one ``poll()`` per engine tick, a few compares
  under a lock.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, List, Optional

from . import metrics

log = logging.getLogger("vep.obs.prof")

__all__ = ["Profiler", "find_device_trace"]

# File names inside every bundle directory.
MANIFEST = "manifest.json"
SPANS = "spans.json"
SNAPSHOT = "snapshot.json"
JOURNAL = "journal.json"
DEVICE_DIR = "device"

# Kineto's Chrome-trace categories of device activity.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# Span-window slack: spans stamped up to this long after stop_trace still
# belong to the capture (the drain thread emits a batch's spans slightly
# after the device work the trace saw).
_SPAN_SLACK_S = 0.25


def _refuse_if_profiling() -> None:
    """Kineto is process-global, and a profiler started inside another's
    session ends that session: the outer one's exit then crashes the
    process (seen with torch 2.13 on the CPU). So a capture refuses while
    any torch.profiler session runs, whoever started it."""
    import torch

    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("another torch.profiler session is active")


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda
            else [ProfilerActivity.CPU])


def _export(prof, log_dir: str, name: str, cuda: bool) -> None:
    """Write ``<log_dir>/<name>.trace.json``; on the card, raise when the
    trace holds no device activity."""
    path = os.path.join(log_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(ev.get("cat") in _DEVICE_CATS for ev in events):
            raise RuntimeError("the capture recorded no CUDA activity")


def _torch_device_tracer(log_dir: str, ms: int, sleep: Callable, *,
                         cuda: bool) -> None:
    """The real bounded capture: a ``torch.profiler.profile`` held open
    for ``ms``, exported as ``<bundle>.trace.json`` into ``log_dir`` (the
    bundle's ``device/``). torch is imported here, not at module scope."""
    from torch.profiler import profile

    _refuse_if_profiling()
    with profile(activities=_activities(cuda)) as prof:
        sleep(ms / 1000.0)
    _export(prof, log_dir, os.path.basename(os.path.dirname(log_dir)), cuda)


def find_device_trace(bundle_dir: str) -> Optional[str]:
    """Locate the Perfetto/Chrome JSON a profiler wrote under a bundle
    (``device/<bundle>.trace.json`` from torch.profiler; a
    ``perfetto_trace.json.gz`` first if one is there). Returns a path
    relative to ``bundle_dir``, or None."""
    root = os.path.join(bundle_dir, DEVICE_DIR)
    best: Optional[str] = None
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name.endswith("perfetto_trace.json.gz"):
                return os.path.relpath(os.path.join(dirpath, name),
                                       bundle_dir)
            if name.endswith((".trace.json.gz", ".trace.json")):
                best = best or os.path.relpath(
                    os.path.join(dirpath, name), bundle_dir)
    return best


class Profiler:
    """Bounded torch.profiler captures into a byte-bounded bundle ring.
    ``cuda``: the engine's device is the card (the default tracer records
    its CUDA activity)."""

    def __init__(
        self,
        directory: str,
        *,
        retention_bytes: int = 256 << 20,
        trigger: bool = True,
        trigger_ms: int = 500,
        trigger_min_interval_s: float = 60.0,
        max_ms: int = 10_000,
        keep_manifests: int = 64,
        clock=time.monotonic,
        wall_clock=time.time,
        sleep=time.sleep,
        device_tracer: Optional[Callable[[str, int], None]] = None,
        tracer=None,
        journal=None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        registry: Optional[metrics.Registry] = None,
        async_triggers: bool = True,
        cuda: bool = True,
    ):
        reg = registry if registry is not None else metrics.registry
        self.directory = directory
        self.retention_bytes = int(retention_bytes)
        self.trigger_enabled = bool(trigger)
        self.trigger_ms = int(trigger_ms)
        self.trigger_min_interval_s = float(trigger_min_interval_s)
        self.max_ms = int(max_ms)
        self._keep_manifests = int(keep_manifests)
        self._clock = clock
        self._wall = wall_clock
        self._sleep = sleep
        self._device_tracer = device_tracer
        self._tracer = tracer
        # Decision journal (obs/journal.py): events whose wall time
        # overlapped the capture land in the bundle as journal.json —
        # the WHY half next to the lineage spans' WHERE.
        self._journal = journal
        self._snapshot_fn = snapshot_fn
        self._async_triggers = bool(async_triggers)
        self._cuda = bool(cuda)
        self._manual = None                  # the start()/stop() profile

        self._lock = threading.Lock()
        self._busy: Optional[str] = None     # None | "capture" | "manual"
        self._seq = 0
        self._captures: List[dict] = []      # recent manifests, bounded
        self._last_trigger_t: Optional[float] = None
        self._seen_episodes = 0
        self._seen_rung = 0
        self._trigger_thread: Optional[threading.Thread] = None
        self.errors = 0

        self._m_captures = reg.counter(
            "vep_prof_captures_total",
            "Completed profile captures by trigger source", ("trigger",))
        self._m_capture_ms = reg.histogram(
            "vep_prof_capture_wall_ms",
            "Capture wall time including trace flush")
        self._m_retained = reg.gauge(
            "vep_prof_retained_bytes",
            "Bytes currently held by the bundle retention ring").labels()
        self._m_evicted = reg.counter(
            "vep_prof_evicted_total",
            "Bundles evicted by the retention byte bound").labels()
        self._m_suppressed = reg.counter(
            "vep_prof_suppressed_total",
            "Trigger captures suppressed (rate limit / capture in flight)",
            ("reason",))
        self._m_errors = reg.counter(
            "vep_prof_errors_total", "Failed capture attempts").labels()
        # Expose the unlabeled counters at 0 from boot: "no evictions
        # yet" must be scrapeable, not indistinguishable from "no
        # profiler" (families without children do not render).
        self._m_evicted.inc(0)
        self._m_errors.inc(0)

        os.makedirs(directory, exist_ok=True)
        existing = self._bundles()
        if existing:
            tail = os.path.basename(existing[-1]).split("_", 1)[0]
            if tail.isdigit():
                self._seq = int(tail) + 1
        self._m_retained.set(self._retained_bytes())

    # -- bundle ring ------------------------------------------------------

    def _bundles(self) -> List[str]:
        """Bundle dirs oldest-first (seq-prefixed names sort by age)."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if os.path.isdir(os.path.join(self.directory, n)))
        except FileNotFoundError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    @staticmethod
    def _dir_bytes(path: str) -> int:
        total = 0
        for dirpath, _dirnames, filenames in os.walk(path):
            for name in filenames:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return total

    def _retained_bytes(self) -> int:
        return sum(self._dir_bytes(p) for p in self._bundles())

    def _enforce_retention(self) -> None:
        """Evict oldest bundles until the ring fits ``retention_bytes``.
        The newest bundle is evicted too if it alone exceeds the bound —
        the bound is a promise to the disk, not to the bundle."""
        bundles = self._bundles()
        sizes = {p: self._dir_bytes(p) for p in bundles}
        total = sum(sizes.values())
        while bundles and total > self.retention_bytes:
            victim = bundles.pop(0)
            shutil.rmtree(victim, ignore_errors=True)
            total -= sizes.get(victim, 0)
            self._m_evicted.inc()
            log.warning("prof retention ring over %d bytes; evicted %s",
                        self.retention_bytes, os.path.basename(victim))
        self._m_retained.set(max(total, 0))

    # -- capture ----------------------------------------------------------

    def _acquire(self, mode: str) -> None:
        with self._lock:
            if self._busy is not None:
                raise RuntimeError(
                    f"profiler already running ({self._busy})")
            self._busy = mode

    def _release(self) -> None:
        with self._lock:
            self._busy = None

    def capture(self, ms: int, *, trigger: str = "manual",
                context: Optional[dict] = None) -> dict:
        """One duration-bounded capture; returns the bundle manifest.

        Raises ``ValueError`` on a bad duration (REST maps it to 400) and
        ``RuntimeError`` when a capture or a manual trace is
        already in flight (REST maps it to 409).
        """
        ms = int(ms)
        if ms <= 0 or ms > self.max_ms:
            raise ValueError(
                f"capture duration must be in (0, {self.max_ms}] ms, "
                f"got {ms}")
        self._acquire("capture")
        try:
            return self._capture_locked(ms, trigger, context or {})
        finally:
            self._release()

    def _capture_locked(self, ms: int, trigger: str, context: dict) -> dict:
        with self._lock:
            seq = self._seq
            self._seq += 1
        name = f"{seq:08d}_{trigger}"
        bundle = os.path.join(self.directory, name)
        device_dir = os.path.join(bundle, DEVICE_DIR)
        os.makedirs(device_dir, exist_ok=True)
        t0_wall = self._wall()
        t0 = self._clock()
        error: Optional[str] = None
        try:
            tracer_fn = self._device_tracer
            if tracer_fn is not None:
                tracer_fn(device_dir, ms)
            else:
                _torch_device_tracer(device_dir, ms, self._sleep, cuda=self._cuda)
        except Exception as exc:  # capture must never kill the caller
            error = f"{type(exc).__name__}: {exc}"
            self.errors += 1
            self._m_errors.inc()
            log.error("device capture failed: %s", error)
        wall_ms = (self._clock() - t0) * 1000.0
        t1_wall = self._wall()

        # Concurrent lineage-span window: every sampled span whose end
        # timestamp falls inside the capture (plus drain slack).
        span_events: List[dict] = []
        if self._tracer is not None:
            span_events = [
                ev for ev in self._tracer.events()
                if t0_wall <= ev.get("ts", 0.0) <= t1_wall + _SPAN_SLACK_S
            ]
        with open(os.path.join(bundle, SPANS), "w") as f:
            json.dump({"events": span_events}, f)

        # Overlapping decision-journal window (same slack as the spans:
        # a decision journaled just after stop_trace still explains the
        # capture's tail).
        journal_events: List[dict] = []
        if self._journal is not None:
            try:
                journal_events = self._journal.window(
                    t0_wall, t1_wall + _SPAN_SLACK_S)
            except Exception as exc:  # the bundle is best effort
                log.error("prof journal window failed: %s", exc)
        with open(os.path.join(bundle, JOURNAL), "w") as f:
            json.dump({"events": journal_events}, f)

        snap: dict = {}
        if self._snapshot_fn is not None:
            try:
                snap = self._snapshot_fn() or {}
            except Exception as exc:
                log.error("prof snapshot_fn failed: %s", exc)
        with open(os.path.join(bundle, SNAPSHOT), "w") as f:
            json.dump(snap, f, default=str)

        manifest = {
            "bundle": name,
            "path": bundle,
            "trigger": trigger,
            "ms": ms,
            "wall_ms": round(wall_ms, 1),
            "t_start": t0_wall,
            "t_end": t1_wall,
            "device_trace": find_device_trace(bundle),
            "spans": SPANS,
            "span_events": len(span_events),
            "journal": JOURNAL,
            "journal_events": len(journal_events),
            "snapshot": SNAPSHOT,
            "slo_episode": context.get("slo_episode"),
            "context": context,
            "error": error,
        }
        with open(os.path.join(bundle, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
        with self._lock:
            self._captures.append(manifest)
            del self._captures[:-self._keep_manifests]
        self._m_captures.labels(trigger).inc()
        self._m_capture_ms.labels().observe(wall_ms)
        self._enforce_retention()
        log.info("profile capture %s (%s, %d ms) -> %s",
                 name, trigger, ms, bundle)
        return manifest

    # -- trigger discipline ------------------------------------------------

    def poll(self, *, episodes: int = 0, rung: int = 0,
             context: Optional[dict] = None) -> Optional[str]:
        """Engine-tick trigger check. ``episodes`` is the cumulative SLO
        episode total; ``rung`` the current ladder rung index. Fires at
        most one capture per new episode / per escalation, rate-limited
        to one per ``trigger_min_interval_s``. Returns the reason fired,
        else None. Cheap when idle: compares under a lock."""
        with self._lock:
            reason = None
            if episodes > self._seen_episodes:
                reason = "slo_episode"
            if rung > self._seen_rung:
                reason = reason or "ladder_escalation"
            # Watermarks advance even when suppressed: once-per-episode
            # means an episode gets at most one SHOT at a capture, not a
            # retry queue that fires stale captures after the excursion.
            self._seen_episodes = max(self._seen_episodes, int(episodes))
            self._seen_rung = int(rung)
            if reason is None:
                return None
            if not self.trigger_enabled:
                return None
            now = self._clock()
            if (self._last_trigger_t is not None
                    and now - self._last_trigger_t
                    < self.trigger_min_interval_s):
                self._m_suppressed.labels("rate_limit").inc()
                return None
            if self._busy is not None:
                self._m_suppressed.labels("busy").inc()
                return None
            self._last_trigger_t = now
        ctx = dict(context or {})
        ctx.setdefault("reason", reason)
        if self._async_triggers:
            # The capture sleeps trigger_ms: never on the engine tick
            # thread. One thread at most (the busy flag rejects overlap).
            t = threading.Thread(
                target=self._trigger_capture, args=(reason, ctx),
                name="prof-trigger", daemon=True)
            self._trigger_thread = t
            t.start()
        else:
            self._trigger_capture(reason, ctx)
        return reason

    def _trigger_capture(self, reason: str, context: dict) -> None:
        try:
            self.capture(self.trigger_ms, trigger=reason, context=context)
        except (RuntimeError, ValueError) as exc:
            self._m_suppressed.labels("busy").inc()
            log.info("trigger capture skipped: %s", exc)

    def join_trigger(self, timeout: float = 30.0) -> None:
        """Wait for an in-flight trigger capture (teardown)."""
        t = self._trigger_thread
        if t is not None:
            t.join(timeout)

    # -- unbounded path --------------------------------------------------

    def start(self, log_dir: str) -> None:
        """Unbounded manual trace (``InferenceEngine.start_profile``);
        shares the busy flag with bounded captures. ``stop`` writes it to
        ``<log_dir>/manual.trace.json``."""
        from torch.profiler import profile

        self._acquire("manual")
        try:
            _refuse_if_profiling()
            prof = profile(activities=_activities(self._cuda))
            prof.start()
        except Exception:
            self._release()
            raise
        self._manual = (prof, log_dir)
        log.info("profiler tracing to %s", log_dir)

    def stop(self) -> None:
        """Stop the manual trace started by :meth:`start`."""
        with self._lock:
            if self._busy != "manual":
                raise RuntimeError("profiler not running")
            # Clear the flag before stopping: the export writes to disk
            # and can raise, and a stuck flag wedges every later capture.
            self._busy = None
            prof, log_dir = self._manual
            self._manual = None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        _export(prof, log_dir, "manual", self._cuda)
        log.info("profiler trace stopped")

    # -- snapshots --------------------------------------------------------

    def captures(self) -> List[dict]:
        with self._lock:
            return list(self._captures)

    def snapshot(self) -> dict:
        """JSON-able state for /api/v1/stats."""
        with self._lock:
            captures = list(self._captures)
            busy = self._busy
        return {
            "dir": self.directory,
            "busy": busy,
            "trigger_enabled": self.trigger_enabled,
            "trigger_ms": self.trigger_ms,
            "trigger_min_interval_s": self.trigger_min_interval_s,
            "retention_bytes": self.retention_bytes,
            "retained_bytes": self._retained_bytes(),
            "bundles": len(self._bundles()),
            "errors": self.errors,
            "captures": captures,
        }
