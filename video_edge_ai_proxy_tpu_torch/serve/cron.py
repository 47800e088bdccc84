"""Scheduled maintenance jobs.

Reference (``server/cron_jobs.go:38-83``): when the disk buffer is enabled, a
cron walks the archive folder on ``on_disk_schedule`` and deletes segments
older than ``on_disk_clean_older_than``. The reference accepts any
robfig/cron expression (``cron_jobs.go:39-49``; cron syntax is linked from
``README.md:296``), so this module parses the full vocabulary: Go-style
durations ("5m", "1h30m"), ``@every <dur>``, the ``@hourly``-family
descriptors, and 5-field cron specs ("0 3 * * *") with ranges, steps, lists,
and month/weekday names. Cron fields evaluate in UTC like the reference
(``cron_jobs.go:41``: ``cron.New(cron.WithLocation(time.UTC))``)."""

from __future__ import annotations

import calendar
import logging
import os
import re
import threading
import time
from datetime import datetime, timedelta, timezone

log = logging.getLogger("vep.torch.serve.cron")

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")  # ms before m: greedy alt
_UNIT_S = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}


def parse_duration(spec: str) -> float:
    """Parse a Go-style duration ('5m', '1h30m', '90s') or '@every <dur>'
    schedule into seconds."""
    spec = spec.strip()
    if spec.startswith("@every"):
        spec = spec[len("@every"):].strip()
    matches = _DUR_RE.findall(spec)
    if not matches or _DUR_RE.sub("", spec).strip():
        raise ValueError(f"cannot parse duration {spec!r}")
    return sum(float(n) * _UNIT_S[u] for n, u in matches)


_MONTH_NAMES = {name.lower(): i for i, name in
                enumerate(calendar.month_abbr) if name}
_DOW_NAMES = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4,
              "fri": 5, "sat": 6}
_DESCRIPTORS = {  # robfig/cron's @-descriptors (cron_jobs.go uses the lib)
    "@yearly": "0 0 1 1 *", "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *", "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *", "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}


def _parse_field(field: str, lo: int, hi: int, names: dict) -> frozenset:
    """One cron field -> the set of matching values. Grammar:
    ``*`` (and its Quartz alias ``?``, which robfig/cron accepts in
    dom/dow), ``a``, ``a-b``, ``a,b,c``, each optionally ``/step``;
    numeric or named values (jan/feb…, sun/mon…); dow 7 aliases 0."""

    def value(tok: str) -> int:
        tok = tok.strip().lower()
        if tok in names:
            return names[tok]
        v = int(tok)
        if names is _DOW_NAMES and v == 7:
            v = 0
        if not lo <= v <= hi:
            raise ValueError(f"value {v} out of range [{lo},{hi}]")
        return v

    out: set[int] = set()
    for part in field.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step < 1:
                raise ValueError(f"step {step} < 1")
        if part in ("*", "?"):
            a, b = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a_s, b_s = part.split("-", 1)
            a, b = value(a_s), value(b_s)
            if b < a:  # wrap range e.g. fri-mon, 22-2
                out.update(range(a, hi + 1, step))
                out.update(range(lo, b + 1, step))
                continue
        else:
            a = b = value(part)
            if step > 1:  # "a/step" means a..hi by step (vixie cron)
                b = hi
        out.update(range(a, b + 1, step))
    if not out:
        raise ValueError(f"empty field {field!r}")
    return frozenset(out)


class CronSpec:
    """A 5-field cron schedule (minute hour day-of-month month day-of-week),
    evaluated in UTC. Standard-cron quirk preserved: when BOTH day-of-month
    and day-of-week are restricted, a day matches if EITHER does."""

    def __init__(self, spec: str):
        self.spec = spec = " ".join(spec.split())
        fields = spec.split(" ")
        if len(fields) != 5:
            raise ValueError(
                f"cron spec {spec!r} must have 5 fields "
                "(minute hour dom month dow)"
            )
        m, h, dom, mon, dow = fields
        self.minutes = _parse_field(m, 0, 59, {})
        self.hours = _parse_field(h, 0, 23, {})
        self.dom = _parse_field(dom, 1, 31, {})
        self.months = _parse_field(mon, 1, 12, _MONTH_NAMES)
        self.dow = _parse_field(dow, 0, 6, _DOW_NAMES)
        self._dom_star = dom.split("/")[0] in ("*", "?")
        self._dow_star = dow.split("/")[0] in ("*", "?")
        # Satisfiability check at parse time: "0 0 31 2 *" (Feb 31) parses
        # field-by-field but never fires — surface that HERE (boot), not as
        # a ValueError that kills the scheduler thread on first use.
        self.next_after(time.time())

    def _day_matches(self, d: datetime) -> bool:
        if d.month not in self.months:
            return False
        in_dom = d.day in self.dom
        in_dow = (d.isoweekday() % 7) in self.dow  # Monday=1 -> Sunday=0
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return in_dow
        if self._dow_star:
            return in_dom
        return in_dom or in_dow  # both restricted: either matches

    def next_after(self, now: float) -> float:
        """Epoch seconds of the first fire time strictly after ``now``."""
        d = datetime.fromtimestamp(now, tz=timezone.utc)
        d = d.replace(second=0, microsecond=0) + timedelta(minutes=1)
        # Day-first search keeps this ~hundreds of iterations worst case
        # (4 years covers any satisfiable dom/month combination incl. Feb 29).
        limit = d + timedelta(days=366 * 4 + 1)
        while d < limit:
            if not self._day_matches(d):
                d = (d + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if d.hour not in self.hours:
                nxt = [h for h in self.hours if h > d.hour]
                if not nxt:
                    d = (d + timedelta(days=1)).replace(hour=0, minute=0)
                    continue
                d = d.replace(hour=min(nxt), minute=0)
            if d.minute not in self.minutes:
                nxt = [m for m in self.minutes if m > d.minute]
                if not nxt:
                    d = (d + timedelta(hours=1)).replace(minute=0)
                    continue
                d = d.replace(minute=min(nxt))
                continue
            return d.timestamp()
        raise ValueError(f"cron spec {self.spec!r} never fires")


class EverySchedule:
    """Fixed-interval schedule (the duration/@every family)."""

    def __init__(self, interval_s: float):
        if interval_s <= 0:
            raise ValueError("interval must be positive")
        self.interval_s = interval_s

    def next_after(self, now: float) -> float:
        return now + self.interval_s


def parse_schedule(spec: str):
    """Any reference-accepted schedule -> object with ``next_after(epoch_s)``:
    durations/"@every" -> EverySchedule; "@daily" etc. and 5-field specs ->
    CronSpec (reference robfig/cron parity, ``cron_jobs.go:39-49``)."""
    spec = spec.strip()
    low = spec.lower()
    if low in _DESCRIPTORS:
        return CronSpec(_DESCRIPTORS[low])
    try:
        return EverySchedule(parse_duration(spec))
    except ValueError:
        pass
    try:
        return CronSpec(spec)
    except ValueError as exc:
        raise ValueError(
            f"cannot parse schedule {spec!r} as a duration, @descriptor, "
            f"or 5-field cron spec: {exc}"
        ) from None


def cleanup_archive(folder: str, older_than_s: float, *, now: float | None = None,
                    suffixes: tuple[str, ...] = (".mp4", ".npz")) -> int:
    """Delete archived segments older than the cutoff; returns count removed
    (reference ``startOnDiskCleanup``, ``cron_jobs.go:49-74``)."""
    now = now if now is not None else time.time()
    removed = 0
    for root, _dirs, files in os.walk(folder):
        for name in files:
            if not name.endswith(suffixes):
                continue
            path = os.path.join(root, name)
            try:
                if now - os.path.getmtime(path) > older_than_s:
                    os.unlink(path)
                    removed += 1
            except OSError:
                continue
    if removed:
        log.info("archive cleanup removed %d segments from %s", removed, folder)
    return removed


class CronJobs:
    """Background scheduler thread (reference ``StartCronJobs``,
    ``cron_jobs.go:21-47``)."""

    def __init__(self, buffer_cfg):
        self._cfg = buffer_cfg
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if not self._cfg.on_disk:
            return
        schedule = parse_schedule(self._cfg.on_disk_schedule)
        older = parse_duration(self._cfg.on_disk_clean_older_than)

        def run() -> None:
            while True:
                # Re-derived each cycle so cron specs fire at wall-clock
                # times ("0 3 * * *" = 03:00 UTC daily), not at fixed
                # offsets from boot. Satisfiability was proven at parse
                # time; anything else must not kill the scheduler thread.
                try:
                    delay = max(
                        0.0, schedule.next_after(time.time()) - time.time()
                    )
                except Exception as exc:
                    log.error("cron schedule wedged (%s); scheduler stopped",
                              exc)
                    return
                if self._stop.wait(delay):
                    return
                try:
                    cleanup_archive(self._cfg.on_disk_folder, older)
                except Exception as exc:
                    log.error("archive cleanup failed: %s", exc)

        self._thread = threading.Thread(target=run, name="cron-cleanup", daemon=True)
        self._thread.start()
        log.info(
            "cron: cleaning %s on schedule %r (older than %ss)",
            self._cfg.on_disk_folder, self._cfg.on_disk_schedule, older,
        )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
