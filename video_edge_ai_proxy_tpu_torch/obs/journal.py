"""Control-plane decision journal (counterpart of
``video_edge_ai_proxy_tpu/obs/journal.py``): causally linked audit events.

``DecisionJournal`` is a process-wide bounded ring of decision events,
recorded by the loops that change the serving path: the degradation
ladder (``escalate``/``recover``), the SLO engine (``episode_open``/
``episode_close``), the engine's shed excursion (``shed_open``/
``shed_close``) and the watchdog (``episode_open``/``episode_close``).

- The ring is parallel slot lists preallocated at construction; ``record``
  writes one index per field. Sequence numbers start at 1, are monotone
  and never reused: they are the ``cause`` links.
- Every event carries ``actor``, ``action``, ``subject`` (``(kind, id)``),
  the ``trigger`` numbers that forced it and ``cause``, the seq of the
  event that provoked it: SLO burn -> ladder rung -> shed excursion.
- ``why(kind, id)`` finds the subject's newest event and walks the cause
  links back into a chain, root first. A cause older than the oldest
  retained slot becomes an ``(evicted)`` root marker, never an error. A
  subject nothing recorded answers ``found: False``.
- Events are edge-triggered: actors journal state changes, never per-tick
  observations, so the journal stays off the per-frame path; a replay is
  bit-identical with it on and off.

Pure Python, stdlib and ``obs.metrics`` only. The fleet merge
(``merge_journals``) comes with the fleet tier.

Metric families: ``vep_journal_events_total{actor,action}``,
``vep_journal_evictions_total``, ``vep_journal_retained``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

Subject = Tuple[str, str]


def format_event(ev: dict) -> str:
    """One human-readable line for a journal event dict — the ``why()``
    chain rendering: ``[seq] actor.action subject (k=v, ...)``."""
    parts = [f"[{ev['seq']}]", f"{ev['actor']}.{ev['action']}"]
    if ev.get("subject"):
        kind, ident = ev["subject"]
        parts.append(f"{kind}={ident}")
    trig = ev.get("trigger")
    if trig:
        kv = []
        for k in sorted(trig):
            v = trig[k]
            kv.append(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}")
        parts.append("(" + ", ".join(kv) + ")")
    return " ".join(parts)


class DecisionJournal:
    """Bounded, causally-linked journal of control-plane decisions.

    ``capacity`` slots; ``clock`` injectable (defaults to wall time —
    fleet merge orders events across processes, so monotonic clocks
    from different members would not compare)."""

    def __init__(self, capacity: int = 4096, *, clock=time.time,
                 registry=None):
        if registry is None:
            from .metrics import registry as _registry
            registry = _registry
        self._cap = max(16, int(capacity))
        self._clock = clock
        self._lock = threading.Lock()
        # Parallel slot lists — the ring. record() writes by index;
        # nothing is appended or popped after construction.
        n = self._cap
        self._s_ts: List[float] = [0.0] * n
        self._s_actor: List[str] = [""] * n
        self._s_action: List[str] = [""] * n
        self._s_subj: List[Optional[Subject]] = [None] * n
        self._s_trigger: List[Optional[dict]] = [None] * n
        self._s_cause: List[Optional[int]] = [None] * n
        self._next_seq = 1           # seqs are 1-based, monotone, unique
        self._c_events = registry.counter(
            "vep_journal_events_total",
            "Control-plane decision events recorded",
            ("actor", "action"))
        self._c_evicted = registry.counter(
            "vep_journal_evictions_total",
            "Journal ring overwrites (oldest event evicted)")
        self._g_retained = registry.gauge(
            "vep_journal_retained",
            "Decision events currently retained in the ring")

    # -- record path ---------------------------------------------------------

    def record(self, actor: str, action: str, *,
               subject: Optional[Subject] = None,
               trigger: Optional[dict] = None,
               cause: Optional[int] = None) -> int:
        """Append one decision event; returns its seq (the handle
        callers thread into later ``cause=`` links). Called at decision
        frequency — rung transitions, spawns, migrations — never
        per-frame."""
        with self._lock:
            seq = self._next_seq
            idx = (seq - 1) % self._cap
            self._s_ts[idx] = self._clock()
            self._s_actor[idx] = actor
            self._s_action[idx] = action
            self._s_subj[idx] = subject
            self._s_trigger[idx] = trigger
            self._s_cause[idx] = cause
            self._next_seq = seq + 1
            evicted = seq > self._cap
        self._c_events.labels(actor, action).inc()
        if evicted:
            self._c_evicted.labels().inc()
        else:
            self._g_retained.set(float(seq))
        return seq

    # -- reads ---------------------------------------------------------------

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._next_seq

    def _oldest_locked(self) -> int:
        """Oldest retained seq (1 until the ring first wraps)."""
        return max(1, self._next_seq - self._cap)

    def _event_locked(self, seq: int) -> Optional[dict]:
        if not (self._oldest_locked() <= seq < self._next_seq):
            return None
        idx = (seq - 1) % self._cap
        return {
            "seq": seq,
            "ts": self._s_ts[idx],
            "actor": self._s_actor[idx],
            "action": self._s_action[idx],
            "subject": self._s_subj[idx],
            "trigger": self._s_trigger[idx],
            "cause": self._s_cause[idx],
        }

    def event(self, seq: int) -> Optional[dict]:
        """The event for ``seq``, or None when unknown or evicted."""
        with self._lock:
            return self._event_locked(seq)

    def events(self, *, subject: Optional[Subject] = None,
               subject_kind: Optional[str] = None,
               actor: Optional[str] = None,
               action: Optional[str] = None,
               since: Optional[int] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Retained events oldest→newest, filtered. ``since`` is a seq
        (exclusive — the REST cursor idiom: pass the last seq you saw);
        ``limit`` keeps the newest N after filtering."""
        with self._lock:
            lo = self._oldest_locked()
            if since is not None:
                lo = max(lo, int(since) + 1)
            out = []
            for seq in range(lo, self._next_seq):
                ev = self._event_locked(seq)
                if ev is None:
                    continue
                if actor is not None and ev["actor"] != actor:
                    continue
                if action is not None and ev["action"] != action:
                    continue
                if subject is not None and ev["subject"] != tuple(subject):
                    continue
                if subject_kind is not None and (
                        ev["subject"] is None
                        or ev["subject"][0] != subject_kind):
                    continue
                out.append(ev)
        if limit is not None and limit > 0:
            out = out[-int(limit):]
        return out

    def window(self, t0: float, t1: float) -> List[dict]:
        """Events with ``t0 <= ts <= t1`` — the prof-bundle overlap
        embed (obs/prof.py writes the journal window next to spans)."""
        with self._lock:
            return [ev for seq in range(self._oldest_locked(),
                                        self._next_seq)
                    for ev in (self._event_locked(seq),)
                    if ev is not None and t0 <= ev["ts"] <= t1]

    def latest_seq(self, *, actor: Optional[str] = None,
                   action: Optional[str] = None,
                   subject: Optional[Subject] = None) -> Optional[int]:
        """Newest retained seq matching the filters (backward scan) —
        the cause-resolution helper decision sites call to link their
        action to the observation that provoked it."""
        with self._lock:
            for seq in range(self._next_seq - 1,
                             self._oldest_locked() - 1, -1):
                ev = self._event_locked(seq)
                if ev is None:
                    continue
                if actor is not None and ev["actor"] != actor:
                    continue
                if action is not None and ev["action"] != action:
                    continue
                if subject is not None and ev["subject"] != tuple(subject):
                    continue
                return seq
        return None

    # -- why() ---------------------------------------------------------------

    def why(self, kind: str, ident: str, *, max_links: int = 8) -> dict:
        """The causal chain behind a subject's current state: find the
        subject's newest event, walk ``cause`` links backward, return
        root-first with human-readable lines. An evicted cause becomes
        a re-rooted ``(evicted)`` marker — chains never dangle."""
        subject = (str(kind), str(ident))
        chain: List[dict] = []
        evicted_root = False
        with self._lock:
            cur: Optional[int] = None
            for seq in range(self._next_seq - 1,
                             self._oldest_locked() - 1, -1):
                ev = self._event_locked(seq)
                if ev is not None and ev["subject"] == subject:
                    cur = seq
                    break
            while cur is not None and len(chain) < max_links:
                ev = self._event_locked(cur)
                if ev is None:          # cause fell off the ring
                    evicted_root = True
                    break
                chain.append(ev)
                cur = ev["cause"]
        chain.reverse()
        text = [format_event(ev) for ev in chain]
        if evicted_root:
            text.insert(0, "(root evicted from journal ring)")
        return {
            "subject": {"kind": subject[0], "id": subject[1]},
            "found": bool(chain),
            "links": len(chain),
            "evicted_root": evicted_root,
            "chain": chain,
            "text": text,
        }

    # -- snapshot ------------------------------------------------------------

    def snapshot(self, *, tail: int = 0) -> dict:
        """JSON-able accounting for ``stats()["obs"]["journal"]`` and
        artifacts: counts per actor/action plus (opt-in) the newest
        ``tail`` events."""
        with self._lock:
            oldest = self._oldest_locked()
            by_actor: Dict[str, int] = {}
            by_action: Dict[str, int] = {}
            for seq in range(oldest, self._next_seq):
                idx = (seq - 1) % self._cap
                actor = self._s_actor[idx]
                by_actor[actor] = by_actor.get(actor, 0) + 1
                key = f"{actor}.{self._s_action[idx]}"
                by_action[key] = by_action.get(key, 0) + 1
            out = {
                "capacity": self._cap,
                "next_seq": self._next_seq,
                "oldest_seq": oldest,
                "recorded": self._next_seq - 1,
                "retained": self._next_seq - oldest,
                "evicted": max(0, self._next_seq - 1 - self._cap),
                "by_actor": by_actor,
                "by_action": by_action,
            }
            if tail > 0:
                out["tail"] = [
                    self._event_locked(seq)
                    for seq in range(max(oldest, self._next_seq - tail),
                                     self._next_seq)]
        return out


def merge_journals(members: Dict[str, List[dict]]) -> List[dict]:
    """The fleet merge: events from ``{member_name: [event dicts]}``, each
    tagged with its member and ordered by ``(ts, member, seq)``. Per-member
    seqs are monotone, so ties on wall time fall to a stable member+seq
    order and the merge does not depend on scrape arrival order."""
    out: List[dict] = []
    for name, events in members.items():
        for ev in events or []:
            tagged = dict(ev)
            tagged["member"] = name
            out.append(tagged)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("member", ""), e.get("seq", 0)))
    return out
