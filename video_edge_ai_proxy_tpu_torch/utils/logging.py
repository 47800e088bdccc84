"""Structured logging (counterpart of ``video_edge_ai_proxy_tpu/utils/logging.py``).

One process-wide logger tree under ``vep_tpu`` (the JAX package's names,
so a log pipeline reads the same ``logger`` field from either package),
printing plain lines to stdout, which a supervising process manager
captures (a worker's stdout goes to its log file).

Log correlation: hot-path threads (the engine's per-slot emit, a worker's
publish loop) set a per-thread or per-task context, ``stream=<id>
seq=<packet>``, with :func:`set_log_context` / :func:`log_context`; a
``logging.Filter`` puts it into every record logged while it is set, so a
warning three calls deep still says which frame it was about.
ContextVar-backed: thread-safe and right under asyncio handlers too, and
free for records logged outside any context.

JSON lines: decision sites stamp their records with ``extra={"vep_actor":
..., "vep_subject": "kind:id", "vep_journal_seq": N}``, the identity
their journal event carries. The default tab format ignores those
attributes; ``VEP_TPU_LOG_JSON=1`` (or :func:`enable_json_logs`) swaps the
handler's formatter for :class:`JsonFormatter`, one JSON object per line
with ``actor``/``subject``/``journal_seq`` fields, so a log pipeline can
join log lines to journal events by seq. Off by default.

:class:`ContextFilter` may also sit on a logger of its own (the engine's
``vep.torch.engine.runner``, which propagates to the root logger): its
records then carry ``vep_ctx`` to every handler that sees them.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
from contextvars import ContextVar
from typing import Iterator, Optional

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(vep_ctx)s%(message)s"
_configured = False

_LOG_CTX: ContextVar[str] = ContextVar("vep_log_ctx", default="")


def set_log_context(stream: Optional[str] = None, seq: Optional[int] = None):
    """Arm the correlation fields for records logged by this thread or task
    until :func:`reset_log_context` is called with the returned token."""
    parts = []
    if stream is not None:
        parts.append(f"stream={stream}")
    if seq is not None:
        parts.append(f"seq={seq}")
    return _LOG_CTX.set("[" + " ".join(parts) + "]\t" if parts else "")


def reset_log_context(token) -> None:
    _LOG_CTX.reset(token)


@contextlib.contextmanager
def log_context(stream: Optional[str] = None, seq: Optional[int] = None) -> Iterator[None]:
    token = set_log_context(stream=stream, seq=seq)
    try:
        yield
    finally:
        reset_log_context(token)


class ContextFilter(logging.Filter):
    """Puts ``vep_ctx`` into every record (the empty string outside any
    context), so the one format string works for all records."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.vep_ctx = _LOG_CTX.get()
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line with the decision sites' journal attributes
    (``vep_actor``/``vep_subject``/``vep_journal_seq``, stamped through
    ``extra=``) and the per-thread stream/seq context. Keys sorted."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        ctx = getattr(record, "vep_ctx", "")
        if ctx:
            out["ctx"] = ctx.strip("[]\t ")
        for attr, key in (("vep_actor", "actor"), ("vep_subject", "subject"),
                          ("vep_journal_seq", "journal_seq")):
            val = getattr(record, attr, None)
            if val is not None:
                out[key] = val
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, sort_keys=True, default=str)


_handler: "logging.Handler | None" = None


def _json_mode() -> bool:
    return os.environ.get("VEP_TPU_LOG_JSON", "").lower() in ("1", "true", "yes", "on")


def enable_json_logs(enable: bool = True) -> None:
    """Swap the process handler's formatter to or from JSON at run time
    (as booting with ``VEP_TPU_LOG_JSON=1`` does)."""
    _configure()
    if _handler is not None:
        _handler.setFormatter(JsonFormatter() if enable else logging.Formatter(_FORMAT))


def _configure() -> None:
    global _configured, _handler
    if _configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(JsonFormatter() if _json_mode() else logging.Formatter(_FORMAT))
    handler.addFilter(ContextFilter())
    root = logging.getLogger("vep_tpu")
    root.addHandler(handler)
    root.setLevel(os.environ.get("VEP_TPU_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _handler = handler
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"vep_tpu.{name}")
