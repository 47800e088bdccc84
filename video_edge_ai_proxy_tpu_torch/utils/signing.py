"""Edge-to-cloud request signing.

Wire parity with the reference's signed HTTPS scheme
(``server/services/edge_service.go:39-49``): the request body's MD5 hex digest
plus a millisecond timestamp are HMAC-SHA256-signed with the edge secret, and
shipped in the headers ``X-ChrysEdge-Auth`` (``<edge_key>:<mac>``),
``X-Chrys-Date`` and ``Content-MD5``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from typing import Any


def sign_request(
    body: Any,
    edge_key: str,
    edge_secret: str,
    *,
    now_ms: int | None = None,
) -> tuple[bytes, dict[str, str]]:
    """Return (payload_bytes, headers) for a signed cloud API call.

    The signed string is ``str(now_ms) + md5hex(payload)`` — the same
    concatenation the reference builds at ``edge_service.go:42-44``. Note the
    default timestamp is ``Unix()*1000`` — epoch *seconds* scaled to ms —
    deliberately matching the reference's wire behavior
    (``strconv.FormatInt(time.Now().Unix()*1000, 10)``), which a validating
    cloud side may rely on.
    """
    if isinstance(body, (bytes, bytearray)):
        payload = bytes(body)
    else:
        payload = json.dumps(body, separators=(",", ":")).encode("utf-8")
    content_md5 = hashlib.md5(payload).hexdigest()
    ts = str(now_ms if now_ms is not None else int(time.time()) * 1000)
    mac = hmac.new(
        edge_secret.encode("utf-8"),
        (ts + content_md5).encode("utf-8"),
        hashlib.sha256,
    ).hexdigest()
    headers = {
        "X-ChrysEdge-Auth": f"{edge_key}:{mac}",
        "X-Chrys-Date": ts,
        "Content-MD5": content_md5,
        "Content-Type": "application/json",
    }
    return payload, headers


def verify_signature(
    payload: bytes,
    headers: dict[str, str],
    edge_secret: str,
    *,
    max_skew_ms: int | None = None,
) -> bool:
    """Verify a signature produced by :func:`sign_request` (used in tests and
    by the fake cloud endpoint; the reference cloud side is closed-source)."""
    try:
        auth = headers["X-ChrysEdge-Auth"]
        ts = headers["X-Chrys-Date"]
        _, mac = auth.split(":", 1)
    except (KeyError, ValueError):
        return False
    content_md5 = hashlib.md5(payload).hexdigest()
    if headers.get("Content-MD5") != content_md5:
        return False
    expect = hmac.new(
        edge_secret.encode("utf-8"),
        (ts + content_md5).encode("utf-8"),
        hashlib.sha256,
    ).hexdigest()
    if not hmac.compare_digest(mac, expect):
        return False
    if max_skew_ms is not None:
        if abs(int(time.time() * 1000) - int(ts)) > max_skew_ms:
            return False
    return True
