"""URL / key parsing helpers (reference: ``server/utils/parser_utils.go:10-25``)."""

from __future__ import annotations

import hashlib
from urllib.parse import urlparse


def parse_rtmp_key(rtmp_url: str) -> str:
    """Extract the stream key (last path segment) from an RTMP URL.

    Mirrors ``ParseRTMPKey`` (``server/utils/parser_utils.go:10-25``): the
    scheme must be ``rtmp`` and the key is the final ``/``-separated path
    segment. Raises ``ValueError`` on anything else.
    """
    u = urlparse(rtmp_url)
    if u.scheme != "rtmp":
        raise ValueError(f"not an rtmp url: {rtmp_url!r}")
    segments = u.path.split("/")
    if not segments or not segments[-1]:
        raise ValueError(f"failed to parse RTMP key from {rtmp_url!r}")
    return segments[-1]


def default_device_id(rtsp_url: str) -> str:
    """Default camera name = MD5 hex of the RTSP URL, as the REST handler does
    when no name is given (``server/api/rtsp_process.go:52-55``)."""
    return hashlib.md5(rtsp_url.encode("utf-8")).hexdigest()
