"""Build of the native ring-and-KV library at first use (see utils/cbuild.py)."""

from __future__ import annotations

import os

from ...utils.cbuild import build_library as _build

_SRC = os.path.join(os.path.dirname(__file__), "vepbus.cpp")


def build_library() -> str:
    """The path of the compiled libvepbus, built if needed. Raises
    RuntimeError (with the compiler's output) when the build fails."""
    return _build(_SRC, "vepbus")
