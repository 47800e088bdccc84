"""The native shared-memory ring and control KV (``vepbus.cpp``), built at first use."""

from .build import build_library

__all__ = ["build_library"]
