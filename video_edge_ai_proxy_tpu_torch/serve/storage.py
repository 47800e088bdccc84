"""Embedded KV store with prefix namespaces.

Capability parity with the reference's BadgerDB wrapper
(``server/services/storage.go:27-90``): Get/Put/Del/List over a prefix-keyed
embedded store, surviving server restarts (the camera registry resumes from it,
``rtsp_process_manager.go:137-148,191-233``). Backed by sqlite3 (stdlib) in
WAL mode — the idiomatic embedded store available in this image.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional


class NotFound(KeyError):
    """Reference ``ErrProcessNotFoundDatastore`` analogue
    (``server/services/errors.go``)."""


class Storage:
    def __init__(self, path: str):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "prefix TEXT NOT NULL, key TEXT NOT NULL, value BLOB NOT NULL,"
                "PRIMARY KEY (prefix, key))"
            )
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.commit()

    def put(self, prefix: str, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (prefix, key, value) VALUES (?,?,?) "
                "ON CONFLICT(prefix, key) DO UPDATE SET value=excluded.value",
                (prefix, key, value),
            )
            self._conn.commit()

    def get(self, prefix: str, key: str) -> bytes:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE prefix=? AND key=?", (prefix, key)
            ).fetchone()
        if row is None:
            raise NotFound(f"{prefix}{key}")
        return row[0]

    def get_or_none(self, prefix: str, key: str) -> Optional[bytes]:
        try:
            return self.get(prefix, key)
        except NotFound:
            return None

    def delete(self, prefix: str, key: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM kv WHERE prefix=? AND key=?", (prefix, key)
            )
            self._conn.commit()

    def list(self, prefix: str) -> dict[str, bytes]:
        """All key->value pairs under a prefix (reference prefix scan,
        ``storage.go:66-90``)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE prefix=?", (prefix,)
            ).fetchall()
        return {k: v for k, v in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
