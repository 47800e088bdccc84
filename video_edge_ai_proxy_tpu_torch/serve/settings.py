"""Settings manager (reference ``server/services/settings_manager.go:28-118``):
cached edge key/secret behind a RW-ish lock, persisted in Storage under the
settings prefix, with a default record created on first access."""

from __future__ import annotations

import threading
from typing import Optional

from .models import PREFIX_SETTINGS, SETTINGS_DEFAULT_KEY, Settings
from .storage import NotFound, Storage


class SettingsManager:
    def __init__(self, storage: Storage):
        self._storage = storage
        self._lock = threading.Lock()
        self._cached: Optional[Settings] = None

    def get(self) -> Settings:
        with self._lock:
            if self._cached is not None:
                return self._cached
        try:
            raw = self._storage.get(PREFIX_SETTINGS, SETTINGS_DEFAULT_KEY)
            settings = Settings.from_json(raw)
        except NotFound:
            # First boot: persist an empty default record
            # (settings_manager.go:94-118).
            import time

            settings = Settings(created=int(time.time() * 1000))
            self._storage.put(
                PREFIX_SETTINGS, SETTINGS_DEFAULT_KEY, settings.to_json()
            )
        with self._lock:
            self._cached = settings
        return settings

    def overwrite(self, edge_key: str, edge_secret: str) -> Settings:
        import time

        now = int(time.time() * 1000)
        current = self.get()
        updated = Settings(
            edge_key=edge_key,
            edge_secret=edge_secret,
            created=current.created or now,
            modified=now,
        )
        self._storage.put(PREFIX_SETTINGS, SETTINGS_DEFAULT_KEY, updated.to_json())
        with self._lock:
            self._cached = updated
        return updated

    def edge_credentials(self) -> tuple[str, str]:
        """Reference ``GetCurrentEdgeKeyAndSecret`` (settings_manager.go:42-57)."""
        s = self.get()
        return s.edge_key, s.edge_secret
