"""Device-resident per-track clip ring of the temporal cascade (counterpart
of ``video_edge_ai_proxy_tpu/temporal/state_pool.py``, its one-device pool).

One uint8 tensor ``[slots, clip_len, side, side, 3]`` on the device holds
every live track's last ``clip_len`` crop tiles as a ring; the slot map
(track key -> row), the free list and the per-row write cursors and fill
counts live on the host. So the only host-device traffic is the new tiles
and two small int32 index vectors per scatter (the ``vep_h2d_*`` aux
bytes): clip contents never come back to the host; the head reads them
through a device-side gather.

Row 0 stays zero: padded slots of a head batch gather it, never stale track
state. Capacity grows by ``_GROW`` rows: a new tensor and a copy of the old
rows (the JAX package pads functionally; here the old tensor is freed, so
nothing may keep its address: the gather runs eagerly, outside any CUDA
graph, and a graphed head copies the gathered clips into its own static
input). A reused row needs no zeroing: ``gather`` is only asked for rows
whose fill count reached ``clip_len``, by when the new track has
overwritten every position.

Host index vectors and tiles cross through pinned memory asynchronously on
the caller's stream (the engine's compute stream), so a scatter does not
wait for the steps queued before it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


class TrackStatePool:
    """Per-track device clip ring with host-side slot bookkeeping."""

    _GROW = 8

    __slots__ = ("side", "clip_len", "device", "_slots", "_free", "_cursor", "_fill", "_pool",
                 "_capacity", "_high")

    def __init__(self, side: int, clip_len: int, device: "str | torch.device" = "cuda"):
        self.side = int(side)
        self.clip_len = int(clip_len)
        self.device = resolve_device(device)
        self._slots: Dict[str, int] = {}      # track key -> row (>= 1)
        self._free: List[int] = []
        self._cursor: Dict[int, int] = {}     # row -> next write position
        self._fill: Dict[int, int] = {}       # row -> frames written (<= T)
        self._pool: Optional[torch.Tensor] = None   # [cap, T, side, side, 3] uint8
        self._capacity = 0
        self._high = 0                        # highest row ever assigned

    # -- the dict protocol (the engine's stream GC reads it) ------------------

    def __bool__(self) -> bool:
        return bool(self._slots)

    def __len__(self) -> int:
        return len(self._slots)

    def __iter__(self):
        return iter(self._slots)

    def __contains__(self, key: str) -> bool:
        return key in self._slots

    def pop(self, key: str, default=None):
        """Release a track's row to the free list."""
        row = self._slots.pop(key, None)
        if row is None:
            return default
        self._free.append(row)
        self._cursor.pop(row, None)
        self._fill.pop(row, None)
        return row

    # -- occupancy ----------------------------------------------------------------

    @property
    def high_water(self) -> int:
        """Highest row ever assigned: stays bounded across track churn,
        since freed rows are reused."""
        return self._high

    def slots_in_use(self) -> int:
        return len(self._slots)

    @property
    def array(self) -> Optional[torch.Tensor]:
        """The live device tensor (None before the first scatter); exposed
        for the no-read-back check, never for host reads."""
        return self._pool

    def full(self, key: str) -> bool:
        """True once the track holds a complete ``clip_len``-frame clip."""
        row = self._slots.get(key)
        return row is not None and self._fill.get(row, 0) >= self.clip_len

    def nbytes(self) -> int:
        """Device bytes the ring holds now (its capacity, not its live
        rows), 0 before the first scatter: the ``obs/hbm.py`` pool
        protocol. Metadata only: no copy, no synchronisation."""
        return int(self._pool.nbytes) if self._pool is not None else 0

    # -- the device ring -----------------------------------------------------------

    def _ensure(self, rows: int) -> None:
        need = rows + 1
        if self._pool is None:
            cap = ((max(need, 2) + self._GROW - 1) // self._GROW) * self._GROW
            self._pool = torch.zeros((cap, self.clip_len, self.side, self.side, 3),
                                     dtype=torch.uint8, device=self.device)
            self._capacity = cap
        elif need > self._capacity:
            grow = ((need - self._capacity + self._GROW - 1) // self._GROW) * self._GROW
            grown = torch.zeros((self._capacity + grow,) + tuple(self._pool.shape[1:]),
                                dtype=torch.uint8, device=self.device)
            grown[:self._capacity] = self._pool
            self._pool = grown
            self._capacity += grow

    def _row_for(self, key: str) -> int:
        row = self._slots.get(key)
        if row is None:
            row = self._free.pop() if self._free else self._high + 1
            self._high = max(self._high, row)
            self._slots[key] = row
            self._cursor[row] = 0
            self._fill[row] = 0
        return row

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cuda":
            # Pinned and asynchronous: a pageable copy would wait for the
            # whole stream.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def scatter(self, keys: Sequence[str], tiles: np.ndarray,
                bucket: Optional[int] = None) -> int:
        """Append one tile per track to its ring.

        ``tiles``: uint8 [n, side, side, 3] host tiles, one per key (keys
        unique). With ``bucket`` the index vectors and the tile batch are
        padded to that length by repeating the last entry: a second write
        of identical data to the same cell. ``index_put_`` without
        accumulation leaves unspecified which of two writes to one cell
        lands, and both carry the same bytes, so the result is exact.
        Returns the bytes of the two int32 index vectors (the caller adds
        the tiles' for the H2D accounting)."""
        rows = [self._row_for(k) for k in keys]
        self._ensure(max(rows))
        pos = [self._cursor[r] for r in rows]
        if bucket is not None and bucket > len(rows):
            pad = bucket - len(rows)
            rows_v = rows + [rows[-1]] * pad
            pos_v = pos + [pos[-1]] * pad
            tiles = np.concatenate([tiles, np.repeat(tiles[-1:], pad, axis=0)], axis=0)
        else:
            rows_v, pos_v = rows, pos
        rows_np = np.asarray(rows_v, np.int32)
        pos_np = np.asarray(pos_v, np.int32)
        self._pool.index_put_((self._to_device(rows_np), self._to_device(pos_np)),
                              self._to_device(tiles), accumulate=False)
        for r in rows:
            self._cursor[r] = (self._cursor[r] + 1) % self.clip_len
            self._fill[r] = min(self._fill[r] + 1, self.clip_len)
        return int(rows_np.nbytes + pos_np.nbytes)

    def gather_indices(self, keys: Sequence[str], bucket: int) -> Tuple[np.ndarray, np.ndarray]:
        """The host plan of a time-ordered gather: ``(slot_idx [bucket],
        time_idx [bucket, T])`` int32. ``time_idx[i]`` unrolls track i's
        ring oldest first (the cursor points at the next overwrite, the
        oldest frame of a full ring); padded slots index row 0."""
        t = self.clip_len
        slot_idx = np.zeros((bucket,), np.int32)
        time_idx = np.zeros((bucket, t), np.int32)
        base = np.arange(t, dtype=np.int32)
        for i, key in enumerate(keys[:bucket]):
            row = self._slots.get(key)
            if row is None:
                continue
            slot_idx[i] = row
            time_idx[i] = (self._cursor.get(row, 0) + base) % t
        return slot_idx, time_idx

    def gather(self, slot_idx: np.ndarray, time_idx: np.ndarray) -> torch.Tensor:
        """Time-ordered clips [bucket, T, side, side, 3] uint8, a new device
        tensor (one advanced-indexing gather): the pool never touches the
        host."""
        slots = self._to_device(np.asarray(slot_idx, np.int32))
        times = self._to_device(np.asarray(time_idx, np.int32))
        return self._pool[slots[:, None], times]
