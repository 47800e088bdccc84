"""Batch placement over a mesh of device slots (counterpart of the data-
parallel part of ``video_edge_ai_proxy_tpu/parallel/sharding.py``).

A dp-sharded batch of ``B`` rows lives as one segment a slot: slot ``s``
holds rows ``[s * B / dp, (s + 1) * B / dp)`` on its own device, the
layout the collector's shard-segmented groups are built in
(``engine/collector.py``). ``shard_put`` places a host batch so, one copy a
slot; ``assemble_sharded`` takes the per-slot segments back into one
host-order array. ``replicated`` names the placement of the weights: a
copy on every distinct device of the mesh, shared by the slots of one
device. The logical-axis rules, ``param_shardings`` and ``place_params``
(tp/fsdp/ep placement) wait for the slice that brings the collectives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh


class BatchSharding:
    """The leading (batch) axis split over the mesh's ``dp`` slots, every
    other axis whole (JAX's ``NamedSharding(mesh, P("dp", None, ...))``)."""

    def __init__(self, mesh: Mesh, ndim: int, batch_axes=("dp",)):
        if tuple(batch_axes) != ("dp",):
            raise NotImplementedError(f"batch axes {tuple(batch_axes)}: only ('dp',) is served")
        self.mesh = mesh
        self.ndim = int(ndim)

    @property
    def shards(self) -> int:
        return self.mesh.shape["dp"]

    def segments(self, rows: int) -> List[slice]:
        """The row range of each slot, in slot order."""
        if rows % self.shards:
            raise ValueError(f"{rows} rows do not split over dp={self.shards}")
        seg = rows // self.shards
        return [slice(s * seg, (s + 1) * seg) for s in range(self.shards)]


class Replicated:
    """A whole copy on every distinct device of the mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def devices(self) -> List[torch.device]:
        return self.mesh.distinct_devices()


def batch_sharding(mesh: Mesh, ndim: int, batch_axes=("dp",)) -> BatchSharding:
    """Shard the leading (batch) dim over ``batch_axes``, the rest whole."""
    return BatchSharding(mesh, ndim, batch_axes)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_put(frames, sharding: BatchSharding,
              streams: Optional[Dict[torch.device, "torch.cuda.Stream"]] = None
              ) -> List[torch.Tensor]:
    """A host batch -> one device tensor a slot, slot ``s`` holding its
    segment of rows on its own device. A segment of a C-contiguous host
    array is itself contiguous, so each is one flat copy. On a card the
    copies are asynchronous from pinned memory, each on ``streams[device]``
    (default: the device's current stream); the caller records what it
    waits on. On the CPU each segment is a copy."""
    host = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(frames)
    pieces = []
    for slot, rows in zip(sharding.mesh.slots, sharding.segments(int(host.shape[0]))):
        part = host[rows]
        if slot.device.type != "cuda":
            pieces.append(part.clone())
            continue
        stream = (streams or {}).get(slot.device) or torch.cuda.current_stream(slot.device)
        with torch.cuda.device(slot.device), torch.cuda.stream(stream):
            placed = torch.empty(part.shape, dtype=part.dtype, device=slot.device)
            placed.copy_(part, non_blocking=host.is_pinned())
        pieces.append(placed)
    return pieces


def assemble_sharded(pieces: Sequence, shape: tuple, sharding: BatchSharding) -> np.ndarray:
    """Per-slot segments -> one host array of ``shape`` in row order: the
    slots' pieces (device tensors, read back, or host arrays) stacked in
    slot order. Each piece must hold ``shape[0] / dp`` rows."""
    segs = sharding.segments(int(shape[0]))
    if len(pieces) != len(segs):
        raise ValueError(f"{len(pieces)} pieces for {len(segs)} slots")
    parts = []
    for piece, rows in zip(pieces, segs):
        arr = piece.cpu().numpy() if isinstance(piece, torch.Tensor) else np.asarray(piece)
        if arr.shape[0] != rows.stop - rows.start or tuple(arr.shape[1:]) != tuple(shape[1:]):
            raise ValueError(f"piece of shape {arr.shape} does not fill rows {rows} of {shape}")
        parts.append(arr)
    return np.concatenate(parts, axis=0)
