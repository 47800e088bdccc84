"""Deterministic replay of a trace through the serving pipeline's stages
(counterpart of ``video_edge_ai_proxy_tpu/replay/harness.py``
``lockstep_checksum``; the fleet soaks, the router and the autoscale
harnesses are later slices)."""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from ..bus.interface import FrameBus
from ..bus.memory_bus import MemoryFrameBus
from ..device import resolve_device
from ..engine.collector import Collector
from ..engine.runner import build_serving_step
from ..models import registry
from .checksum import finalize_checksum, fold_checksum, zero_class_prior
from .player import TracePlayer


def lockstep_checksum(
    trace_path: str, *, model: str = "tiny_yolov8", device: "str | torch.device" = "cuda",
    generator: Optional[torch.Generator] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.bfloat16, preprocess_dtype: torch.dtype = torch.bfloat16,
    device_id: Optional[str] = None, limit: int = 0,
    perturb: Optional[Callable[[dict], dict]] = None, zero_prior: bool = True,
    on_batch: Optional[Callable] = None, bus: Optional[FrameBus] = None,
) -> dict:
    """Replay a trace deterministically through bus -> collector -> serving
    step and fold the content checksum over every batch's outputs.

    Frames go through the real stages (publish, cursors, pooled-buffer
    assembly, bucket padding), one publish per collect, so latest-wins never
    drops a frame: the fold is exact, and two runs of one trace with the
    same weights are bit-identical. The weights are the registry model's
    from ``generator`` (default seed 0), or ``state_dict``; with
    ``zero_prior`` a detector's class prior is zeroed, then
    ``perturb(state_dict) -> state_dict`` applies (the seeded-fault hook).
    ``on_batch(group, outputs)`` sees every batch as it is served. ``bus``
    (default a fresh ``MemoryFrameBus``, closed at the end) carries the
    frames; a bus passed in (a ``ShmFrameBus`` on an empty ring directory)
    stays open, its owner's to close. The collector is built without
    interest, so every published stream is inferred.

    Returns {"checksum", "frames", "batches", "batch_streams" (streams per
    batch), "model"}."""
    dev = resolve_device(device)
    spec = registry.get(model)
    net = spec.init_params(generator, device=dev, dtype=dtype)
    sd = dict(net.state_dict()) if state_dict is None else dict(state_dict)
    if zero_prior and spec.kind == "detect":
        sd = zero_class_prior(sd)
    if perturb is not None:
        sd = perturb(sd)
    net.load_state_dict(sd, strict=True)
    step = build_serving_step(net, spec, preprocess_dtype=preprocess_dtype)

    player = TracePlayer(trace_path)
    owns_bus = bus is None
    bus = MemoryFrameBus() if owns_bus else bus
    col = Collector(bus, buckets=(1, 2, 4, 8, 16), default_model=spec.name,
                    clip_len=spec.clip_len)
    created: set = set()
    carry = torch.zeros((), dtype=torch.int64, device=dev)
    frames = 0
    batch_streams = []
    try:
        for dev_id, frame, meta in player.iter_frames(device_id):
            if limit and frames >= limit:
                break
            if dev_id not in created:
                bus.create_stream(dev_id, frame.nbytes)
                created.add(dev_id)
            bus.publish(dev_id, frame, meta)
            frames += 1
            for group in col.collect():
                batch_streams.append(len(group.device_ids))
                # A synchronous copy: the pooled buffer is reused next tick.
                outputs = step(torch.from_numpy(group.frames).to(dev))
                carry = fold_checksum(carry, outputs)
                if on_batch is not None:
                    on_batch(group, outputs)
    finally:
        if owns_bus:
            bus.close()
    return {"checksum": finalize_checksum(carry), "frames": frames,
            "batches": len(batch_streams), "batch_streams": batch_streams,
            "model": spec.name}
