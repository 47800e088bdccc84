"""Mesh serving smoke of the port, the twin of ``tools/multichip_serve_smoke.py``:
the data-parallel engine serves a real fleet (collector -> per-slot H2D ->
each slot's step -> emit) with ROI packing, the temporal cascade, the
quality thumbnails and the capacity ledger on, and going to more slots
changes the capacity curve, not the answers.

The mesh is ``--slots`` slots of ``--device`` (two or more slots may share
one card: each steps its own rows on its own stream). Two legs, the JAX
tool's:

1. **Lockstep parity.** The synthetic 240-frame trace (``det0``, ``det1``
   at 128x96) through ``replay.harness.lockstep_checksum`` on one device
   and through a dp=1 mesh of the same device: the two folds must be
   bit-identical (the mesh changes placement, never numerics); the port's
   committed golden, when there is one, is checked too. ``--frames 0``
   skips it.
2. **The replay fleet.** Three serves over the colour-keyed all-mover blob
   fleet (``models/blob.py``: every detection's class id names its owner
   stream; ``BlobScene``) at dp=1 (2 streams), dp=2 (4) and dp=4 (8): 2
   streams a slot by the collector's crc32 placement, buckets (2, 4, 8).

Gates, exit non-zero on a breach (the JAX tool's):

- the dp=1 mesh fold equals the single-device fold;
- at every dp at least 20 matched detections, zero misrouted (a detection
  with another stream's colour key) and zero unrouted canvas detections;
- capacity conservation: aggregate and per-slot ``rel_drift`` == 0.0;
- at dp > 1 the cascade head ran on the mesh (a ``cascade/`` model in the
  perf buckets) and per-slot perf attribution is present for every slot;
- ``vep_perf_shard_*`` and ``vep_capacity_shard_*`` lint-clean;
- aggregate results/s at dp=4 >= ``--min-scale`` x dp=1 (weak scaling),
  gated only when every slot is a device of its own: slots sharing one
  card share its compute, and the ratio is printed, not gated.

Each serve leg also reports its window's keep-mask launches, slot
sub-batches and build launches, read at rest at both ends
(``window_counts``), and each misrouted detection whether it lies on its
own stream's blob (``on_own_blob``).

On the CPU (``--device cpu``) the fleet is ``tiny_blob_gauge`` at its input
size; on the card ``blob_gauge`` at 1080x1920 (``--hw``). One JSON line on
stdout in the JAX tool's shape; ``--out`` also writes it to a file.

    python tools/torch_multichip_serve_smoke.py --device cpu --slots 4
    python tools/torch_multichip_serve_smoke.py --device cuda --slots 4
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Streams whose crc32 placement (engine/collector.py stream_shard) spreads
# exactly 2 a slot at each dp (the JAX tool's constants).
STREAMS_BY_DP = {
    1: ["cam0", "cam4"],
    2: ["cam0", "cam1", "cam4", "cam5"],
    4: ["cam0", "cam1", "cam2", "cam3", "cam4", "cam5", "cam6", "cam7"],
}


class BlobScene:
    """Each stream's frames: one blob of its owner's colour key moving
    along x in a triangle wave. ``background="key"`` (the default) paints
    it on the key's red with a dark green (114, 40, red), as phase 16 of
    ``chip_smoke.py`` paints its movers: where the letterbox's resize
    blends the blob's edge into the background, the red stays the key's
    and the green falls below the gauge's test, so no blend reads as
    another key. ``"gray"`` is the JAX tool's scene (114 gray), on which
    a resized frame's blended edges can read as a key between the owner's
    and gray's (``rect`` lets a reader tell such an edge box from another
    stream's blob). One scratch frame a stream, repainted in place (the
    bus copies on publish)."""

    def __init__(self, h: int, w: int, owners, background: str = "key"):
        import numpy as np

        from video_edge_ai_proxy_tpu_torch.models.blob import blob_color

        if background not in ("key", "gray"):
            raise ValueError(f"background {background!r}: key or gray")
        self.h, self.w = h, w
        self.bw, self.bh = max(8, w // 6), max(8, h // 8)
        self.span = w - self.bw - 16
        self.speed = max(1, w // 64)
        self.y_step = max(4, h // 16)
        self._color = {o: np.asarray(blob_color(o), np.uint8) for o in owners}
        self._bg = {o: np.asarray((114, 40, blob_color(o)[2]) if background == "key"
                                  else (114, 114, 114), np.uint8) for o in owners}
        self._frame = {}
        for o in owners:
            self._frame[o] = np.empty((h, w, 3), np.uint8)
            self._frame[o][:] = self._bg[o]
        self._rect = {}

    def frame(self, owner: int, step: int):
        buf = self._frame[owner]
        old = self._rect.get(owner)
        if old is not None:
            y0, y1, x0, x1 = old
            buf[y0:y1, x0:x1] = self._bg[owner]
        phase = (step * self.speed) % (2 * self.span)
        x0 = 8 + (phase if phase < self.span else 2 * self.span - phase)
        y0 = min(8 + self.y_step * owner, self.h - self.bh - 1)
        buf[y0:y0 + self.bh, x0:x0 + self.bw] = self._color[owner]
        self._rect[owner] = (y0, y0 + self.bh, x0, x0 + self.bw)
        return buf

    def rect(self, owner: int) -> tuple:
        """(y0, y1, x0, x1) of the owner's blob in its last frame."""
        return self._rect[owner]


def on_own_blob(box: tuple, rect: tuple, margin: float, coasted: bool = False) -> bool:
    """Whether a detection box (left, top, width, height, frame px) lies
    inside its own stream's blob ``rect`` (y0, y1, x0, x1) grown by
    ``margin`` px: an edge of the stream's own blob, not another stream's
    blob (whose row, ``y_step`` px a key apart, lies outside). A coasted
    result (ROI's idle gate: the tracker's boxes of an earlier frame) is
    held to the blob's row alone, since the blob has moved along x."""
    left, top, width, height = box
    y0, y1, x0, x1 = rect
    in_row = top >= y0 - margin and top + height <= y1 + margin
    return in_row and (coasted or (left >= x0 - margin and left + width <= x1 + margin))


def window_counts(eng) -> tuple:
    """(keep-mask launches, slot sub-batches, keep-mask launches of program
    builds) read between two of the engine's ticks, with every dispatched
    batch emitted (``InferenceEngine.at_rest``): over a window, launches =
    slot sub-batches + build launches when each slot's step launches the
    keep mask once (0 on the CPU, where its plain version runs)."""
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    def read():
        pipe = eng.pipeline_stats()
        return (nms_keep_mask_cuda.launches, pipe.slot_batches,
                pipe.build_launches.get(nms_keep_mask_cuda.__name__, 0))

    return eng.at_rest(read)


def window_fields(base: tuple, end: tuple) -> dict:
    """A window's counts from ``window_counts`` at its start and end."""
    if base is None or end is None:
        return {"keep_mask_launches_window": None, "slot_batches_window": None,
                "build_launches_window": None}
    return {"keep_mask_launches_window": end[0] - base[0],
            "slot_batches_window": end[1] - base[1],
            "build_launches_window": end[2] - base[2]}


def serve_leg(dp: int, *, model: str, hw: tuple, device, slots: int, prime_s: float,
              duration_s: float, cascade_model: str, tick_ms: int = 10,
              background: str = "key") -> dict:
    """One serve of the fleet on a dp mesh of ``slots`` slots of ``device``
    (the first dp used): prime, then the measured window, its counts read
    at rest at both ends (``window_counts``)."""
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.collector import stream_shard
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    streams = STREAMS_BY_DP[dp]
    owners = {sid: int(sid[3:]) for sid in streams}
    for sid in streams:   # placement really is 2 a slot
        assert len([s for s in streams if stream_shard(s, dp) == stream_shard(sid, dp)]) \
            == len(streams) // dp
    h, w = hw
    side = registry.get(model).input_size
    scene = BlobScene(h, w, owners.values(), background)
    margin = max(4, 4 * -(-max(h, w) // side))   # 4 px of the model's input
    bus = MemoryFrameBus()
    try:
        eng = InferenceEngine(
            bus,
            EngineConfig(model=model, mesh={"dp": dp}, batch_buckets=(2, 4, 8),
                         tick_ms=tick_ms, prof=False, roi=True, roi_canvas=side,
                         roi_min_crop=max(8, side // 8), roi_full_interval_ms=500,
                         cascade=True, cascade_model=cascade_model, capacity=True),
            annotations=AnnotationQueue(handler=lambda batch: True), device=device,
            slots=[device] * slots)
        eng.warmup()
        for sid in streams:
            bus.create_stream(sid, h * w * 3)
        results_q: queue.Queue = queue.Queue()
        with eng._sub_lock:
            eng._subscribers.append((results_q, None))
        truth = {}
        results = []
        published = 0
        window_start_ts = None
        eng.start()
        base = end = None
        try:
            step = 0
            last_ts = 0
            t_end_prime = time.monotonic() + prime_s
            deadline = None
            while True:
                now = time.monotonic()
                if deadline is None and now >= t_end_prime:
                    deadline = now + duration_s
                    window_start_ts = last_ts + 1
                    base = window_counts(eng)
                if deadline is not None and now >= deadline:
                    end = window_counts(eng)
                    break
                ts = max(int(time.time() * 1000), last_ts + 1)
                last_ts = ts
                for sid in streams:
                    frame = scene.frame(owners[sid], step)
                    truth[(sid, ts)] = (owners[sid], scene.rect(owners[sid]))
                    bus.publish(sid, frame, FrameMeta(width=w, height=h, channels=3,
                                                      timestamp_ms=ts, is_keyframe=True))
                    if deadline is not None:
                        published += 1
                step += 1
                time.sleep(0.03)
                while True:
                    try:
                        results.append(results_q.get_nowait())
                    except queue.Empty:
                        break
        finally:
            eng.stop()
        while True:
            try:
                results.append(results_q.get_nowait())
            except queue.Empty:
                break
        snap = eng.perf.snapshot()
        conserve = eng.capacity.conservation()
        pipe = eng.pipeline_stats()
    finally:
        bus.close()

    results = [r for r in results if r is not None]
    misrouted = on_own = matched = measured = 0
    examples = []
    for r in results:
        if (r.device_id, r.timestamp) not in truth:
            continue
        owner, rect = truth[(r.device_id, r.timestamp)]
        if window_start_ts is not None and r.timestamp >= window_start_ts:
            measured += 1
        for d in r.detections:
            if d.class_id != owner:
                misrouted += 1
                box = (d.box.left, d.box.top, d.box.width, d.box.height)
                own = on_own_blob(box, rect, margin, coasted=r.batch_size == 0)
                on_own += own
                if len(examples) < 10:
                    examples.append({"stream": r.device_id, "owner": owner,
                                     "class_id": d.class_id, "box": list(box),
                                     "blob_yyxx": list(rect), "on_own_blob": own,
                                     "confidence": round(d.confidence, 3),
                                     "batch_size": r.batch_size,
                                     "latency_ms": round(r.latency_ms, 1)})
            else:
                matched += 1
    roi = snap.get("roi") or {}
    return {
        "dp": dp,
        "streams": len(streams),
        "results": len(results),
        "matched_detections": matched,
        "misrouted": misrouted,
        "misrouted_on_own_blob": on_own,
        "own_blob_margin_px": margin,
        "misrouted_examples": examples,
        "unrouted": roi.get("unrouted", 0),
        "fps": round(measured / duration_s, 1) if duration_s else None,
        "published_in_window": published,
        "device_frames": sum(b["frames"] for b in snap["buckets"]),
        "cascade_models": sorted({b["model"] for b in snap["buckets"]
                                  if b["model"].startswith("cascade/")}),
        "cascade_head_batches": (snap.get("cascade") or {}).get("head_batches", 0),
        "perf_shard_frames": {s["shard"]: s["frames"] for s in snap.get("shards", ())
                              if not s["model"].startswith("cascade/")},
        "roi": {k: roi.get(k) for k in ("crops", "canvases", "unrouted")},
        "conservation": conserve,
        "slot_batches": pipe.slot_batches,
        **window_fields(base, end),
        "batches": pipe.batches,
    }


def lockstep_leg(device, frames: int, backend: str) -> dict:
    """Leg 1: the synthetic trace on one device and through a dp=1 mesh
    (``frames`` 0: the leg is skipped, and the document's ``lockstep`` is
    None)."""
    from video_edge_ai_proxy_tpu_torch.parallel import make_mesh
    from video_edge_ai_proxy_tpu_torch.replay.checksum import check_golden
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

    with tempfile.TemporaryDirectory(prefix="vep_mesh_smoke_") as tmp:
        path = record_synthetic_trace(os.path.join(tmp, "trace.bin"), ["det0", "det1"],
                                      width=128, height=96, fps=30.0, gop=30, frames=frames)
        single = lockstep_checksum(path, model="tiny_yolov8", device=device)
        mesh1 = lockstep_checksum(path, model="tiny_yolov8", device=device,
                                  mesh=make_mesh(devices=[device]))
    golden = check_golden(f"soak:lockstep:tiny_yolov8:{backend}:{frames}f",
                          single["checksum"], tool="torch_multichip_serve_smoke")
    return {"frames": frames, "golden": golden, "single_device": single["checksum"],
            "mesh_dp1": mesh1["checksum"],
            "bit_identical": mesh1["checksum"] == single["checksum"]}


def run(*, device="cuda", slots: int = 4, duration_s: float = 8.0, prime_s: float = 6.0,
        frames: int = 240, model: str = "", hw=None, cascade_model: str = "tiny_videomae",
        min_scale: float = 3.2, torch_threads: int = 0, background: str = "key") -> dict:
    """Both legs (``frames`` 0: the serve legs alone); the JAX tool's JSON
    document (plus the port's slot fields)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.obs.metrics import lint_exposition
    from video_edge_ai_proxy_tpu_torch.obs.metrics import registry as metrics_registry

    if torch_threads:
        torch.set_num_threads(torch_threads)
    dev = resolve_device(device)
    backend = "cuda" if dev.type == "cuda" else "cpu"
    if slots < 4:
        raise ValueError(f"the dp=4 leg needs 4 slots, have {slots}")
    model = model or ("blob_gauge" if backend == "cuda" else "tiny_blob_gauge")
    if hw is None:
        side = registry.get(model).input_size
        hw = (1080, 1920) if backend == "cuda" else (side, side)
    lock = lockstep_leg(dev, frames, backend) if frames else None
    legs = {dp: serve_leg(dp, model=model, hw=tuple(hw), device=dev, slots=slots,
                          prime_s=prime_s, duration_s=duration_s, cascade_model=cascade_model,
                          background=background)
            for dp in (1, 2, 4)}
    text = metrics_registry.render()
    problems = [p for p in lint_exposition(text)
                if "vep_perf_shard" in p or "vep_capacity_shard" in p]
    scale = None
    if legs[1]["fps"] and legs[4]["fps"]:
        scale = round(legs[4]["fps"] / legs[1]["fps"], 2)
    return {
        "tool": "torch_multichip_serve_smoke",
        "backend": backend,
        "model": model,
        "devices": slots,
        "distinct_devices": 1,
        "src_hw": list(hw),
        "background": background,
        "duration_s": duration_s,
        "prime_s": prime_s,
        "lockstep": lock,
        "serve": {f"dp{dp}": leg for dp, leg in legs.items()},
        "fps_scale_dp4_over_dp1": scale,
        "exposition_problems": problems,
        "gates": {"min_scale": min_scale, "scale_gated": False},
    }


def failures(out: dict) -> list:
    """The JAX tool's gates over ``run``'s document: the breaches, [] when
    every gate holds. The weak-scaling gate holds only where every slot is
    a device of its own (``gates.scale_gated``)."""
    bad = []
    lock = out["lockstep"]
    if lock is not None and not lock["bit_identical"]:
        bad.append(f"dp=1 mesh lockstep fold {lock['mesh_dp1']} != single-device "
                   f"{lock['single_device']}: the mesh H2D path changed serving numerics")
    for name, leg in out["serve"].items():
        dp = leg["dp"]
        if leg["matched_detections"] < 20:
            bad.append(f"dp={dp} only {leg['matched_detections']} matched detections: the "
                       f"serve never reached steady state")
        if leg["misrouted"] or leg["unrouted"]:
            bad.append(f"dp={dp} misrouted={leg['misrouted']} unrouted={leg['unrouted']}: ROI "
                       f"scatter-back crossed a slot boundary")
        cons = leg["conservation"]
        if cons is None or cons["rel_drift"] != 0.0:
            bad.append(f"dp={dp} aggregate conservation drift {cons and cons['rel_drift']} "
                       f"!= 0.0")
        if dp > 1:
            shards = (cons or {}).get("shards") or {}
            if len(shards) != dp:
                bad.append(f"dp={dp} capacity ledger has {sorted(shards)} slot rows, want {dp}")
            for s, rec in shards.items():
                if rec["rel_drift"] != 0.0:
                    bad.append(f"dp={dp} slot {s} conservation drift {rec['rel_drift']} != 0.0")
            if not leg["cascade_models"] or not leg["cascade_head_batches"]:
                bad.append(f"dp={dp} cascade head never ran on the mesh: "
                           f"{leg['cascade_models']} ({leg['cascade_head_batches']} head batches)")
            if len(leg["perf_shard_frames"]) != dp or any(
                    v <= 0 for v in leg["perf_shard_frames"].values()):
                bad.append(f"dp={dp} per-slot perf attribution incomplete: "
                           f"{leg['perf_shard_frames']}")
    if out["exposition_problems"]:
        bad.append(f"per-slot exposition not lint-clean: {out['exposition_problems']}")
    gates = out["gates"]
    if gates["scale_gated"] and (out["fps_scale_dp4_over_dp1"] is None
                                 or out["fps_scale_dp4_over_dp1"] < gates["min_scale"]):
        bad.append(f"fps scale dp4/dp1 {out['fps_scale_dp4_over_dp1']} < {gates['min_scale']}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=4,
                    help="mesh slots of the device (default 4: the dp=4 leg's)")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="measured seconds a serve leg (default 8)")
    ap.add_argument("--prime", type=float, default=6.0,
                    help="seconds of serving before the window, so captures and the "
                         "cascade's clip fill land outside it (default 6)")
    ap.add_argument("--frames", type=int, default=240,
                    help="lockstep trace length (240; 0 skips the lockstep leg)")
    ap.add_argument("--model", default="", help="blob_gauge (card) / tiny_blob_gauge (CPU)")
    ap.add_argument("--hw", default="", help="frame HxW (default 1080x1920 on the card, the "
                                             "model's input size on the CPU)")
    ap.add_argument("--cascade-model", default="tiny_videomae")
    ap.add_argument("--background", default="key", choices=("key", "gray"),
                    help="the scene's background: the key's red (default) or the JAX "
                         "tool's gray, on which resized blob edges may read as other keys")
    ap.add_argument("--min-scale", type=float, default=3.2,
                    help="required fps(dp=4) / fps(dp=1) where every slot is a device of its "
                         "own (default 3.2)")
    ap.add_argument("--torch-threads", type=int, default=0)
    ap.add_argument("--out", default="", help="also write the JSON document here")
    args = ap.parse_args(argv)
    hw = tuple(int(v) for v in args.hw.split("x")) if args.hw else None
    out = run(device=args.device, slots=args.slots, duration_s=args.duration,
              prime_s=args.prime, frames=args.frames, model=args.model, hw=hw,
              cascade_model=args.cascade_model, min_scale=args.min_scale,
              torch_threads=args.torch_threads, background=args.background)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
            fh.write("\n")
    bad = failures(out)
    if bad:
        raise SystemExit("torch_multichip_serve_smoke: " + "; ".join(bad))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
