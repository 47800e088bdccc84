"""Capacity smoke of the PyTorch/CUDA port (the port's
``tools/capacity_smoke.py``): the capacity attribution plane end to end,
with JAX's gates. Three parts, one JSON line (``--out`` also writes it):

A. **Mixed-workload ledger soak**: one hand-stepped engine (collect ->
   ROI transform -> dispatch -> drain and emit -> cascade tick) serving
   blob-gauge streams with ROI packing, the temporal cascade and the
   classic full path live at once, so the ledger sees every attribution
   kind (the full slot split, the ROI canvas-area share, the 1/N-cadence
   cascade head). Gates: the conservation invariant balances, every
   published stream is in the ledger, all three kinds attribute, headroom
   in [0, 1], the ledger tap under 1% of the 10 ms tick budget (wall-timed
   against the step's measured device time).
B. **Deterministic ramp forecast**: a fake-clock ``CapacityTracker`` under
   a linear ramp. Gates: ``time_to_saturation_s`` falls monotonically once
   established; headroom never negative.
C. **Headroom-aware admission storm**: a scripted-fleet ``StreamRouter``
   admitting 24 new streams. Gates: every admission on the highest-
   headroom member, none on the saturation-forecast member, equal-headroom
   ties and the unscored hash fallback deterministic across fresh routers.

Part A runs on the card (``--device cuda``, the default: ``blob_gauge``
at ``--size`` 1920x1080 with ``videomae_b``'s head, the scene scaled from
JAX's 64x64) or on the CPU (``--device cpu``: JAX's scene, ``tiny_blob_gauge``
at 64x64 with ``tiny_videomae``). B and C are host-only.

Usage:
  python tools/torch_capacity_smoke.py --device cpu --size 64x64
  python tools/torch_capacity_smoke.py --device cuda --size 1920x1080
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STORM = 24          # part C's admission storm
HORIZON_S = 60.0    # the router's saturation-exclusion horizon under test
TICKS = 64          # part A's hand-stepped ticks
# Part A's scene on JAX's 64x64 grid: (blob key, [x0, y0, x1, y1]).
SCENE = {"camA": (1, [20, 20, 36, 34]), "camB": (2, [8, 40, 24, 56]),
         "camC": (4, [44, 8, 60, 24])}


def part_a(device: str = "cuda", size: tuple = (1920, 1080), *, model: str = "",
           cascade_model: str = "") -> dict:
    """Mixed full/ROI/cascade soak on a hand-stepped engine. ``size``: (w, h)
    of the frames; the scene's boxes scale from JAX's 64x64."""
    import queue as _queue

    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.models.blob import blob_color
    from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    cuda = device == "cuda"
    w, h = size
    small = max(w, h) <= 64
    model = model or ("blob_gauge" if cuda else "tiny_blob_gauge")
    cascade_model = cascade_model or ("videomae_b" if cuda else "tiny_videomae")
    N = 4
    bus = MemoryFrameBus()
    try:
        eng = InferenceEngine(
            bus,
            EngineConfig(
                model=model, batch_buckets=(1, 2, 4, 8), tick_ms=10, prefetch=False,
                prof=False, track=True, roi=True,
                # JAX's 64x64 scene packs onto one 64 canvas with 8 px
                # crops; a 1080p scene uses the engine's defaults.
                **({"roi_canvas": 64, "roi_min_crop": 8} if small else {}),
                roi_full_interval_ms=600_000,
                cascade=True, cascade_model=cascade_model, cascade_every_n=N,
                cascade_track_ttl_ticks=8, capacity=True),
            device=device, annotations=AnnotationQueue(handler=lambda batch: True))
        eng.warmup()
        cap = eng.capacity
        if cap is None:
            raise RuntimeError("capacity plane failed to arm")
        # Wall-time the attribution tap itself against the tick budget.
        note_wall = [0.0, 0]
        orig_note = cap.note_batch

        def timed_note(*a, **k):
            t = time.perf_counter()
            orig_note(*a, **k)
            note_wall[0] += time.perf_counter() - t
            note_wall[1] += 1

        cap.note_batch = timed_note
        eng._drain_q = _queue.Queue(maxsize=8)
        results_q: _queue.Queue = _queue.Queue()
        with eng._sub_lock:
            eng._subscribers.append((results_q, None))
        # camA is pinned to the full path (its gate's full_at reset each
        # tick), so its blob stays tracked on full frames and the cascade
        # harvests it; camB/camC are static and ride the ROI canvas after
        # their first full pass.
        sx, sy = w / 64.0, h / 64.0
        streams = {name: (key, [int(box[0] * sx), int(box[1] * sy), int(box[2] * sx),
                                int(box[3] * sy)])
                   for name, (key, box) in SCENE.items()}
        for name in streams:
            bus.create_stream(name, w * h * 3)

        def frame(key, box, bg=114):
            f = np.full((h, w, 3), bg, np.uint8)
            x0, y0, x1, y1 = box
            f[y0:y1, x0:x1] = blob_color(key)
            return f

        frames = {name: {bg: frame(key, box, bg) for bg in (78, 114, 150)}
                  for name, (key, box) in streams.items()}
        last_ts = 0
        t0 = time.perf_counter()
        for tick in range(1, TICKS + 1):
            ts = max(int(time.time() * 1000), last_ts + 1)
            last_ts = ts
            for name in streams:
                bg = 114
                if name == "camA":
                    bg = 150 if tick % 2 == 0 else 78
                bus.publish(name, frames[name][bg], FrameMeta(
                    width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True))
            eng._roi.state("camA")["full_at"] = 0.0   # pin the full verdict
            with eng._compute_stream(), torch.inference_mode():
                groups = eng._collector.collect()
                if groups:
                    groups = eng._roi_transform(groups)
                eng._dispatch(groups, time.time(), strict=True)
                while True:
                    try:
                        inflight = eng._drain_q.get_nowait()
                    except _queue.Empty:
                        break
                    try:
                        eng._emit(inflight)
                    finally:
                        eng._collector.release(inflight.group)
                        eng._drain_q.task_done()
                eng._cascade_tick()
            while True:
                try:
                    results_q.get_nowait()
                except _queue.Empty:
                    break
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        cap.evaluate(force=True)
        snap = cap.snapshot()
    finally:
        bus.close()
    kinds = sorted({k for row in snap["streams"].values() for k in row["by_kind"]})
    tap_mean_ms = note_wall[0] * 1000.0 / max(note_wall[1], 1)
    return {
        "device": device, "model": model, "cascade_model": cascade_model, "size": [w, h],
        "ticks": TICKS,
        "wall_s": round(wall_s, 3),
        "streams": sorted(snap["streams"]),
        "kinds": kinds,
        "by_stream": {s: {k: round(v, 4) for k, v in row["by_kind"].items()}
                      for s, row in sorted(snap["streams"].items())},
        "conservation": snap["conservation"],
        "headroom": snap["headroom"],
        "utilization_fast": snap["utilization"]["fast"],
        "cells": sorted(snap["cells"]),
        "ledger_taps": note_wall[1],
        "ledger_tap_mean_us": round(tap_mean_ms * 1000.0, 2),
        # Against the 10 ms tick budget a real step fills.
        "ledger_tap_pct_of_tick_budget": round(tap_mean_ms / snap["tick_ms"] * 100.0, 4),
    }


def part_b() -> dict:
    """Fake-clock ramp: the forecast falls monotonically once established."""
    from video_edge_ai_proxy_tpu_torch.obs.capacity import CapacityTracker
    from video_edge_ai_proxy_tpu_torch.obs.metrics import Registry

    clock = types.SimpleNamespace(now=0.0)
    cap = CapacityTracker(fast_window_s=60.0, slow_window_s=1800.0, util_objective=0.8,
                          eval_interval_s=0.0, clock=lambda: clock.now, registry=Registry())
    series = []
    headrooms = []
    for t in range(1, 171):
        clock.now = float(t)
        # Linear ramp: 5*t busy ms a simulated second.
        cap.note_batch("ramp", (64, 64), 4, 5.0 * t, [f"s{t % 4}"], now=clock.now)
        state = cap.evaluate(now=clock.now, force=True)
        headrooms.append(state["headroom"])
        if t >= 80:                       # the forecast is established
            series.append((t, state["time_to_saturation_s"]))
    return {
        "ramp_ms_per_s": "5*t",
        "samples": len(series),
        "tts_first_s": series[0][1],
        "tts_last_s": series[-1][1],
        "tts_series_defined": all(v is not None for _, v in series),
        "tts_monotone_decreasing": all(
            b[1] is not None and a[1] is not None and b[1] < a[1] + 1e-9
            for a, b in zip(series, series[1:])),
        "min_headroom": min(headrooms),
        "final_utilization_fast": cap.evaluate(now=clock.now, force=True)["utilization"]["fast"],
    }


def _make_router(rows):
    """A scripted-fleet StreamRouter: no sockets, breakers closed, fixed
    health rows."""
    from video_edge_ai_proxy_tpu_torch.serve.router import StreamRouter

    names = [r["instance"] for r in rows]
    fleet = types.SimpleNamespace(
        _members=[types.SimpleNamespace(name=n, base_url=f"http://{n}") for n in names],
        rows={r["instance"]: r for r in rows},
        scrape_once=lambda: None,
        health=lambda: [dict(r) for r in rows])
    started = {n: [] for n in names}

    def factory(name, url):
        return types.SimpleNamespace(
            name=name, breaker=types.SimpleNamespace(state="closed"),
            start_stream=lambda s, u, m="", p="", _n=name: started[_n].append(s),
            stop_stream=lambda s: None, attach_router=lambda r, u="": {},
            detach_router=lambda: None, stream_frames=lambda s: 0)

    clock = types.SimpleNamespace(now=0.0)
    router = StreamRouter([f"{n}=http://{n}" for n in names], fleet=fleet,
                          client_factory=factory, clock=lambda: clock.now,
                          sleep=lambda s: None, admit_saturation_horizon_s=HORIZON_S)
    router.run_pass()
    return router, started


def _row(name, headroom, tts, ema=0.9):
    return {"instance": name, "up": True, "stale": False, "healthy": True,
            "score": ema, "score_ema": ema, "healthy_since_s": 100.0,
            "ladder_rung": 0.0, "slo_burning": False, "streams": 0,
            "capacity": True, "headroom": headroom,
            "capacity_utilization": 1.0 - headroom if headroom is not None else None,
            "time_to_saturation_s": tts}


def part_c() -> dict:
    """Admission storm against scripted capacity headroom."""
    # m0 idle, m1 forecast to saturate inside the horizon, m2 mid-load.
    rows = [_row("m0", 0.90, None), _row("m1", 0.15, 25.0), _row("m2", 0.55, 400.0)]
    router, started = _make_router(rows)
    placements = [router.admit(f"storm{i}", f"rtsp://storm{i}") for i in range(STORM)]
    storm_by_member = {n: len(s) for n, s in started.items()}

    # Equal-headroom tie: two fresh routers place alike (lexical tie-break).
    def tie_rows():
        return [_row("m0", 0.70, None), _row("m1", 0.15, 25.0), _row("m2", 0.70, None)]

    tie_a, _ = _make_router(tie_rows())
    tie_b, _ = _make_router(tie_rows())
    ties_a = [tie_a.admit(f"tie{i}", f"rtsp://tie{i}") for i in range(8)]
    ties_b = [tie_b.admit(f"tie{i}", f"rtsp://tie{i}") for i in range(8)]

    # Unscored fallback: no capacity, no score_ema -> the consistent hash.
    def unscored_rows():
        rows = [_row(n, None, None, ema=None) for n in ("m0", "m1", "m2")]
        for r in rows:
            r.update(capacity=False, capacity_utilization=None, score=0.0)
        return rows

    hash_a, _ = _make_router(unscored_rows())
    hash_b, _ = _make_router(unscored_rows())
    hashed_a = [hash_a.admit(f"h{i}", f"rtsp://h{i}") for i in range(8)]
    hashed_b = [hash_b.admit(f"h{i}", f"rtsp://h{i}") for i in range(8)]
    return {
        "storm_size": STORM,
        "storm_by_member": storm_by_member,
        "storm_all_on_highest_headroom": set(placements) == {"m0"},
        "saturating_member_admissions": storm_by_member["m1"],
        "tie_placements": ties_a,
        "tie_deterministic": ties_a == ties_b,
        "tie_winner": ties_a[0] if ties_a else None,
        "hash_fallback_deterministic": hashed_a == hashed_b,
        "hash_fallback_spread": sorted(set(hashed_a)),
    }


GATES = {
    "conservation_balanced": True,
    "kinds_cover": ["cascade", "full", "roi"],
    "headroom_range": [0.0, 1.0],
    "ledger_tap_pct_of_tick_budget_max": 1.0,
    "tts_monotone_decreasing": True,
    "saturating_member_admissions_max": 0,
    "tie_and_hash_deterministic": True,
}


def capacity_failures(part_a: dict, part_b: dict, part_c: dict) -> list:
    """JAX's ``CAPACITY_r01.json`` gates over the three parts."""
    failures = []
    cons = part_a["conservation"]
    if not cons["balanced"]:
        failures.append(f"ledger does not conserve: {cons}")
    if part_a["streams"] != sorted(SCENE):
        failures.append(f"ledger stream coverage {part_a['streams']}")
    missing = {"full", "roi", "cascade"} - set(part_a["kinds"])
    if missing:
        failures.append(f"attribution kinds missing {sorted(missing)} (saw {part_a['kinds']})")
    if not 0.0 <= part_a["headroom"] <= 1.0:
        failures.append(f"headroom {part_a['headroom']} outside [0,1]")
    if part_a["ledger_tap_pct_of_tick_budget"] >= 1.0:
        failures.append(f"ledger tap costs {part_a['ledger_tap_pct_of_tick_budget']}% of the "
                        "tick budget (gate: <1%)")
    if not part_b["tts_series_defined"]:
        failures.append("forecast never established under ramped load")
    if not part_b["tts_monotone_decreasing"]:
        failures.append(f"time_to_saturation_s not monotone under a linear ramp "
                        f"({part_b['tts_first_s']} -> {part_b['tts_last_s']})")
    if part_b["min_headroom"] < 0.0:
        failures.append(f"negative headroom {part_b['min_headroom']}")
    if not part_c["storm_all_on_highest_headroom"]:
        failures.append(f"storm admissions left the highest-headroom member: "
                        f"{part_c['storm_by_member']}")
    if part_c["saturating_member_admissions"] != 0:
        failures.append(f"{part_c['saturating_member_admissions']} admissions on the "
                        "saturation-forecast member (expected 0)")
    if not part_c["tie_deterministic"] or part_c["tie_winner"] != "m0":
        failures.append(f"equal-headroom tie not deterministic-lexical: "
                        f"{part_c['tie_placements']}")
    if not part_c["hash_fallback_deterministic"]:
        failures.append("unscored hash fallback not deterministic")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="part A's engine's device")
    ap.add_argument("--size", default="",
                    help="part A's frames, WxH (default: 1920x1080 on cuda, 64x64 on cpu)")
    ap.add_argument("--out", default="", help="also write the artifact JSON here")
    args = ap.parse_args(argv)
    size = args.size or ("1920x1080" if args.device == "cuda" else "64x64")
    try:
        w, h = (int(v) for v in size.lower().split("x"))
    except ValueError:
        ap.error(f"--size must be WxH, got {size!r}")
    t0 = time.monotonic()
    a = part_a(args.device, (w, h))
    b = part_b()
    c = part_c()
    out = {"tool": "torch_capacity_smoke", "backend": args.device,
           "wall_s": round(time.monotonic() - t0, 2), "ledger": a, "forecast": b,
           "admission": c, "gates": GATES}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    failures = capacity_failures(a, b, c)
    if failures:
        raise SystemExit("capacity_smoke: " + "; ".join(failures))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
