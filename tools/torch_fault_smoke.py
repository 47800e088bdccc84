"""Device-fault smoke of the port, the twin of ``tools/fault_smoke.py``: a
mesh slot fails under live serving, and the engine detects it, fails over
to the survivor mesh, keeps the other slots' stream pins and conserves
every frame outside the declared fault window (``engine/fault.py``,
``InferenceEngine._execute_failover``).

The mesh is ``--slots`` slots of ``--device`` (on one card, slots of
``cuda:0``). Two chaos legs, scripted as ``shard_fault`` events of a
``replay.faults.FaultPlan`` (the plan rides in the output) and injected by
``replay.faults.ShardFaultInjector``, the JAX tool's plan:

1. **Hard fault, dp4 -> dp3 (gated).** 8 streams serve on a dp=4 mesh; at
   the scripted time slot 1's step raises an error carrying
   ``fault_shard``. Gates: detection within 2 ticks of the raise, the
   failover within ``fault_failover_budget_ms``, the dead slot's streams
   serving again on survivors within ``--evac-bound`` seconds, the
   surviving slots keeping >= 90% of their stream pins, and after the
   engine stops the FaultLedger balanced to zero frames lost or
   duplicated, every ``device_fault`` drop inside a declared window.
2. **Stall on a survivor, dp3 -> dp2 (informational).** The dispatch
   deadline drops so the drain watchdog's hysteresis opens a stall
   suspicion on real batches, and the probe's verdict names one slot (a
   slot of a healthy card cannot be made to wedge): the repin composes
   across cascaded faults, and the stall walks suspicion -> probe ->
   failover.

Also gated: ``vep_fault_*`` lint-clean, and every failover journaled with
its trigger. Printed: each failover's ms, the share of it spent
recapturing the survivor mesh's programs, the evacuated streams' first
results after it, and the keep-mask launches, slot sub-batches and build
launches of the window from the first fault to the end, read at rest at
both ends.

On the CPU (``--device cpu``) the fleet is ``tiny_blob_gauge`` at its input
size on the JAX tool's colour-keyed scene; on the card ``yolov8n`` at
1080x1920 on the synthetic pattern (``--model``, ``--hw``). One JSON line
on stdout in the JAX tool's shape; ``--out`` also writes it to a file.

    python tools/torch_fault_smoke.py --device cpu --slots 4
    python tools/torch_fault_smoke.py --device cuda --slots 4
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

STREAMS = ["cam0", "cam1", "cam2", "cam3", "cam4", "cam5", "cam6", "cam7"]
HARD_SHARD = 1      # dp4 numbering
STALL_SHARD = 1     # dp3 numbering (after failover 1)


def _multichip_tool():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_multichip_serve_smoke

    return torch_multichip_serve_smoke


def _frames(model: str, hw: tuple):
    """``frame(i, step)`` of stream i: the blob scene for a gauge (its
    colour keys), else a pool of the synthetic pattern's frames."""
    if "blob_gauge" in model:
        scene = _multichip_tool().BlobScene(hw[0], hw[1], range(len(STREAMS)))
        return scene.frame
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource

    pool = [SyntheticSource.render(hw[0], hw[1], n) for n in range(16)]
    return lambda i, step: pool[(step + 3 * i) % len(pool)]


def run(*, device="cuda", slots: int = 4, model: str = "", hw=None, prime_s: float = 5.0,
        settle_s: float = 5.0, evac_bound_s: float = 5.0, torch_threads: int = 0) -> dict:
    """Both legs; the JAX tool's JSON document (plus the port's fields)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.engine.collector import stream_shard
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.obs.metrics import lint_exposition
    from video_edge_ai_proxy_tpu_torch.obs.metrics import registry as metrics_registry
    from video_edge_ai_proxy_tpu_torch.replay.faults import (
        FaultEvent, FaultPlan, ShardFaultInjector,
    )
    from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    if torch_threads:
        torch.set_num_threads(torch_threads)
    dev = resolve_device(device)
    backend = "cuda" if dev.type == "cuda" else "cpu"
    if slots != 4:
        raise ValueError(f"the plan runs dp4 -> dp3 -> dp2: --slots 4, not {slots}")
    model = model or ("yolov8n" if backend == "cuda" else "tiny_blob_gauge")
    if hw is None:
        side = registry.get(model).input_size
        hw = (1080, 1920) if backend == "cuda" else (side, side)
    h, w = hw
    frame_of = _frames(model, hw)
    plan = FaultPlan([
        FaultEvent(at_s=prime_s, kind="shard_fault", device_id=str(HARD_SHARD)),
        FaultEvent(at_s=prime_s + settle_s, kind="shard_fault", device_id=str(STALL_SHARD),
                   duration_s=1.0),
    ])
    plan_doc = json.loads(plan.to_json())
    tmp = tempfile.mkdtemp(prefix="vep_fault_smoke_")
    bus = MemoryFrameBus()
    eng = InferenceEngine(
        bus,
        EngineConfig(model=model, mesh={"dp": 4}, batch_buckets=(2, 4, 8), tick_ms=10,
                     prof=False, fault=True, fault_dispatch_deadline_ms=5000.0,
                     fault_hysteresis=2, fault_failover_budget_ms=30000.0, aot_cache=True,
                     aot_cache_dir=os.path.join(tmp, "aot")),
        annotations=AnnotationQueue(handler=lambda batch: True), device=dev,
        slots=[dev] * slots)
    eng.warmup()
    for sid in STREAMS:
        bus.create_stream(sid, h * w * 3)
    results_q: queue.Queue = queue.Queue()
    with eng._sub_lock:
        eng._subscribers.append((results_q, None))
    injector = ShardFaultInjector(eng)

    def events(kind):
        return [e for e in eng.faults.snapshot()["events"] if e.get("event") == kind]

    results = []

    def drain():
        while True:
            try:
                r = results_q.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                results.append((time.monotonic(), r))

    window_counts = _multichip_tool().window_counts
    eng.start()
    stall_armed = None
    base = end = None
    try:
        t_start = time.monotonic()
        step = 0
        last_ts = 0
        restore_after = None
        end_at = t_start + prime_s + 2 * settle_s
        while time.monotonic() < end_at:
            now = time.monotonic()
            due = plan.pop_due(now - t_start)
            if due and base is None:
                # The window opens after the prime, before the first fault.
                base = window_counts(eng)
            for ev in due:
                injector.fire(ev)
                if ev.duration_s > 0:
                    stall_armed = now
                    restore_after = len(events("failover")) + 1
            if restore_after is not None and len(events("failover")) >= restore_after:
                # Failover 2 done: the real deadline back before healthy
                # batches keep tripping the watchdog.
                injector.restore()
                restore_after = None
            ts = max(int(time.time() * 1000), last_ts + 1)
            last_ts = ts
            for i, sid in enumerate(STREAMS):
                bus.publish(sid, frame_of(i, step),
                            FrameMeta(width=w, height=h, channels=3, timestamp_ms=ts,
                                      is_keyframe=True))
            step += 1
            time.sleep(0.03)
            drain()
        end = window_counts(eng)
    finally:
        eng.stop()
        drain()
        bus.close()

    snap = eng.faults.snapshot()
    ledger = snap["ledger"]
    fails = events("failover")
    dets = events("detected")
    hard_det = next((e for e in dets if e["kind"] == "xla_error"), None)
    hard_fail = fails[0] if fails else None
    detect_ticks = (hard_det["tick"] - injector.tick
                    if hard_det and injector.tick is not None else None)
    evac_streams = [sid for sid in STREAMS if stream_shard(sid, 4) == HARD_SHARD]
    evac_first_ms = None
    firsts: dict = {}
    if hard_fail is not None and injector.ts is not None:
        t_done = injector.ts + hard_fail["failover_ms"] / 1000.0
        for t_r, r in results:
            if r.device_id in evac_streams and r.device_id not in firsts and t_r >= t_done:
                firsts[r.device_id] = (t_r - t_done) * 1000.0
        if len(firsts) == len(evac_streams):
            evac_first_ms = max(firsts.values())
    pin_retention = None
    if hard_fail is not None:
        st = hard_fail["streams"]
        surviving = st["total"] - st["repinned"]
        pin_retention = st["kept"] / surviving if surviving else None
    stall_det = next((e for e in dets if e["kind"] == "stall"), None)
    stall_fail = fails[1] if len(fails) > 1 else None
    compose_ok = None
    if stall_fail is not None:
        compose_ok = all(0 <= eng._shard_of(sid) % eng._shards < eng._shards for sid in STREAMS)
    problems = [p for p in lint_exposition(metrics_registry.render()) if "vep_fault" in p]
    journal_events = eng.journal.events() if eng.journal is not None else []
    journaled = [ev for ev in journal_events
                 if ev["actor"] == "fault" and ev["action"] == "failover"]
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "tool": "torch_fault_smoke",
        "backend": backend,
        "model": model,
        "devices": slots,
        "src_hw": list(hw),
        "streams": len(STREAMS),
        "plan": plan_doc,
        "hard_fault": {
            "shard": HARD_SHARD,
            "detected": hard_det,
            "detect_ticks": detect_ticks,
            "failover": hard_fail,
            "evacuated_streams": evac_streams,
            "evac_first_result_ms": round(evac_first_ms, 1) if evac_first_ms is not None
            else None,
            "pin_retention": round(pin_retention, 3) if pin_retention is not None else None,
            "evac_firsts_ms": {k: round(v, 1) for k, v in sorted(firsts.items())},
        },
        "stall_fault": {
            "shard": STALL_SHARD,
            "armed_at_s": round(stall_armed - t_start, 3) if stall_armed else None,
            "detected": stall_det,
            "failover": stall_fail,
            "repin_composes": compose_ok,
            "informational": True,
        },
        "ledger": ledger,
        "journal": {"events": journal_events},
        "journal_conservation": {
            "failovers": len(fails),
            "journaled": len(journaled),
            "with_trigger": sum(1 for ev in journaled if ev.get("trigger")),
            "with_cause": sum(1 for ev in journaled if ev.get("cause") is not None),
        },
        "results": len(results),
        "failovers": snap["failovers"],
        "survivor_shards": snap["shards"],
        "slot_batches": eng.pipeline_stats().slot_batches,
        **_multichip_tool().window_fields(base, end),
        "exposition_problems": problems,
        "gates": {
            "detect_ticks_max": 2,
            "failover_budget_ms": eng._cfg.fault_failover_budget_ms,
            "evac_bound_ms": evac_bound_s * 1000.0,
            "pin_retention_min": 0.9,
        },
    }


def failures(out: dict) -> list:
    """The JAX tool's gates (leg 1, the ledger, the exposition, the
    journal) over ``run``'s document: the breaches, [] when all hold."""
    bad = []
    hard = out["hard_fault"]
    det, fo = hard["detected"], hard["failover"]
    gates = out["gates"]
    ledger = out["ledger"]
    if det is None or fo is None:
        return [f"hard slot fault never detected or failed over (detected={det}, "
                f"failover={fo})"]
    if hard["detect_ticks"] is None or hard["detect_ticks"] > gates["detect_ticks_max"]:
        bad.append(f"detection took {hard['detect_ticks']} ticks > {gates['detect_ticks_max']}")
    if fo["over_budget"] or fo["failover_ms"] > gates["failover_budget_ms"]:
        bad.append(f"failover took {fo['failover_ms']:.0f} ms > budget "
                   f"{gates['failover_budget_ms']:.0f} ms")
    if fo["survivors"] != 3 or fo["shards_dead"] != [HARD_SHARD]:
        bad.append(f"wrong failover shape: {fo}")
    evac = hard["evac_first_result_ms"]
    if evac is None or evac > gates["evac_bound_ms"]:
        bad.append(f"evacuated streams not serving within {gates['evac_bound_ms']:.0f} ms of "
                   f"the failover (worst {evac} ms, firsts {hard['evac_firsts_ms']})")
    if hard["pin_retention"] is None or hard["pin_retention"] < gates["pin_retention_min"]:
        bad.append(f"surviving slots kept only {hard['pin_retention']} of their pins")
    if ledger["lost"] != 0:
        bad.append(f"{ledger['lost']} frames lost after the engine stopped: {ledger}")
    if ledger["duplicated"] != 0:
        bad.append(f"{ledger['duplicated']} duplicate emissions across the failover")
    if ledger["lost_outside_window"] != 0:
        bad.append(f"{ledger['lost_outside_window']} frames lost outside the declared "
                   f"fault window")
    if not ledger["dropped"].get("device_fault"):
        bad.append("no device_fault drops recorded: the fault window never exercised the "
                   "ledger")
    if out["exposition_problems"]:
        bad.append(f"vep_fault_* exposition not lint-clean: {out['exposition_problems']}")
    jc = out["journal_conservation"]
    if jc["journaled"] < jc["failovers"] or jc["with_trigger"] < jc["journaled"]:
        bad.append(f"journal conservation broken: every failover needs a journal event "
                   f"with a trigger: {jc}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=4, help="mesh slots of the device (4)")
    ap.add_argument("--model", default="", help="yolov8n (card) / tiny_blob_gauge (CPU)")
    ap.add_argument("--hw", default="", help="frame HxW (default 1080x1920 on the card, the "
                                             "model's input size on the CPU)")
    ap.add_argument("--prime", type=float, default=5.0,
                    help="seconds of healthy serving before the fault (default 5)")
    ap.add_argument("--settle", type=float, default=5.0,
                    help="seconds of survivor-mesh serving after each failover (default 5)")
    ap.add_argument("--evac-bound", type=float, default=5.0,
                    help="gated seconds from the failover to the dead slot's streams "
                         "serving again (default 5)")
    ap.add_argument("--torch-threads", type=int, default=0)
    ap.add_argument("--out", default="", help="also write the JSON document here")
    args = ap.parse_args(argv)
    hw = tuple(int(v) for v in args.hw.split("x")) if args.hw else None
    out = run(device=args.device, slots=args.slots, model=args.model, hw=hw,
              prime_s=args.prime, settle_s=args.settle, evac_bound_s=args.evac_bound,
              torch_threads=args.torch_threads)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
            fh.write("\n")
    bad = failures(out)
    if bad:
        raise SystemExit("torch_fault_smoke: " + "; ".join(bad))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
