"""Replay-driven determinism, chaos soak and end-to-end latency of the
PyTorch/CUDA port (the port's ``tools/soak_replay.py``).

Three legs, written into one artifact:

1. **Determinism**: record a synthetic two-camera trace and replay it twice
   through ``lockstep_checksum`` (bus -> collector -> serving step); the
   two content checksums must be identical.
2. **Chaos soak** (``--duration``): the mixed fleet (6 detect + 5 embed +
   5 classify streams) on one engine with per-stream models, replay-driven
   cameras under a scripted ``FaultPlan`` (the default churn: camera kill
   and re-add, a frame gap, a bus stall, a slow subscriber). Gated: no
   result crosses model families, the annotation uplink conserved and
   drained, subscriber drops within the frame budget.
3. **E2E** (``--e2e``, on by default): a ``Server`` with a ``replay://``
   worker subprocess on the shm bus, the engine and the gRPC ``Inference``
   stream, timed publish -> client-receive.

``--faults`` replaces the churn plan by the resilience kinds (uplink_down,
bus_flap, device_stall) and/or arms the quality kinds (black_frame,
frozen_frame, score_drift): every quality fault must be detected within
5 s with no false-positive verdict, and the canary must open an episode
exactly when score_drift was injected. ``--profile-on-burn`` arms the
triggered torch.profiler captures and requires an intact bundle when
faults fired.

``--fleet N`` replaces the three legs with the fleet-telemetry leg
(``run_fleet_obs``): N member servers in processes of their own (each a
replay worker -> shm bus -> engine -> gRPC/REST pipeline; on the card they
share it) under one ``FleetAggregator``, gated as the JAX tool gates it: a
lint-clean merged page and member pages, every member present, at least
one stitched trace (worker -> bus -> engine -> client under one trace id),
merged counters equal to the members' sums, a valid fleet timeline.

The engines run on the card (``--device cuda``, the default: ``yolov8n``,
``resnet50`` and ``vit_b16``) or on the CPU (``--device cpu``: their tiny
twins, the same serving families).

Usage:
  python tools/torch_soak_replay.py --device cpu --duration 20 --no-e2e
  python tools/torch_soak_replay.py --device cpu --duration 20 --no-e2e \\
      --faults uplink_down,bus_flap,device_stall
  python tools/torch_soak_replay.py --device cuda --size 1920x1080 --duration 20
  python tools/torch_soak_replay.py --device cpu --fleet 2 --fleet-out FLEETOBS_torch.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fleet_failures(fleet: dict) -> list:
    """The fleet-telemetry leg's gates (JAX's ``FLEETOBS_r01.json`` six)."""
    gates = fleet["gates"]
    failures = []
    if not gates["merged_lint_clean"]:
        failures.append(f"merged exposition lint: {fleet['lint_errors']}")
    if not gates["member_lint_clean"]:
        failures.append("a member /metrics page failed lint")
    if not gates["all_members_present"]:
        failures.append(f"member missing/stale at quiesce: {fleet['health']}")
    if not gates["stitched_traces"]:
        failures.append("no fully-stitched cross-process trace (worker -> bus -> engine -> "
                        "client)")
    if not gates["counters_conserved"]:
        failures.append(f"merged counters != member sums: {fleet['counter_mismatches']}")
    if not gates["fleet_trace_valid"]:
        failures.append(f"merged fleet timeline invalid: {fleet['trace_problems']}")
    return failures


def quality_failures(quality: dict, quality_kinds, latency_bound_s: float) -> list:
    """The quality gates: every injected quality fault detected within
    ``latency_bound_s``, no verdict outside every fault window, and a canary
    episode exactly when score_drift was injected."""
    failures = []
    for rep in quality["faults"]:
        if not rep["detected"]:
            failures.append(f"injected {rep['kind']} on {rep['device_id'] or '<global>'} at "
                            f"{rep['at_s']}s went undetected")
        elif rep["latency_s"] is not None and rep["latency_s"] > latency_bound_s:
            failures.append(f"{rep['kind']} detected {rep['latency_s']}s late (bound "
                            f"{latency_bound_s}s)")
    if quality["false_positives"]:
        failures.append(f"verdict transitions outside every fault window: "
                        f"{quality['false_positives']}")
    drift_armed = "score_drift" in quality_kinds
    episodes = quality["canary_watchdog_episodes"]
    if drift_armed and episodes < 1:
        failures.append("score_drift injected but the canary opened no watchdog episode")
    if not drift_armed and episodes:
        failures.append(f"{episodes} canary_integrity episodes without score_drift injected")
    return failures


def chaos_failures(soak: dict, duration_s: float) -> list:
    """The chaos gates: no misrouted result, the uplink conserved and
    drained, subscriber drops within duration x streams x 30."""
    failures = []
    if soak["misrouted_results"]:
        failures.append(f"{soak['misrouted_results']} results crossed model families "
                        f"(examples: {soak['misrouted_examples']})")
    uplink = soak["resilience"]["uplink"]
    if not uplink["conserved"]:
        failures.append(f"annotation conservation broken: published={uplink['published']} != "
                        f"delivered={uplink['delivered_events']} + spool_dropped="
                        f"{uplink['spool']['dropped_events']}")
    if uplink["final_queue_depth"] or uplink["spool"]["pending_batches"]:
        failures.append(f"uplink failed to drain after recovery (queue depth "
                        f"{uplink['final_queue_depth']}, spool "
                        f"{uplink['spool']['pending_batches']} batches)")
    max_drops = int(duration_s * soak["streams"] * 30.0)
    if soak["subscriber_drops"] > max_drops:
        failures.append(f"{soak['subscriber_drops']} subscriber drops exceed the {max_drops} "
                        f"frame budget")
    return failures


def prof_failures(soak: dict) -> list:
    """``--profile-on-burn``: when faults fired, at least one triggered
    capture bundle with its manifest, device trace and spans on disk."""
    prof = soak.get("prof") or {}
    triggered = [m for m in prof.get("captures", [])
                 if m.get("trigger") in ("slo_episode", "ladder_escalation")]
    if not soak["faults_applied"]:
        return []
    ok = [m for m in triggered
          if m.get("error") is None and m.get("device_trace")
          and os.path.isfile(os.path.join(m["path"], "manifest.json"))
          and os.path.isfile(os.path.join(m["path"], m["device_trace"]))
          and os.path.isfile(os.path.join(m["path"], m["spans"]))]
    if ok:
        return []
    return [f"faults fired but no intact burn-triggered capture bundle exists (triggered="
            f"{len(triggered)}, errors={prof.get('errors')}, dir={prof.get('dir')})"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (cpu: the tiny twins)")
    ap.add_argument("--duration", type=float, default=120.0,
                    help="chaos-soak measured window, seconds")
    ap.add_argument("--out", default="SOAK_torch.json", help="soak+determinism artifact path")
    ap.add_argument("--e2e", action="store_true", default=True)
    ap.add_argument("--no-e2e", dest="e2e", action="store_false")
    ap.add_argument("--e2e-out", default="E2E_torch.json")
    ap.add_argument("--e2e-duration", type=float, default=30.0)
    ap.add_argument("--model", default="",
                    help="lockstep/e2e model (default: yolov8n on cuda, tiny_yolov8 on cpu)")
    ap.add_argument("--frames", type=int, default=240,
                    help="frames per camera in the determinism trace")
    ap.add_argument("--size", default="128x96", help="camera geometry WxH")
    ap.add_argument("--trace-out", default="",
                    help="write the soak's sampled frame-lineage spans as Chrome trace-event "
                         "JSON")
    ap.add_argument("--faults", default="",
                    help="comma list of resilience (uplink_down, bus_flap, device_stall) "
                         "and/or quality (black_frame, frozen_frame, score_drift) fault kinds; "
                         "omitted: the default churn plan")
    ap.add_argument("--quality-out", default="QUALITY_torch.json",
                    help="quality attribution artifact (only with quality kinds)")
    ap.add_argument("--profile-on-burn", action="store_true",
                    help="arm burn-triggered torch.profiler captures and require an intact "
                         "bundle when faults fired")
    ap.add_argument("--prof-dir", default="",
                    help="retention directory for --profile-on-burn bundles")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="the fleet-telemetry leg with N member servers instead of the "
                         "three legs")
    ap.add_argument("--fleet-out", default="FLEETOBS_torch.json",
                    help="fleet-telemetry artifact path (--fleet)")
    ap.add_argument("--fleet-duration", type=float, default=12.0,
                    help="each member's replay window for --fleet, seconds")
    ap.add_argument("--torch-threads", type=int, default=0,
                    help="each fleet member's torch intra-op threads (--fleet; 0: torch's "
                         "default)")
    args = ap.parse_args(argv)

    from video_edge_ai_proxy_tpu_torch.replay.checksum import check_golden
    from video_edge_ai_proxy_tpu_torch.replay.faults import (
        KINDS, QUALITY_KINDS, RESILIENCE_KINDS, FaultPlan,
    )
    from video_edge_ai_proxy_tpu_torch.replay.harness import (
        lockstep_checksum, run_e2e, run_fleet_soak,
    )
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

    device = args.device
    model = args.model or ("yolov8n" if device == "cuda" else "tiny_yolov8")
    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        ap.error(f"--size must be WxH, got {args.size!r}")

    # -- the fleet-telemetry leg (--fleet N): instead of the three legs ---
    if args.fleet:
        from video_edge_ai_proxy_tpu_torch.replay.harness import run_fleet_obs

        fleet = run_fleet_obs(n_members=args.fleet, duration_s=args.fleet_duration,
                              width=w, height=h, model=model, device=device,
                              torch_threads=args.torch_threads)
        fleet["tool"] = "torch_soak_replay"
        with open(args.fleet_out, "w") as f:
            json.dump(fleet, f, indent=2)
            f.write("\n")
        print(json.dumps({
            "leg": "fleet", "artifact": args.fleet_out, "backend": fleet["backend"],
            "members": fleet["members"], "gates": fleet["gates"],
            "client_results": fleet["client_results"],
            "health": [{k: row[k] for k in ("instance", "score", "up", "stale", "ladder_rung",
                                            "streams")} for row in fleet["health"]],
        }), flush=True)
        failures = fleet_failures(fleet)
        if failures:
            raise SystemExit("fleet obs failure: " + "; ".join(failures))
        return

    fault_plan = None
    quality_kinds: tuple = ()
    if args.faults:
        kinds = [k.strip() for k in args.faults.split(",") if k.strip()]
        bad = sorted(set(kinds) - set(KINDS))
        if bad:
            ap.error(f"unknown fault kind(s) {bad}; choose from "
                     f"{sorted(RESILIENCE_KINDS + QUALITY_KINDS)}")
        churn = sorted(set(kinds) - set(RESILIENCE_KINDS) - set(QUALITY_KINDS))
        if churn:
            ap.error(f"--faults selects resilience/quality kinds only "
                     f"({sorted(RESILIENCE_KINDS + QUALITY_KINDS)}); the churn kinds {churn} "
                     f"run in the default plan when --faults is omitted")
        rkinds = [k for k in kinds if k in RESILIENCE_KINDS]
        quality_kinds = tuple(k for k in kinds if k in QUALITY_KINDS)
        if rkinds:
            fault_plan = FaultPlan.resilience(args.duration, kinds=rkinds)

    artifact: dict = {"tool": "torch_soak_replay", "backend": device}

    # -- leg 1: record -> replay x2 determinism ---------------------------
    tmp = tempfile.mkdtemp(prefix="vep_replay_")
    trace_path = os.path.join(tmp, "determinism.vtrace")
    record_synthetic_trace(trace_path, ["det0", "det1"], width=w, height=h, fps=30.0, gop=30,
                           frames=args.frames)
    t0 = time.monotonic()
    run1 = lockstep_checksum(trace_path, model=model, device=device)
    run2 = lockstep_checksum(trace_path, model=model, device=device)
    shutil.rmtree(tmp, ignore_errors=True)
    det = {
        "trace_frames": run1["frames"],
        "model": model,
        "checksum_run1": run1["checksum"],
        "checksum_run2": run2["checksum"],
        "identical": run1["checksum"] == run2["checksum"],
        "seconds": round(time.monotonic() - t0, 1),
    }
    if not det["identical"]:
        raise SystemExit(f"replay determinism failure: two replays produced "
                         f"{run1['checksum']} != {run2['checksum']}")
    key = f"soak:lockstep:{model}:{device}:{args.frames}f"
    det["checksum_key"] = key
    det["checksum_golden"] = check_golden(key, run1["checksum"], tool="torch_soak_replay")
    artifact["determinism"] = det
    print(json.dumps({"leg": "determinism", **det}), flush=True)

    # -- leg 2: chaos soak ------------------------------------------------
    soak = run_fleet_soak(duration_s=args.duration, src_hw=(h, w), fault_plan=fault_plan,
                          profile_on_burn=args.profile_on_burn,
                          prof_dir=args.prof_dir or None, quality_kinds=quality_kinds,
                          device=device)
    artifact["soak"] = soak
    print(json.dumps({
        "leg": "soak",
        "duration_s": soak["duration_s"],
        "streams": soak["streams"],
        "results_measured": soak["results_measured"],
        "misrouted_results": soak["misrouted_results"],
        "subscriber_drops": soak["subscriber_drops"],
        "step_cache": soak["step_cache"]["final"],
        "step_cache_stable": soak["step_cache"]["stable"],
        "per_family_latency_ms": soak["per_family_latency_ms"],
        "stage_breakdown": soak["obs"]["stage_breakdown"],
    }), flush=True)
    res = soak["resilience"]
    uplink = res["uplink"]
    print(json.dumps({
        "leg": "resilience",
        "ladder": res["ladder"],
        "shed_frames": res["shed_frames"],
        "breaker": uplink["breaker"],
        "published": uplink["published"],
        "delivered_events": uplink["delivered_events"],
        "post_failures": uplink["post_failures"],
        "spool": {k: uplink["spool"][k] for k in (
            "spooled_batches", "drained_batches", "dropped_events", "pending_batches")},
        "conserved": uplink["conserved"],
    }), flush=True)
    slo = soak.get("slo")
    print(json.dumps({
        "leg": "slo",
        "fps": soak["perf"]["fps"],
        "compiled_programs": sum(rec["programs"] for rec in soak["perf"]["compiles"]),
        "burning": slo["burning"] if slo else None,
        "burn": {name: s["burn"] for name, s in slo["slos"].items()} if slo else None,
        "episodes": {name: s["episodes"] for name, s in slo["slos"].items()} if slo else None,
    }), flush=True)
    failures = []
    if args.profile_on_burn:
        prof = soak.get("prof") or {}
        print(json.dumps({
            "leg": "prof", "dir": prof.get("dir"), "bundles": prof.get("bundles"),
            "retained_bytes": prof.get("retained_bytes"), "errors": prof.get("errors"),
            "triggered_captures": [
                {k: m.get(k) for k in ("bundle", "trigger", "wall_ms", "span_events",
                                       "slo_episode", "error")}
                for m in prof.get("captures", [])
                if m.get("trigger") in ("slo_episode", "ladder_escalation")],
        }), flush=True)
        failures += [f"prof failure: {f}" for f in prof_failures(soak)]
    if quality_kinds:
        quality = soak.get("quality")
        if not quality:
            raise SystemExit("quality failure: quality kinds were requested but the soak "
                             "produced no quality section")
        # Soak-scale enter hysteresis (0.6 s), the observation cadence and
        # the verdict window's lag, with scheduling slack.
        latency_bound_s = 5.0
        quality["latency_bound_s"] = latency_bound_s
        print(json.dumps({
            "leg": "quality",
            "faults": [{k: f.get(k) for k in ("kind", "device_id", "detected", "latency_s",
                                               "latency_ticks", "mismatch_cycles")}
                       for f in quality["faults"]],
            "false_positives": quality["false_positives"],
            "canary": {k: (quality["canary"] or {}).get(k) for k in (
                "loop_len", "match_cycles", "mismatch_cycles", "void_cycles")},
            "canary_watchdog_episodes": quality["canary_watchdog_episodes"],
            "latency_bound_s": latency_bound_s,
        }), flush=True)
        with open(args.quality_out, "w") as f:
            json.dump(quality, f, indent=2)
            f.write("\n")
        failures += [f"quality failure: {f}"
                     for f in quality_failures(quality, quality_kinds, latency_bound_s)]
    failures += [f"chaos failure: {f}" for f in chaos_failures(soak, args.duration)]
    if failures:
        raise SystemExit("; ".join(failures))
    if args.trace_out:
        # run_fleet_soak leaves its span rings intact after restoring the
        # tracer's config: the export reads them here.
        from video_edge_ai_proxy_tpu_torch.obs import tracer
        from video_edge_ai_proxy_tpu_torch.obs.spans import to_chrome_trace

        trace_obj = to_chrome_trace(tracer.events())
        with open(args.trace_out, "w") as f:
            json.dump(trace_obj, f)
            f.write("\n")
        print(json.dumps({"leg": "trace", "events": len(trace_obj["traceEvents"]),
                          "artifact": args.trace_out}), flush=True)

    # -- leg 3: full-pipeline e2e ----------------------------------------
    if args.e2e:
        e2e = run_e2e(duration_s=args.e2e_duration, width=w, height=h, model=model,
                      device=device)
        artifact["e2e"] = e2e
        with open(args.e2e_out, "w") as f:
            json.dump(e2e, f, indent=2)
            f.write("\n")
        print(json.dumps({"leg": "e2e", "results_measured": e2e["results_measured"],
                          "latency_ms": e2e["latency_ms"], "artifact": args.e2e_out}),
              flush=True)

    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2, default=str)
        f.write("\n")
    print(json.dumps({"leg": "summary", "artifact": args.out,
                      "determinism_ok": det["identical"],
                      "misrouted_results": soak["misrouted_results"]}), flush=True)


if __name__ == "__main__":
    main()
