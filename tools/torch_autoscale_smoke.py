"""Autoscale smoke of the PyTorch/CUDA port (the port's
``tools/autoscale_smoke.py``): the supervisor soak with JAX's gates.

Boots two serve-only members one after the other on a shared prewarm
manifest directory (m0 records its program set there; m1 prewarms the
same), then runs a ``FleetSupervisor`` with a real subprocess spawner over
``replay/harness.py``'s ``LoadShape`` (diurnal ramp, connect/disconnect
storm, hot-spot camera, mixed model tenants): ``run_autoscale_soak``. The
spawned member boots with no ``--prewarm`` flag; its program set comes
from the manifest (each CUDA graph captured anew at boot: the port keeps
no compiled program on disk).

Gates (exit non-zero on a breach), ``AUTOSCALE_r01.json``'s eleven:
attach; the one spawn's reason ``saturation_forecast`` with positive
headroom; the spawned member's program set complete from the manifest;
Popen -> its first served frame within one capacity scrape interval;
storm admission p99 under the bound; one retire on sustained surplus and
no flap; the conservation ledger balanced; no admission error; lint-clean
``vep_supervisor_*`` families.

``LoadShape``'s rates and the horizon were set on the JAX tool's CPU run
(``AUTOSCALE_r01.json``, its spawn at min headroom 0.948). On another
device the same traffic costs another utilization, and the forecast's
slope with it: the soak scales the horizon by the members' headroom at
the end of the base warmup against that recorded spawn headroom
(``run_autoscale_soak``'s ``ref_spawn_headroom``, read here from
``AUTOSCALE_r01.json``), so the decision falls at the same point of the
shape.

The members run on the card (``--device cuda``, the default: ``yolov8n``
with ``mobilenet_v2`` tenants) or on the CPU (``--device cpu``:
``tiny_yolov8`` with ``tiny_mobilenet_v2``).

Usage:
  python tools/torch_autoscale_smoke.py --device cpu --torch-threads 1
  python tools/torch_autoscale_smoke.py --device cuda --size 1920x1080 --torch-threads 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def reference_spawn_headroom() -> float:
    """The fleet's min headroom at the spawn of ``AUTOSCALE_r01.json``, the
    run ``LoadShape``'s rates and the default horizon were set on."""
    with open(os.path.join(ROOT, "AUTOSCALE_r01.json")) as f:
        return float(json.load(f)["spawn"]["event"]["min_headroom"])


def autoscale_failures(out: dict) -> list:
    """The autoscale soak's gates (JAX's ``AUTOSCALE_r01.json`` eleven)."""
    gates = out["gates"]
    failures = []
    if not gates["attach_clean"]:
        failures.append("router attach failed on a member")
    if not gates["scale_out_on_forecast"]:
        failures.append(f"no spawn with reason saturation_forecast: {out['spawn']['event']}")
    if not gates["scale_out_beats_burn"]:
        failures.append(f"spawn landed after headroom went non-positive: "
                        f"{out['spawn']['event']}")
    if not gates["spawn_prewarm_from_manifest"]:
        failures.append("spawned member's program set did not come complete from the "
                        f"manifest: {out['spawn']['prewarm']}")
    if not gates["spawn_first_frame_within_scrape"]:
        failures.append(f"spawn->first-served-frame {out['spawn']['first_frame_s']}s > one "
                        "capacity scrape interval "
                        f"({out['config']['capacity_scrape_interval_s']}s)")
    if not gates["storm_admission_bounded"]:
        failures.append(f"storm admission p99 {out['storm']['p99_s']}s > "
                        f"{out['config']['storm_admission_bound_s']}s or streams undelivered")
    if not gates["retire_on_surplus"]:
        failures.append("no retire on sustained surplus")
    if not gates["no_flap"]:
        failures.append("member set flapped (want exactly 1 spawn + 1 retire, back at "
                        "min_members)")
    if not gates["ledger_balanced"]:
        failures.append(f"conservation ledger imbalance: lost={out['ledger']['lost']} "
                        f"duplicated={out['ledger']['duplicated']}")
    if not gates["no_admission_errors"]:
        failures.append(f"admission errors: {out['failures']}")
    if not gates["supervisor_metrics_lint_clean"]:
        failures.append(f"supervisor exposition lint: {out['lint_errors']}")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the members' engines' device")
    ap.add_argument("--model", default="",
                    help="default: yolov8n on cuda, tiny_yolov8 on cpu")
    ap.add_argument("--tenant-model", default="",
                    help="the shape's second tenant (default: mobilenet_v2 on cuda, "
                         "tiny_mobilenet_v2 on cpu)")
    ap.add_argument("--size", default="128x96")
    ap.add_argument("--scrape-interval", type=float, default=1.0,
                    help="the router's liveness scrape (placement and migration cadence)")
    ap.add_argument("--capacity-scrape-interval", type=float, default=30.0,
                    help="the capacity-forecast scrape the spawn -> first-frame gate is "
                         "defined against")
    ap.add_argument("--spawn-horizon", type=float, default=600.0)
    ap.add_argument("--surplus-headroom", type=float, default=0.3)
    ap.add_argument("--surplus-hold", type=float, default=8.0)
    ap.add_argument("--storm-admission-bound", type=float, default=12.0)
    ap.add_argument("--torch-threads", type=int, default=0,
                    help="each member's torch intra-op threads (0: torch's default)")
    ap.add_argument("--out", default="AUTOSCALE_torch.json")
    ap.add_argument("--workdir", default="",
                    help="keep the soak's directory (member stderr, the manifest)")
    args = ap.parse_args(argv)

    from video_edge_ai_proxy_tpu_torch.replay.harness import LoadShape, run_autoscale_soak

    cuda = args.device == "cuda"
    model = args.model or ("yolov8n" if cuda else "tiny_yolov8")
    tenant = args.tenant_model or ("mobilenet_v2" if cuda else "tiny_mobilenet_v2")
    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        ap.error(f"--size must be WxH, got {args.size!r}")
    out = run_autoscale_soak(
        width=w, height=h, model=model, scrape_interval_s=args.scrape_interval,
        capacity_scrape_interval_s=args.capacity_scrape_interval,
        spawn_horizon_s=args.spawn_horizon, surplus_headroom=args.surplus_headroom,
        surplus_hold_s=args.surplus_hold, storm_admission_bound_s=args.storm_admission_bound,
        shape=LoadShape(models=("", tenant)), ref_spawn_headroom=reference_spawn_headroom(),
        device=args.device, torch_threads=args.torch_threads, workdir=args.workdir or None)
    out["tool"] = "torch_autoscale_smoke"
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({
        "leg": "autoscale", "artifact": args.out, "backend": out["backend"],
        "gates": out["gates"], "boots": {m: b["boot_s"] for m, b in out["boots"].items()},
        "spawn_first_frame_s": out["spawn"]["first_frame_s"],
        "spawn_horizon_s_used": out["config"]["spawn_horizon_s_used"],
        "base_min_headroom": out["config"]["base_min_headroom"],
        "spawn_min_headroom": (out["spawn"]["event"] or {}).get("min_headroom"),
        "storm_p99_s": out["storm"]["p99_s"],
        "ledger": {k: out["ledger"][k] for k in ("balanced", "lost", "duplicated")},
    }), flush=True)
    failures = autoscale_failures(out)
    if failures:
        raise SystemExit("autoscale smoke failure: " + "; ".join(failures))


if __name__ == "__main__":
    main()
