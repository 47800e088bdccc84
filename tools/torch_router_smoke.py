"""Fleet-router smoke of the PyTorch/CUDA port (the port's
``tools/router_smoke.py``): the live-migration soak with JAX's gates.

Boots N serve-only member servers in processes of their own (REST, gRPC
and an engine each; on the card they share it), places N*2 replay streams
through ``serve/router.py``'s consistent-hash ring, then runs the two
legs of ``replay/harness.py`` ``run_router_soak``:

- **burn**: one member's SLO-burn verdict forced on; its ladder walks
  shed -> shed_to_fleet and the router migrates its streams (drain ->
  cutover -> resume at the replay cursor) before the ladder reaches
  bucket_downshift;
- **kill**: one member SIGKILLed; every stream re-placed, detection ->
  resumed within one scrape interval.

Gates (exit non-zero on a breach), ``ROUTER_r01.json``'s nine: attach,
the burn leg's evacuation and its ``shed_to_fleet >= 1`` with
``bucket_downshift == 0``, the kill leg's re-placement within the scrape
and within scrape + 1 s of wall time, the conservation ledger balanced
for every stream (no packet lost or duplicated), a stitched lineage for
every completed migration, and lint-clean ``vep_router_*`` families.

The members run on the card (``--device cuda``, the default: ``yolov8n``)
or on the CPU (``--device cpu``: ``tiny_yolov8``).

Usage:
  python tools/torch_router_smoke.py --device cpu --out ROUTER_torch.json
  python tools/torch_router_smoke.py --device cuda --size 1920x1080 --torch-threads 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def router_failures(out: dict) -> list:
    """The router soak's gates (JAX's ``ROUTER_r01.json`` nine)."""
    gates = out["gates"]
    failures = []
    if not gates["attach_clean"]:
        failures.append("router attach failed on a member")
    if not gates["burn_streams_evacuated"]:
        failures.append(f"burn leg: streams not migrated off {out['burn']['member']}")
    if not gates["burn_shed_to_fleet_before_downshift"]:
        failures.append("burn leg: ladder reached bucket_downshift before the fleet handoff "
                        f"completed: {out['burn']['transitions_at_migration']}")
    if not gates["kill_streams_replaced"]:
        failures.append(f"kill leg: streams not re-placed off {out['kill']['member']}")
    if not gates["kill_replace_within_scrape"]:
        failures.append(f"kill leg: detect->resumed {out['kill']['replace_detect_s']}s > "
                        "scrape interval")
    if not gates["kill_replace_wall_bounded"]:
        failures.append(f"kill leg: wall kill->resumed {out['kill']['replace_wall_s']}s > "
                        "scrape interval + 1s")
    if not gates["ledger_balanced"]:
        failures.append(f"conservation ledger imbalance: lost={out['ledger']['lost']} "
                        f"duplicated={out['ledger']['duplicated']}")
    if not gates["migrated_lineage_stitched"]:
        failures.append(f"migration without a stitched lineage chain: {out['lineage']}")
    if not gates["router_metrics_lint_clean"]:
        failures.append(f"router exposition lint: {out['lint_errors']}")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the members' engines' device")
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--streams-per-member", type=int, default=2)
    ap.add_argument("--model", default="",
                    help="default: yolov8n on cuda, tiny_yolov8 on cpu")
    ap.add_argument("--size", default="128x96")
    ap.add_argument("--fps", type=float, default=2.0,
                    help="each stream's frame rate; below the members' tick rate, so steady "
                         "state is lossless and the ledger reads migration alone")
    ap.add_argument("--scrape-interval", type=float, default=1.0)
    ap.add_argument("--ladder-escalate", type=float, default=8.0,
                    help="rung spacing: migration completes inside one window "
                         "(shed_to_fleet -> bucket_downshift)")
    ap.add_argument("--torch-threads", type=int, default=0,
                    help="each member's torch intra-op threads (0: torch's default)")
    ap.add_argument("--out", default="ROUTER_torch.json")
    ap.add_argument("--workdir", default="",
                    help="keep the soak's directory (member stderr, span dumps)")
    args = ap.parse_args(argv)

    from video_edge_ai_proxy_tpu_torch.replay.harness import run_router_soak

    model = args.model or ("yolov8n" if args.device == "cuda" else "tiny_yolov8")
    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        ap.error(f"--size must be WxH, got {args.size!r}")
    out = run_router_soak(
        n_members=args.members, streams_per_member=args.streams_per_member, width=w, height=h,
        fps=args.fps, model=model, scrape_interval_s=args.scrape_interval,
        ladder_escalate_s=args.ladder_escalate, device=args.device,
        torch_threads=args.torch_threads, workdir=args.workdir or None)
    out["tool"] = "torch_router_smoke"
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({
        "leg": "router", "artifact": args.out, "backend": out["backend"],
        "members": out["members"], "streams": out["streams"], "gates": out["gates"],
        "burn_migrate_s": out["burn"]["migrate_s"],
        "kill_replace_detect_s": out["kill"]["replace_detect_s"],
        "kill_replace_wall_s": out["kill"]["replace_wall_s"],
        "ledger": {k: out["ledger"][k] for k in ("balanced", "lost", "duplicated")},
    }), flush=True)
    failures = router_failures(out)
    if failures:
        raise SystemExit("router smoke failure: " + "; ".join(failures))


if __name__ == "__main__":
    main()
