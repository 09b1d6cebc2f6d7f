"""Two-tier fabric driver: run the fabric scenarios and enforce their gates.

    DAQ fleet -> VLB spray (random intermediate LB, then the owner)
      -> elephant-aware calendar lanes -> per-member downlink -> CN queues

Each scenario IS a gate:

* ``vlb_spray``     — runs the skewed-DAQ load under both the two-phase
                      spray and direct per-DAQ hashing; FAILS unless VLB's
                      max-LB load share <= direct's.
* ``elephant_mice`` — runs with reserved-lane isolation ON and OFF; FAILS
                      unless mice p99 is strictly better with isolation.
* ``lb_node_failure`` — kills a tier member mid-run; FAILS on any lost
                      bundle or invariant violation (re-spray is hit-less).

The port of the JAX package's ``scripts/run_fabric.py``: the same flags
and summary, plus ``--device`` (default ``cuda``: every window routes
through the ``lb_route`` kernel; ``cpu`` runs its plain version).

    PYTHONPATH=src python -m repro_torch.fabric.run --scenario all
    PYTHONPATH=src python -m repro_torch.fabric.run --scenario elephant_mice --controld
    PYTHONPATH=src python -m repro_torch.fabric.run --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.fabric import FABRIC_SCENARIOS, FabricSim, get_fabric_scenario


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="all",
                    choices=sorted(FABRIC_SCENARIOS) + ["all"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--k-lbs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--controld", action="store_true",
                    help="run the fabric as a ReserveFabric tenant of the "
                         "control daemon (2K leased sessions, failure drain "
                         "via DeregisterBatch)")
    ap.add_argument("--metrics-registry", action="store_true",
                    help="attach a live MetricsRegistry (fabric_lb_load / "
                         "fabric_elephants gauges) and dump it at the end")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the primary leg of each scenario and write "
                         "Chrome trace-event / Perfetto JSON (multiple "
                         "scenarios get a .<scenario> suffix before the "
                         "extension)")
    ap.add_argument("--device", default="cuda",
                    help="where the tables, link draws and the torch queue "
                         "engine live (cuda launches the kernels; cpu runs "
                         "their plain versions)")
    ap.add_argument("--json", default=None, help="write the summary here")
    return ap.parse_args(argv)


def _build(sc, args, **extra):
    for k, v in (("steps", args.steps), ("k_lbs", args.k_lbs),
                 ("seed", args.seed)):
        if v is not None:
            extra[k] = v
    if args.controld:
        extra["controld"] = True
    return sc.build_config(device=args.device, **extra)


def _export_trace(sim, name: str, path: str, many: bool) -> None:
    """Perfetto export of the primary leg's span buffer."""
    if sim.trace is None:
        return
    if many:
        stem, dot, ext = path.rpartition(".")
        path = f"{stem}.{name}{dot}{ext}" if dot else f"{path}.{name}"
    with open(path, "wb") as f:
        f.write(sim.trace.to_perfetto_json())
    print(f"# perfetto export: {path}", file=sys.stderr)


def run_scenario(name: str, args, metrics=None, many: bool = False) -> dict:
    sc = get_fabric_scenario(name)
    out: dict = {"scenario": name, "gates": {}, "violations": []}
    # only the primary leg records spans: comparison legs (direct hashing,
    # isolation-off) would double every bundle key in one buffer
    tr = {"trace": True} if args.trace_out else {}

    if name == "vlb_spray":
        prim = FabricSim(_build(sc, args, mode="vlb", **tr), scenario=sc,
                         metrics=metrics)
        vlb = prim.run()
        direct = FabricSim(_build(sc, args, mode="direct"),
                           scenario=sc).run()
        out["vlb"] = vlb.to_dict()
        out["direct"] = {"max_lb_load_frac": direct.max_lb_load_frac,
                         "lb_load_bytes": direct.lb_load_bytes,
                         "latency_p99_s": direct.latency_p99_s}
        out["violations"] = list(vlb.violations) + [
            f"direct leg: {v}" for v in direct.violations]
        ok = vlb.max_lb_load_frac <= direct.max_lb_load_frac
        out["gates"]["vlb_max_load_le_direct"] = ok
        if not ok:
            out["violations"].append(
                f"VLB spray lost to direct hashing on max-LB load "
                f"({vlb.max_lb_load_frac:.3f} > "
                f"{direct.max_lb_load_frac:.3f})")

    elif name == "elephant_mice":
        prim = FabricSim(_build(sc, args, isolate=True, **tr), scenario=sc,
                         metrics=metrics)
        on = prim.run()
        off = FabricSim(_build(sc, args, isolate=False), scenario=sc).run()
        out["isolated"] = on.to_dict()
        out["shared"] = {"mice_p99_s": off.mice_p99_s,
                         "elephant_p99_s": off.elephant_p99_s,
                         "elephants_detected": off.elephants_detected}
        out["violations"] = list(on.violations) + [
            f"shared leg: {v}" for v in off.violations]
        ok = on.mice_p99_s < off.mice_p99_s
        out["gates"]["isolation_cuts_mice_p99"] = ok
        if not ok:
            out["violations"].append(
                f"reserved-lane isolation did not cut mice p99 "
                f"(on={on.mice_p99_s:.6f}s off={off.mice_p99_s:.6f}s)")
        if on.elephants_detected == 0:
            out["violations"].append("no elephant was ever detected")

    else:  # lb_node_failure
        prim = FabricSim(_build(sc, args, **tr), scenario=sc,
                         metrics=metrics)
        r = prim.run()
        out["report"] = r.to_dict()
        out["violations"] = list(r.violations)
        ok = bool(r.lbs_killed) and r.bundles_lost == 0
        out["gates"]["hitless_respray"] = ok
        if not r.lbs_killed:
            out["violations"].append("no LB was killed (scenario hook lost)")
        if r.bundles_lost:
            out["violations"].append(
                f"{r.bundles_lost} bundles lost across the LB failure")
    if args.trace_out:
        _export_trace(prim, name, args.trace_out, many)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    metrics = None
    if args.metrics_registry:
        from repro_torch.telemetry.registry import MetricsRegistry
        metrics = MetricsRegistry()
    names = (sorted(FABRIC_SCENARIOS) if args.scenario == "all"
             else [args.scenario])
    summary = {"scenarios": [run_scenario(n, args, metrics,
                                          many=len(names) > 1)
                             for n in names]}
    failures = [v for s in summary["scenarios"] for v in s["violations"]]
    if metrics is not None:
        summary["metrics"] = {
            name: {",".join(lv) or "_": child.value()
                   for lv, child in fam.samples()}
            for name, fam in metrics._families.items()
            if name.startswith("fabric_")}
    print(json.dumps(summary, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
