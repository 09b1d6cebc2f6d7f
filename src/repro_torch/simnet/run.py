"""Virtual-time scenario driver: the paper loop with latency measured.

    DAQ emission (timestamped) -> uplink/WAN serialization + delay + loss
      -> LB route (the lb_route kernel, fixed pipeline latency) -> per-member
      downlink -> bounded CN receive queue (service-rate model) -> reassembly
      -> measured telemetry on the virtual clock -> CP reweight -> around.

Prints a ``SimReport`` (end-to-end latency percentiles, loss/timeout
accounting, weight trajectory) as JSON and audits the paper's invariants: no
event split across members (per LB instance), no corrupt bundle, everything
accounted, and non-degenerate latency percentiles (p99 > p50 > 0). Exits 1
on a violation.

The port of the JAX package's ``scripts/run_simnet.py``: the same flags
but ``--compare-policy``, ``--tournament`` and the ``--trace-*`` ones (not
ported yet), plus ``--device``; from the same flags its summary equals the
reference's with ``--engine host``, ``wall_s`` and ``packets_per_sec``
aside. ``--controld``/``--ha``/``--kill-leader-every``/``--policy`` run the
control plane as a session daemon (host engine); ``--metrics-interval``
runs the live registry (host engine only).

``--compare-frozen`` reruns the scenario with feedback disabled and reports
the p99 delta; for scenarios that promise a control-plane gain
(straggler, elephant) a frozen run beating the closed loop is a failure.

    PYTHONPATH=src python -m repro_torch.simnet.run --scenario straggler \
        --engine host --device cpu
    PYTHONPATH=src python -m repro_torch.simnet.run --scenario farm_1k --steps 10
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.simnet import SCENARIOS, SimReport, Simulator, get_scenario


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="baseline")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--n-members", type=int, default=None)
    ap.add_argument("--triggers-per-step", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the tables, the links' draws and the torch "
                         "queue engine live (cuda launches the kernels)")
    ap.add_argument("--queue-engine", choices=["np", "torch"], default="np")
    ap.add_argument("--engine", choices=["fused", "host"], default="fused",
                    help="fused = device-resident closed loop (one CUDA-graph "
                         "replay per K windows; configs outside its scope run "
                         "on the host engine); host = per-window Python loop "
                         "(the parity oracle)")
    ap.add_argument("--frozen-weights", action="store_true",
                    help="disable control-plane feedback (control run)")
    ap.add_argument("--compare-frozen", action="store_true",
                    help="also run the frozen-weights control and compare p99")
    ap.add_argument("--controld", action="store_true",
                    help="run the control plane as a session daemon "
                         "(controld): CNs register/heartbeat/lease")
    ap.add_argument("--ha", action="store_true",
                    help="controld HA mode: an HACluster of warm standbys "
                         "behind a failover transport (implies --controld)")
    ap.add_argument("--kill-leader-every", type=int, default=0, metavar="N",
                    help="kill the controld leader every N windows (implies "
                         "--ha); each takeover is digest-audited and "
                         "duration-gated at 1.25x the lease term")
    ap.add_argument("--policy", choices=["proportional", "pid"], default=None,
                    help="controld reweighting policy (implies --controld)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="emit a metrics time-series row every N windows "
                         "(enables the live registry; host engine only). "
                         "0 = off")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="JSONL path for --metrics-interval rows "
                         "(default: no file, registry only)")
    ap.add_argument("--traces", action="store_true",
                    help="include full queue/weight traces in the JSON")
    ap.add_argument("--json", default=None, help="write the summary here")
    return ap.parse_args(argv)


def build_and_run(args, frozen: bool, with_metrics: bool = True) -> SimReport:
    scenario = get_scenario(args.scenario)
    extra = dict(steps=args.steps, seed=args.seed, device=args.device,
                 queue_engine=args.queue_engine, frozen_weights=frozen,
                 engine=args.engine)
    if args.n_members is not None:
        extra["n_members"] = args.n_members
    if args.triggers_per_step is not None:
        extra["triggers_per_step"] = args.triggers_per_step
    if args.controld or args.policy is not None:
        extra["controld"] = True
    if args.ha or args.kill_leader_every:
        extra["controld"] = True
        extra["ha"] = True
        if args.kill_leader_every:
            extra["ha_kill_every"] = args.kill_leader_every
    if args.policy is not None:
        extra["controld_policy"] = args.policy
    if with_metrics and (args.metrics_interval or args.metrics_jsonl):
        # only the primary leg emits: the frozen comparison leg does not
        extra["metrics_every"] = max(args.metrics_interval, 1)
        extra["metrics_path"] = args.metrics_jsonl
    cfg = scenario.build_config(**extra)
    return Simulator(cfg, dataclasses.replace(scenario)).run()


def main(argv=None) -> int:
    args = parse_args(argv)
    scenario = get_scenario(args.scenario)
    report = build_and_run(args, frozen=args.frozen_weights)
    summary = report.to_dict(with_traces=args.traces)

    violations = list(report.violations)
    if report.bundles_completed:
        if not (report.latency_p99_s > report.latency_p50_s > 0):
            violations.append(
                f"degenerate latency percentiles (p50={report.latency_p50_s}, "
                f"p99={report.latency_p99_s})")
    else:
        violations.append("no bundles completed")

    if args.compare_frozen and not args.frozen_weights:
        control = build_and_run(args, frozen=True, with_metrics=False)
        summary["control"] = {
            "latency_p50_s": round(control.latency_p50_s, 9),
            "latency_p99_s": round(control.latency_p99_s, 9),
            "bundles_timed_out": control.bundles_timed_out,
            "packets_dropped_queue": control.packets_dropped_queue,
        }
        gain = (control.latency_p99_s - report.latency_p99_s)
        summary["p99_gain_vs_frozen_s"] = round(gain, 9)
        if scenario.expect_cp_gain and gain <= 0:
            violations.append(
                f"control plane did not reduce p99 latency "
                f"(closed={report.latency_p99_s:.6f}s "
                f"frozen={control.latency_p99_s:.6f}s)")

    summary["violations"] = violations
    print(json.dumps(summary, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    if violations:
        print("FAILED: " + "; ".join(violations), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
