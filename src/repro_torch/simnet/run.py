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

The port of the JAX package's ``scripts/run_simnet.py``: the same flags,
plus ``--device``; from the same flags its summary equals the reference's
with ``--engine host`` (the reference's fused engine does not import under
jax 0.9), ``wall_s`` and ``packets_per_sec`` aside.
``--controld``/``--ha``/``--kill-leader-every``/``--policy`` run the
control plane as a session daemon (host engine); ``--metrics-interval`` and
the ``--trace-*`` flags work on both engines. The kernels' launches go to
stderr as one line when the run ends.

``--compare-frozen`` reruns the scenario with feedback disabled and reports
the p99 delta; for scenarios that promise a control-plane gain
(straggler, elephant) a frozen run beating the closed loop is a failure.
``--compare-policy`` runs the PID and proportional controld policies and
fails if PID loses on p99; ``--tournament`` runs one controld leg per named
policy ('frozen' disables feedback) and ranks them by p99. Each comparison
leg runs once (a leg whose config matches one already run, the primary's
among them, reuses its report: the runs are deterministic in the seed), and
only the primary leg emits metrics and traces. ``leg_config``, ``Legs``,
``policy_compare`` and ``tournament`` take a built ``SimConfig``, for
callers whose traffic the flags cannot express.

    PYTHONPATH=src python -m repro_torch.simnet.run --scenario straggler \
        --engine host --device cpu
    PYTHONPATH=src python -m repro_torch.simnet.run --scenario farm_1k --steps 10
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.kernels import _lib
from repro_torch.simnet import SCENARIOS, SimReport, Simulator, get_scenario
from repro_torch.simnet.sim import Scenario, SimConfig


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
    ap.add_argument("--compare-policy", action="store_true",
                    help="run the scenario under the PID and proportional "
                         "controld policies; fail if PID p99 is worse")
    ap.add_argument("--tournament", default=None, metavar="P1,P2,...",
                    help="run one controld leg per named policy (aliases: "
                         "prop; the pseudo-policy 'frozen' disables "
                         "feedback) and rank the legs by p99; render the "
                         "table with scripts/make_tables_torch.py "
                         "--tournament")
    ap.add_argument("--traces", action="store_true",
                    help="include full queue/weight traces in the JSON")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="emit a metrics time-series row every N windows "
                         "(enables the live registry; both engines). "
                         "0 = off")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="JSONL path for --metrics-interval rows "
                         "(default: no file, registry only)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-bundle stage spans and write Chrome "
                         "trace-event / Perfetto JSON here (open in "
                         "ui.perfetto.dev)")
    ap.add_argument("--trace-summary-json", default=None, metavar="PATH",
                    help="write the lossless trace summary JSON here (read "
                         "by python -m repro_torch.telemetry.analyze_trace "
                         "--summary)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="head-sampling rate for span retention "
                         "(the tail top-k reservoir is always kept)")
    ap.add_argument("--trace-tail-k", type=int, default=64,
                    help="slowest-bundle reservoir size")
    ap.add_argument("--json", default=None, help="write the summary here")
    return ap.parse_args(argv)


def build_config(args) -> tuple[SimConfig, Scenario]:
    """The primary leg's config from the flags, and its scenario."""
    scenario = get_scenario(args.scenario)
    extra = dict(steps=args.steps, seed=args.seed, device=args.device,
                 queue_engine=args.queue_engine,
                 frozen_weights=args.frozen_weights, engine=args.engine)
    if args.n_members is not None:
        extra["n_members"] = args.n_members
    if args.triggers_per_step is not None:
        extra["triggers_per_step"] = args.triggers_per_step
    if (args.controld or args.compare_policy or args.tournament
            or args.policy is not None):
        extra["controld"] = True
    if args.ha or args.kill_leader_every:
        extra["controld"] = True
        extra["ha"] = True
        if args.kill_leader_every:
            extra["ha_kill_every"] = args.kill_leader_every
    if args.policy is not None:
        extra["controld_policy"] = args.policy
    if args.metrics_interval or args.metrics_jsonl:
        extra["metrics_every"] = max(args.metrics_interval, 1)
        extra["metrics_path"] = args.metrics_jsonl
    if args.trace_out or args.trace_summary_json:
        extra["trace"] = True
        extra["trace_sample"] = args.trace_sample
        extra["trace_tail_k"] = args.trace_tail_k
    return scenario.build_config(**extra), scenario


def leg_config(cfg: SimConfig, frozen: bool, policy: str | None = None) -> SimConfig:
    """A comparison leg of the primary config ``cfg``: feedback frozen or
    not, under ``policy`` (None keeps ``cfg``'s), without metrics or traces:
    only the primary leg emits them."""
    return dataclasses.replace(
        cfg, frozen_weights=frozen,
        controld_policy=cfg.controld_policy if policy is None else policy,
        metrics_every=0, metrics_path=None, trace=False)


def run_leg(cfg: SimConfig, scenario: Scenario) -> tuple[SimReport, Simulator]:
    sim = Simulator(cfg, dataclasses.replace(scenario))
    return sim.run(), sim


class Legs:
    """The comparison legs of one primary run, each config run once: a leg
    whose config equals one already run (the primary's among them) reuses
    its report, since a run is deterministic in its seed."""

    def __init__(self, cfg: SimConfig, scenario: Scenario, report: SimReport):
        self.scenario = scenario
        self.primary_cfg = cfg
        self.report = report
        self._done = [(leg_config(cfg, cfg.frozen_weights), report)]

    def get(self, frozen: bool, policy: str | None = None) -> SimReport:
        cfg = leg_config(self.primary_cfg, frozen, policy)
        for done, report in self._done:
            if done == cfg:
                return report
        report, _ = run_leg(cfg, self.scenario)
        self._done.append((cfg, report))
        return report

    def reports(self) -> list[tuple[SimConfig, SimReport]]:
        """Every distinct leg run, the primary first."""
        return list(self._done)


def frozen_compare(legs: Legs) -> tuple[dict, list[str]]:
    """``--compare-frozen``: the frozen-weights control against the
    primary run; a scenario that promises a control-plane gain fails if
    the closed loop does not cut p99."""
    report = legs.report
    control = legs.get(frozen=True)
    block = {"control": {
        "latency_p50_s": round(control.latency_p50_s, 9),
        "latency_p99_s": round(control.latency_p99_s, 9),
        "bundles_timed_out": control.bundles_timed_out,
        "packets_dropped_queue": control.packets_dropped_queue,
    }}
    gain = (control.latency_p99_s - report.latency_p99_s)
    block["p99_gain_vs_frozen_s"] = round(gain, 9)
    violations = []
    if legs.scenario.expect_cp_gain and gain <= 0:
        violations.append(
            f"control plane did not reduce p99 latency "
            f"(closed={report.latency_p99_s:.6f}s "
            f"frozen={control.latency_p99_s:.6f}s)")
    return block, violations


def policy_compare(legs: Legs) -> tuple[dict, list[str]]:
    """``--compare-policy``: the PID fill controller must not lose to the
    proportional policy on p99."""
    pid = legs.get(frozen=False, policy="pid")
    prop = legs.get(frozen=False, policy="proportional")
    block = {
        "pid_p99_s": round(pid.latency_p99_s, 9),
        "proportional_p99_s": round(prop.latency_p99_s, 9),
        "pid_gain_s": round(prop.latency_p99_s - pid.latency_p99_s, 9),
    }
    violations = [f"pid policy run: {v}" for v in pid.violations]
    violations += [f"proportional policy run: {v}" for v in prop.violations]
    if pid.latency_p99_s > prop.latency_p99_s:
        violations.append(
            f"PID policy lost to proportional on p99 "
            f"(pid={pid.latency_p99_s:.6f}s "
            f"prop={prop.latency_p99_s:.6f}s)")
    return block, violations


def tournament(legs: Legs, policies: str, scenario_name: str) -> tuple[dict, list[str]]:
    """``--tournament P1,P2,...``: one leg per named controld policy
    (alias ``prop``; ``frozen`` disables feedback), ranked by p99."""
    from repro_torch.controld import POLICIES

    violations = []
    aliases = {"prop": "proportional"}
    names = [aliases.get(n.strip(), n.strip())
             for n in policies.split(",") if n.strip()]
    names = list(dict.fromkeys(names))   # dedupe, keep rank-input order
    if len(names) < 2:
        violations.append(
            f"--tournament needs at least two policies, got {names}")
    legal = set(POLICIES) | {"frozen"}
    unknown = [n for n in names if n not in legal]
    if unknown:
        violations.append(
            f"unknown tournament policies {unknown}; have {sorted(legal)}")
        names = [n for n in names if n in legal]
    cfg = legs.primary_cfg
    legs_run = [(name, legs.get(frozen=True) if name == "frozen"
                 else legs.get(frozen=False, policy=name)) for name in names]
    ranked = sorted(legs_run, key=lambda kv: kv[1].latency_p99_s)
    best = ranked[0][1].latency_p99_s if ranked else 0.0
    block = {
        "scenario": scenario_name,
        "steps": cfg.steps,
        "seed": cfg.seed,
        "ranked": [
            {"rank": i + 1, "policy": name,
             "latency_p50_s": round(leg.latency_p50_s, 9),
             "latency_p99_s": round(leg.latency_p99_s, 9),
             "p99_vs_best_s": round(leg.latency_p99_s - best, 9),
             "bundles_timed_out": leg.bundles_timed_out,
             "packets_dropped_queue": leg.packets_dropped_queue}
            for i, (name, leg) in enumerate(ranked)],
    }
    for name, leg in legs_run:
        if leg is not legs.report:
            violations.extend(
                f"{name} tournament leg: {v}" for v in leg.violations)
    return block, violations


def write_trace(sim: Simulator, trace_out: str | None,
                trace_summary: str | None) -> None:
    """The primary leg's trace: Perfetto JSON and the lossless summary
    (spans, completions and the per-stage breakdown)."""
    if sim.trace is None:
        return
    if trace_out:
        with open(trace_out, "wb") as f:
            f.write(sim.trace.to_perfetto_json())
    if trace_summary:
        from repro_torch.telemetry.traceview import summary_json
        out = sim.trace.to_summary()
        out["breakdown"] = summary_json(sim.trace)
        with open(trace_summary, "w") as f:
            json.dump(out, f)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, scenario = build_config(args)
    report, sim = run_leg(cfg, scenario)
    write_trace(sim, args.trace_out, args.trace_summary_json)
    summary = report.to_dict(with_traces=args.traces)
    legs = Legs(cfg, scenario, report)

    violations = list(report.violations)
    if report.bundles_completed:
        if not (report.latency_p99_s > report.latency_p50_s > 0):
            violations.append(
                f"degenerate latency percentiles (p50={report.latency_p50_s}, "
                f"p99={report.latency_p99_s})")
    else:
        violations.append("no bundles completed")

    if args.compare_frozen and not args.frozen_weights:
        block, bad = frozen_compare(legs)
        summary.update(block)
        violations += bad
    if args.compare_policy:
        summary["policy_compare"], bad = policy_compare(legs)
        violations += bad
    if args.tournament:
        summary["tournament"], bad = tournament(legs, args.tournament, args.scenario)
        violations += bad

    summary["violations"] = violations
    print(json.dumps(summary, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    print(_lib.launch_line(), file=sys.stderr, flush=True)
    if violations:
        print("FAILED: " + "; ".join(violations), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
