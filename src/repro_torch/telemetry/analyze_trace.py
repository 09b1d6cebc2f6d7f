"""Critical-path analyzer over per-bundle traces.

Runs a traced scenario (or loads a saved trace summary JSON) and prints the
stage-decomposition table for the requested latency percentile: which stage
— uplink serialization, WAN, LB hop, fabric hop, downlink, farm queue wait,
service, reassembly — the percentile bundle actually spent its E2E latency
in, plus the mean decomposition over the whole tail band. The stage sums
must reconcile with the measured E2E latency to < 1% (``--max-rel-err``) or
the run FAILS — the waterfall is an accounting identity, not an estimate.

    PYTHONPATH=src python -m repro_torch.telemetry.analyze_trace --percentile 99
    PYTHONPATH=src python -m repro_torch.telemetry.analyze_trace \\
        --scenario straggler --engine host --percentile 99.9 --perfetto trace.json
    PYTHONPATH=src python -m repro_torch.telemetry.analyze_trace \\
        --fabric elephant_mice --percentile 99
    PYTHONPATH=src python -m repro_torch.telemetry.analyze_trace \\
        --summary trace_summary.json

``--perfetto`` exports Chrome trace-event JSON (open in ui.perfetto.dev);
``--summary-json`` persists the lossless span/completion summary that
``--summary`` reloads. The port of the JAX package's
``scripts/analyze_trace.py``: the same flags and output, plus ``--device``
(default ``cuda``; it raises without CUDA) for the simulator's or the
fabric's run; ``--summary`` touches no device. Each package reads the
other's summary to the same table.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kernels import _lib
from repro_torch.telemetry.trace import TraceBuffer
from repro_torch.telemetry.traceview import (format_table, stage_decomposition,
                                             summary_json)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--scenario", default="baseline",
                     help="simnet scenario to run traced (default: baseline)")
    src.add_argument("--fabric", default=None, metavar="SCENARIO",
                     help="run a fabric scenario instead of a simnet one")
    src.add_argument("--summary", default=None, metavar="JSON",
                     help="load a saved trace summary instead of running")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["fused", "host"], default="fused",
                    help="simnet engine (fused replays the identical span "
                         "set on the host from the device program's rows)")
    ap.add_argument("--device", default="cuda",
                    help="where the simulator or the fabric runs (cuda "
                         "launches the kernels)")
    ap.add_argument("--percentile", type=float, action="append", default=None,
                    help="latency percentile(s) to decompose (default: 99)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="head-sampling rate (tail top-k always retained)")
    ap.add_argument("--trace-tail-k", type=int, default=64)
    ap.add_argument("--max-rel-err", type=float, default=0.01,
                    help="FAIL if |stage sum - e2e| / e2e exceeds this")
    ap.add_argument("--perfetto", default=None, metavar="OUT",
                    help="write Chrome trace-event / Perfetto JSON here")
    ap.add_argument("--summary-json", default=None, metavar="OUT",
                    help="write the lossless span/completion summary and "
                         "the per-stage breakdown JSON here")
    return ap.parse_args(argv)


def run_simnet(args) -> TraceBuffer:
    from repro_torch.simnet import Simulator, get_scenario
    scenario = get_scenario(args.scenario)
    cfg = scenario.build_config(
        steps=args.steps, seed=args.seed, engine=args.engine, trace=True,
        trace_sample=args.trace_sample, trace_tail_k=args.trace_tail_k,
        device=args.device)
    sim = Simulator(cfg, scenario)
    report = sim.run()
    print(f"# simnet {args.scenario} steps={args.steps} "
          f"engine={report.engine} bundles={report.bundles_completed} "
          f"p99={report.latency_p99_s * 1e3:.3f}ms", file=sys.stderr)
    if report.violations:
        print("FAILED: " + "; ".join(report.violations), file=sys.stderr)
        raise SystemExit(1)
    return sim.trace


def run_fabric(args) -> TraceBuffer:
    from repro_torch.fabric import FabricSim, get_fabric_scenario
    sc = get_fabric_scenario(args.fabric)
    extra = dict(seed=args.seed, trace=True,
                 trace_sample=args.trace_sample,
                 trace_tail_k=args.trace_tail_k, device=args.device)
    if args.steps:
        extra["steps"] = args.steps
    sim = FabricSim(sc.build_config(**extra), scenario=sc)
    report = sim.run()
    print(f"# fabric {args.fabric} steps={report.steps} "
          f"bundles={report.bundles_completed} "
          f"p99={report.latency_p99_s * 1e3:.3f}ms", file=sys.stderr)
    if report.violations:
        print("FAILED: " + "; ".join(report.violations), file=sys.stderr)
        raise SystemExit(1)
    return sim.trace


def analyze(tb: TraceBuffer, percentiles, max_rel_err: float = 0.01
            ) -> tuple[list[dict], list[str]]:
    """The stage decomposition at each percentile (None where no retained
    bundle is found) and the failures: a missing bundle, or a stage sum
    more than ``max_rel_err`` from the end-to-end latency."""
    rows, failures = [], []
    for p in percentiles:
        d = stage_decomposition(tb, p)
        rows.append(d)
        if d is None:
            failures.append(f"no retained bundle found for p{p:g}")
        elif d["reconcile_rel_err"] > max_rel_err:
            failures.append(
                f"p{p:g} stage sum does not reconcile with e2e "
                f"({d['reconcile_rel_err'] * 100:.3f}% > "
                f"{max_rel_err * 100:.3f}%)")
    return rows, failures


def write_summary(tb: TraceBuffer, path: str, percentiles) -> None:
    """Lossless spans/completions (reloadable via ``--summary``) plus the
    compact per-stage breakdown."""
    out = tb.to_summary()
    out["breakdown"] = summary_json(tb, tuple(percentiles))
    with open(path, "w") as f:
        json.dump(out, f)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.summary:
        with open(args.summary) as f:
            tb = TraceBuffer.from_summary(json.load(f))
    elif args.fabric:
        tb = run_fabric(args)
    else:
        tb = run_simnet(args)

    percentiles = args.percentile or [99.0]
    rows, failures = analyze(tb, percentiles, args.max_rel_err)
    for d in rows:
        if d is not None:
            print(format_table(d))
            print()

    if args.perfetto:
        with open(args.perfetto, "wb") as f:
            f.write(tb.to_perfetto_json())
        print(f"# perfetto export: {args.perfetto} "
              f"({len(tb.spans()['key'])} spans)", file=sys.stderr)
    if args.summary_json:
        write_summary(tb, args.summary_json, percentiles)
        print(f"# trace summary: {args.summary_json}", file=sys.stderr)
    if not args.summary:
        print(_lib.launch_line(), file=sys.stderr, flush=True)

    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
