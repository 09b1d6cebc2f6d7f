"""Closed-loop scenario driver: the full paper loop on one host and one card.

    DAQ triggers -> segmentation -> WAN (loss/dup/reorder) -> LB route
      -> per-member pack -> per-member batched reassembly -> telemetry
      -> CP reweight -> hit-less epoch switch -> back around.

The port of the JAX package's ``scripts/run_closed_loop.py``. Its per-step
``--engine loop`` runs through the port's entry points: one ``segment_bundles``
pass, one ``deliver_batch`` permutation (threefry draws on the device), one
``DataPlane.route_window`` (the ``lb_route`` kernel), one ``DataPlane.plan``
+ ``combine`` pack of the routed window (the ``dispatch_plan`` kernel), and
one device reassembly plan per member per step (the ``seg_masks`` kernel).
The control plane consumes the real incomplete-buffer backlog.
``--engine fused|host`` runs the same closed loop on the virtual-time
simulator (``simnet``) instead, with the WAN loss/dup knobs on its WAN link
and the straggler as a 4x slow farm member; ``--metrics-interval`` runs the
live metrics registry (the loop and the host engine).

Scenarios (``--scenario``):
  baseline   clean WAN, static membership
  loss       packet loss -> incomplete buffers -> timeout accounting
  reorder    deep reorder window, duplicates constrained to follow originals
  straggler  one member reports 4x step time; CP must shed its weight
  elastic    members join at 1/3 and leave at 2/3 of the run

The summary has the reference driver's keys and, from the same seed and
sizes, the same values (``wall_s`` aside; with ``--engine fused|host``
also ``packets_per_sec``). Exits non-zero if an invariant breaks: an event
split across members, a corrupt bundle, unaccounted segments, a pack that
dropped or lost a packet; 2 for ``--engine fused|host`` with the elastic
scenario.

    PYTHONPATH=src python -m repro_torch.closed_loop --steps 50 [--device cpu]
    PYTHONPATH=src python -m repro_torch.closed_loop --steps 50 --engine host
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core import EpochManager, MemberSpec
from repro_torch.core.control_plane import LoadBalancerControlPlane
from repro_torch.core.dataplane import DataPlaneCache
from repro_torch.core.protocol import words_to_tensor
from repro_torch.data.daq import DAQConfig, DAQFleet
from repro_torch.data.segmentation import (DEFAULT_MTU_PAYLOAD, group_rows,
                                           segment_bundles)
from repro_torch.data.transport import TransportConfig, WANTransport
from repro_torch.kernels import _lib
from repro_torch.telemetry.metrics import TelemetryHub

SCENARIOS = ("baseline", "loss", "reorder", "straggler", "elastic")
PHASES = ("daq", "segment", "wan", "route", "pack", "reassembly", "control")

#: The full-width straggler loop (add ``--steps``): the paper's LB with 512
#: member slots, 64 members of 4 lanes, 16 DAQs, 128 triggers of 64 kB mean
#: bundles per step (~2k bundles, ~16k packets per window) in jumbo frames.
FULL_WIDTH = ["--scenario", "straggler", "--n-members", "64", "--n-daqs", "16",
              "--triggers-per-step", "128", "--mean-bundle-bytes", "64000",
              "--mtu-payload", str(DEFAULT_MTU_PAYLOAD), "--max-members", "512",
              "--lane-bits", "2", "--loss", "0.01", "--dup", "0.01",
              "--reorder-window", "256", "--reweight-every", "5",
              "--timeout-windows", "4"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scenario", choices=SCENARIOS, default="baseline")
    ap.add_argument("--triggers-per-step", type=int, default=2)
    ap.add_argument("--n-members", type=int, default=6)
    ap.add_argument("--n-daqs", type=int, default=3)
    ap.add_argument("--mean-bundle-bytes", type=int, default=12_000)
    ap.add_argument("--mtu-payload", type=int, default=2048)
    ap.add_argument("--max-members", type=int, default=None,
                    help="member table size (default max(64, 4 * n_members), "
                         "as the reference driver)")
    ap.add_argument("--lane-bits", type=int, default=1)
    ap.add_argument("--loss", type=float, default=None,
                    help="override the scenario's loss probability")
    ap.add_argument("--dup", type=float, default=None)
    ap.add_argument("--reorder-window", type=int, default=None)
    ap.add_argument("--reweight-every", type=int, default=5)
    ap.add_argument("--timeout-windows", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=["loop", "fused", "host"], default="loop",
                    help="loop = this module's inline per-step loop; "
                         "fused/host = run the equivalent virtual-time "
                         "simulation through simnet's fused (CUDA-graph "
                         "superblock) or host engine")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="emit a metrics time-series row every N steps "
                         "(enables the live registry; the loop and the host "
                         "engine). 0 = off")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="JSONL path for --metrics-interval rows")
    ap.add_argument("--json", default=None, help="write the summary here")
    return ap.parse_args(argv)


def scenario_transport(args) -> TransportConfig:
    loss, dup, window = 0.0, 0.0, 16
    if args.scenario == "loss":
        loss, dup = 0.05, 0.02
    elif args.scenario == "reorder":
        dup, window = 0.05, 256
    return TransportConfig(
        reorder_window=window if args.reorder_window is None else args.reorder_window,
        loss_prob=loss if args.loss is None else args.loss,
        duplicate_prob=dup if args.dup is None else args.dup,
        seed=args.seed,
    )


def run_simulator(args) -> int:
    """--engine fused/host: the same closed loop on the virtual-time
    simulator (``simnet``), where the engine choice is meaningful. The WAN
    loss/dup knobs map onto the simnet WAN link; ``reorder`` arrives via
    jitter (the simnet WAN has no explicit reorder window)."""
    from repro_torch.simnet import SimConfig, Simulator
    from repro_torch.simnet.links import LinkConfig

    if args.scenario == "elastic":
        print("--engine fused/host does not support the elastic scenario "
              "(membership hooks run per-step on host); use --engine loop",
              file=sys.stderr)
        return 2
    tcfg = scenario_transport(args)
    scale = None
    if args.scenario == "straggler":
        scale = np.ones((args.n_members,))
        scale[0] = 4.0
    cfg = SimConfig(
        steps=args.steps, n_members=args.n_members, n_daqs=args.n_daqs,
        triggers_per_step=args.triggers_per_step,
        mean_bundle_bytes=args.mean_bundle_bytes,
        mtu_payload=args.mtu_payload, seed=args.seed, device=args.device,
        wan=LinkConfig(prop_delay_s=1e-3, jitter_s=2e-4,
                       loss_prob=tcfg.loss_prob,
                       duplicate_prob=tcfg.duplicate_prob, seed=args.seed),
        service_scale=scale, reweight_every=args.reweight_every,
        timeout_windows=max(args.timeout_windows, 1), engine=args.engine,
        metrics_every=(max(args.metrics_interval, 1)
                       if args.metrics_interval or args.metrics_jsonl else 0),
        metrics_path=args.metrics_jsonl)
    report = Simulator(cfg).run()
    summary = report.to_dict()
    print(json.dumps(summary, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    violations = list(report.violations)
    if args.scenario == "straggler" and args.steps >= 20:
        weights = {int(k): v for k, v in report.final_weights.items()}
        w = weights.get(0, 1.0)
        if w >= 1.0:
            violations.append(f"straggler weight not shed (w={w:.2f})")
    if violations:
        print("FAILED: " + "; ".join(violations), file=sys.stderr)
        return 1
    return 0


@dataclasses.dataclass
class LoopResult:
    summary: dict                 # the reference driver's summary keys
    phase_s: dict                 # host seconds per phase, summed over steps
    step_s: list                  # host seconds per step
    step_launches: list           # kernel launches per step (``_lib.LAUNCHES`` deltas)
    windows: list = dataclasses.field(default_factory=list)  # packets arrived per step
    packets_routed: int = 0
    packets_packed: int = 0
    pack_dropped: int = 0


def run(args) -> LoopResult:
    """Run the loop; the summary carries the invariant violations."""
    t_start = time.perf_counter()
    device = torch.device(args.device)
    max_members = args.max_members or max(64, 4 * args.n_members)

    em = EpochManager(max_members=max_members)
    cp = LoadBalancerControlPlane(em)
    # Event numbers advance ~4 per trigger; place epoch boundaries a couple
    # of steps out so reconfigurations take effect within the run.
    cp.policy.epoch_horizon = max(16, 8 * args.triggers_per_step)
    members = {i: MemberSpec(node_id=i, lane_bits=args.lane_bits)
               for i in range(args.n_members)}
    cp.start(members)
    hub = TelemetryHub(queue_capacity=16)
    fleet = DAQFleet(DAQConfig(
        n_daqs=args.n_daqs, seq_len=32,
        mean_bundle_bytes=args.mean_bundle_bytes, seed=args.seed))
    wan = WANTransport(scenario_transport(args), device=device)
    dp_cache = DataPlaneCache(em, device=device)

    reassemblers: dict[int, object] = {}
    reported_timeouts: dict[int, int] = defaultdict(int)

    metrics = ts_writer = None
    if args.metrics_interval or args.metrics_jsonl:
        from repro_torch.telemetry.export import TimeSeriesWriter
        from repro_torch.telemetry.registry import MetricsRegistry
        metrics = MetricsRegistry()
        mx_windows = metrics.counter("loop_windows_total",
                                     "Ingest windows completed.")
        mx_step = metrics.histogram("loop_step_seconds",
                                    "Wall time per ingest window.")
        metrics.gauge("loop_bundles_completed", "Bundles fully reassembled."
                      ).set_function(lambda: completed)
        metrics.gauge("loop_epoch_switches",
                      "Hit-less epoch switches scheduled."
                      ).set_function(lambda: epoch_switches)
        if args.metrics_jsonl:
            ts_writer = TimeSeriesWriter(args.metrics_jsonl, metrics)

    def reassembler(member: int):
        if member not in reassemblers:
            reassemblers[member] = dp_cache.get().make_reassembler(
                mtu_payload=args.mtu_payload,
                timeout_windows=args.timeout_windows, device_plan=True)
        return reassemblers[member]

    straggler = 0 if args.scenario == "straggler" else None
    event_members: dict[int, set[int]] = defaultdict(set)
    sent_bundles = completed = corrupt = discarded = epoch_switches = 0
    joined: list[int] = []
    removed: list[int] = []
    phase_s = dict.fromkeys(PHASES, 0.0)
    step_s: list[float] = []
    step_launches: list[dict] = []
    windows: list[int] = []
    routed = packed = pack_dropped = 0
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        phase_s[phase] += now - clock[0]
        clock[0] = now

    def end_step(t_step0, launches0):
        step_s.append(time.perf_counter() - t_step0)
        step_launches.append({k: n - launches0[k] for k, n in _lib.LAUNCHES.items()})
        if metrics is not None:
            mx_step.observe(step_s[-1])
            mx_windows.inc()

    for step in range(args.steps):
        t_step0 = clock[0] = time.perf_counter()
        launches0 = dict(_lib.LAUNCHES)
        # -- elastic membership ------------------------------------------------
        if args.scenario == "elastic":
            if step == args.steps // 3 and not joined:
                new_ids = [max(cp.members) + 1 + k for k in range(2)]
                cp.add_members({i: MemberSpec(node_id=i, lane_bits=args.lane_bits)
                                for i in new_ids})
                cp.schedule_epoch(fleet.event_number)
                joined = new_ids
            if step == (2 * args.steps) // 3 and not removed:
                removed = [min(members)]
                cp.mark_failed(removed)
                cp.schedule_epoch(fleet.event_number)

        # -- one ingest window -------------------------------------------------
        bundles = fleet.bundle_window(args.triggers_per_step)
        sent_bundles += len(bundles)
        expected = {(b.event_number, b.daq_id): b.payload for b in bundles}
        lap("daq")
        batch = segment_bundles(bundles, args.mtu_payload)
        lap("segment")
        arrived = wan.deliver_batch(batch)
        windows.append(len(arrived))
        lap("wan")
        if len(arrived) == 0:
            end_step(t_step0, launches0)
            continue
        dp = dp_cache.get()
        member, _node, _lane, valid = dp.route_window(arrived)
        discarded += int((~valid).sum())
        routed += int(valid.sum())
        for ev, m in zip(arrived.event_number[valid].tolist(),
                         member[valid].tolist()):
            event_members[ev].add(m)
        lap("route")

        # -- LB -> CN pack of the routed window ---------------------------------
        member_t = torch.from_numpy(member).to(device)
        pos, counts = dp.plan(member_t, n_members=max_members)
        capacity = max(int(counts.max()), 1)
        _buf, occ, dropped = dp.combine(
            words_to_tensor(arrived.headers, device), member_t, pos,
            n_members=max_members, capacity=capacity)
        packed += int(occ.sum())
        pack_dropped += int(dropped)
        lap("pack")

        # -- per-member batched reassembly (one grouping pass) ----------------
        rows_ok = np.flatnonzero(valid)
        mem_ids, groups = group_rows(member[rows_ok])
        for m, grp in zip(mem_ids.tolist(), groups):
            sel = rows_ok[grp]
            ra = reassembler(m)
            done = ra.push_batch(arrived.take(sel))
            completed += len(done)
            for key, payload in ra.drain_completed():
                want = expected.get(key)
                if want is not None and not np.array_equal(payload, want):
                    corrupt += 1
            # Synthetic processing-cost model: unit cost per segment, with
            # the straggler running 4x slow — what the CP must detect.
            step_time = 1e-3 * max(len(sel), 1) \
                * (4.0 if m == straggler else 1.0)
            backlog = ra.n_incomplete
            hub.report_step(m, step_time=step_time,
                            backlog=backlog, processed=len(done))
            new_timeouts = ra.stats.n_timed_out_groups - reported_timeouts[m]
            reported_timeouts[m] = ra.stats.n_timed_out_groups
            hub.report_ingest(m, pending=backlog,
                              completed=len(done), timed_out=new_timeouts)
        lap("reassembly")

        # -- control loop ------------------------------------------------------
        if args.reweight_every and (step + 1) % args.reweight_every == 0:
            eid = cp.feedback(hub.snapshot(), fleet.event_number)
            if eid is not None:
                epoch_switches += 1
            cp.garbage_collect(fleet.event_number)
        lap("control")
        end_step(t_step0, launches0)
        if ts_writer is not None and (step + 1) % max(args.metrics_interval, 1) == 0:
            ts_writer.write(step=step)
    if ts_writer is not None:
        ts_writer.close()

    # -- audit ----------------------------------------------------------------
    split_events = sum(1 for ms in event_members.values() if len(ms) > 1)
    pending = sum(ra.n_incomplete for ra in reassemblers.values())
    timed_out = sum(ra.stats.n_timed_out_groups for ra in reassemblers.values())
    dups = sum(ra.stats.n_duplicate for ra in reassemblers.values())
    summary = {
        "scenario": args.scenario,
        "steps": args.steps,
        "bundles_sent": sent_bundles,
        "bundles_completed": completed,
        "bundles_pending": pending,
        "bundles_timed_out": timed_out,
        "segments_lost": wan.n_lost,
        "segments_duplicated": wan.n_dup,
        "duplicates_absorbed": dups,
        "packets_discarded": discarded,
        "split_events": split_events,
        "corrupt_bundles": corrupt,
        "epoch_switches": epoch_switches,
        "final_weights": {str(k): round(v, 4) for k, v in cp.weights.items()},
        "members_joined": joined,
        "members_removed": removed,
        "wall_s": round(time.perf_counter() - t_start, 3),
    }
    violations = []
    if split_events:
        violations.append(f"{split_events} events split across members")
    if corrupt:
        violations.append(f"{corrupt} corrupt bundles")
    if completed + pending + timed_out < sent_bundles and wan.n_lost == 0:
        violations.append("bundles unaccounted with zero loss")
    if straggler is not None and args.steps >= 20:
        w = cp.weights.get(straggler, 1.0)
        if w >= 1.0:
            violations.append(f"straggler weight not shed (w={w:.2f})")
    if joined:
        served = {m for ms in event_members.values() for m in ms}
        if not set(joined) & served:
            violations.append("joined members received no traffic")
    if pack_dropped or packed != routed:
        violations.append(f"pack placed {packed} of {routed} routed packets "
                          f"({pack_dropped} dropped)")
    summary["violations"] = violations
    return LoopResult(summary=summary, phase_s=phase_s, step_s=step_s,
                      step_launches=step_launches, windows=windows,
                      packets_routed=routed, packets_packed=packed,
                      pack_dropped=pack_dropped)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.engine != "loop":
        return run_simulator(args)
    res = run(args)
    print(json.dumps(res.summary, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res.summary, f, indent=2)
    if res.summary["violations"]:
        print("FAILED: " + "; ".join(res.summary["violations"]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
