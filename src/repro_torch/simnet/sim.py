"""The virtual-time simulator: DAQ -> links -> LB -> farm queues -> CP loop.

Every packet carries a timestamp from DAQ emission through uplink/WAN
serialization (``simnet.links``), the LB's fixed-latency routing hop
(``DataPlane.route_window`` — the ``lb_route`` kernel on the card), the
per-member downlink, and the CN's bounded receive queue (``simnet.queues``).
End-to-end latency per bundle = service completion of its last segment minus
emission — the paper's fig. 7 metric, measured instead of assumed.

The control loop runs on simulated time: ``TelemetryHub`` gets the virtual
clock injected and consumes *measured* queue occupancy
(``FarmQueues.fill``), and ``LoadBalancerControlPlane.feedback`` closes the
loop at the simulated reweight cadence. ``frozen_weights=True`` disables
feedback — the control run that quantifies what the CP buys (``run.py``'s
``--compare-frozen``).

Multi-instance (paper §I-C): ``n_instances > 1`` stacks per-instance tables
(``DataPlane.from_instances``), partitions the farm and the DAQs across
instances, and runs one control plane per instance — same fused routing
pass, per-packet ``instance_id``.

The port of the JAX package's ``repro.simnet.sim`` with its host engine and
its fused engine (``simnet.fused``). The routing tables, the random draws of
the links and the ``"torch"`` queue engine live on ``SimConfig.device``
(default ``"cuda"``). The controld, HA, tracing and live-metrics options
wait for the port of their modules and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np

from repro_torch.core.control_plane import LoadBalancerControlPlane
from repro_torch.core.dataplane import DataPlane, DataPlaneCache
from repro_torch.core.epoch import EpochManager
from repro_torch.core.protocol import HEADER_BYTES
from repro_torch.core.tables import MemberSpec
from repro_torch.data.daq import DAQConfig, DAQFleet
from repro_torch.data.segmentation import SEG_HDR_BYTES, group_rows, segment_bundles
from repro_torch.device import resolve_device
from repro_torch.simnet.clock import VirtualClock
from repro_torch.simnet.links import Link, LinkConfig, LinkSet
from repro_torch.simnet.queues import FarmConfig, FarmQueues
from repro_torch.telemetry.metrics import TelemetryHub

IP_UDP_BYTES = 28  # IP(20) + UDP(8), matching protocol.MAX_SEGMENT_PAYLOAD

#: options of the reference simulator whose modules are not ported yet
UNPORTED = {
    "controld": "the controld session service (ROADMAP queue 1, item 2: controld)",
    "ha": "controld HA (ROADMAP queue 1, item 2: controld)",
    "trace": "per-bundle tracing (ROADMAP queue 1, item 1: telemetry)",
    "metrics_every": "the metrics registry (ROADMAP queue 1, item 1: telemetry)",
}


@dataclasses.dataclass
class SimConfig:
    """One simulation's shape. Scenario presets override fields of this."""

    steps: int = 100
    n_members: int = 8
    n_daqs: int = 3
    n_instances: int = 1
    triggers_per_step: int = 4
    trigger_period_s: float = 1e-3
    mean_bundle_bytes: int = 12_000
    mtu_payload: int = 2048
    seed: int = 0

    # where the routing tables, the links' random draws and the "torch"
    # queue engine live ("cuda" launches the kernels; "cpu" runs their
    # plain versions)
    device: str = "cuda"
    lb_latency_s: float = 4e-6     # LB data plane (paper §IV: sub-4us pipeline)

    # run engine: "fused" = the device-resident closed loop (simnet.fused;
    # one captured superblock per K windows), which runs configs and
    # scenarios outside its scope on the host engine; "host" = the
    # per-window Python loop below (the parity oracle).
    engine: str = "fused"

    # links
    daq_uplink: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=100e6, jitter_s=2e-5))
    wan: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(prop_delay_s=1e-3, jitter_s=2e-4))
    member_link: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=50e6, prop_delay_s=5e-5,
                                           jitter_s=2e-5))

    # farm service model
    service_per_packet_s: float = 2e-5
    service_per_byte_s: float = 1.25e-7      # = 8 MB/s per member
    queue_capacity_s: float = 0.05
    service_scale: Optional[np.ndarray] = None   # [M] relative slowness
    queue_engine: str = "np"                 # "np" or "torch"

    # control loop
    reweight_every: int = 5
    frozen_weights: bool = False
    timeout_windows: int = 8
    stale_after_s: Optional[float] = None
    queue_capacity_pkts: int = 32            # telemetry backlog granularity

    # not ported yet (see UNPORTED): a run that sets any of them raises; the
    # controld presets also set controld_policy and lease_s
    controld: bool = False
    controld_policy: object = "proportional"
    lease_s: Optional[float] = None
    ha: bool = False
    metrics_every: int = 0
    trace: bool = False

    def window_period_s(self, n_triggers: int, period_scale: float = 1.0) -> float:
        return n_triggers * self.trigger_period_s * period_scale


@dataclasses.dataclass
class SimReport:
    """What a run measured. ``to_dict`` is the JSON form ``run.py`` prints."""

    scenario: str
    steps: int
    sim_time_s: float
    wall_s: float
    packets_sent: int
    packets_delivered: int
    packets_lost_wan: int
    packets_lost_downlink: int
    packets_dropped_queue: int
    packets_discarded_invalid: int
    duplicates_absorbed: int
    bundles_sent: int
    bundles_completed: int
    bundles_pending: int
    bundles_timed_out: int
    bundles_vanished: int          # every segment lost before reassembly
    latency_p50_s: float
    latency_p99_s: float
    latency_max_s: float
    latency_mean_s: float
    epoch_switches: int
    final_weights: dict
    weight_trajectory: list        # [(step, {member: weight})]
    queue_fill_trace: list         # [(t, [fill per member])]
    per_member_segments: dict
    violations: list
    # controld-mode lifecycle accounting (zero: controld is not ported)
    daemon_restarts: int = 0
    leases_expired: int = 0
    heartbeats_rejected: int = 0
    engine: str = "host"           # which engine produced this report
    # HA-mode failover accounting (zero: HA is not ported)
    ha_failovers: int = 0
    ha_revivals: int = 0
    ha_failover_durations: list = dataclasses.field(default_factory=list)

    @property
    def packets_per_sec(self) -> float:
        return self.packets_sent / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self, with_traces: bool = False) -> dict:
        d = dataclasses.asdict(self)
        if not with_traces:
            d.pop("queue_fill_trace")
            d["weight_trajectory"] = d["weight_trajectory"][-3:]
        d["packets_per_sec"] = round(self.packets_per_sec, 1)
        for k, v in list(d.items()):
            if isinstance(v, float):
                d[k] = round(v, 9)
        return d


@dataclasses.dataclass
class Scenario:
    """A named preset: config overrides + live hooks (see scenarios.py)."""

    name: str
    description: str
    expect_cp_gain: bool = False
    overrides: dict = dataclasses.field(default_factory=dict)
    service_scale: Optional[Callable[[int], np.ndarray]] = None
    traffic: Optional[Callable[[int, "SimConfig"], tuple[int, float]]] = None
    # (rng, event_number) -> size multiplier for that trigger's bundles
    trigger_boost: Optional[Callable[[np.random.Generator, int], float]] = None
    on_step: Optional[Callable[["Simulator", int], None]] = None

    def build_config(self, **extra) -> SimConfig:
        cfg = SimConfig(**{**self.overrides, **extra})
        if self.service_scale is not None:
            cfg.service_scale = self.service_scale(cfg.n_members)
        return cfg


def check_ported(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` for an option whose module is not
    ported yet — never run without it quietly."""
    for name, what in UNPORTED.items():
        if getattr(cfg, name):
            raise NotImplementedError(
                f"SimConfig.{name} needs {what}, which is not ported yet")


class Simulator:
    """Drives one scenario end to end on virtual time."""

    def __init__(self, cfg: SimConfig, scenario: Optional[Scenario] = None):
        check_ported(cfg)
        if cfg.n_members % cfg.n_instances:
            raise ValueError("n_members must divide evenly across instances")
        if cfg.n_instances > 1 and cfg.n_daqs < cfg.n_instances:
            raise ValueError("need at least one DAQ per instance")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.scenario = scenario
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(cfg.seed)

        # -- control planes (one per LB instance, paper §I-C) -----------------
        per_inst = cfg.n_members // cfg.n_instances
        self.instance_members: list[list[int]] = [
            list(range(i * per_inst, (i + 1) * per_inst))
            for i in range(cfg.n_instances)]
        self.managers: list[EpochManager] = []
        self.cps: list[LoadBalancerControlPlane] = []
        for ids in self.instance_members:
            em = EpochManager(max_members=max(64, 4 * cfg.n_members))
            cp = LoadBalancerControlPlane(em)
            cp.policy.epoch_horizon = max(16, 8 * cfg.triggers_per_step)
            cp.start({m: MemberSpec(node_id=m, lane_bits=1) for m in ids})
            self.managers.append(em)
            self.cps.append(cp)
        self._dp_cache = DataPlaneCache(self.managers, device=self.device)

        # -- plant: DAQs, links, farm ----------------------------------------
        self.fleet = DAQFleet(DAQConfig(
            n_daqs=cfg.n_daqs, seq_len=32,
            mean_bundle_bytes=cfg.mean_bundle_bytes, seed=cfg.seed,
            token_payload=False))
        self.daq_uplinks = LinkSet([
            dataclasses.replace(cfg.daq_uplink, seed=cfg.seed + 101)
            for _ in range(cfg.n_daqs)], device=self.device)
        self.wan = Link(dataclasses.replace(cfg.wan, seed=cfg.seed + 211),
                        device=self.device)
        self.member_links = LinkSet([
            dataclasses.replace(cfg.member_link, seed=cfg.seed + 307)
            for _ in range(cfg.n_members)], device=self.device)
        self.farm = FarmQueues(
            FarmConfig.uniform(cfg.n_members,
                               per_packet_s=cfg.service_per_packet_s,
                               per_byte_s=cfg.service_per_byte_s,
                               capacity_s=cfg.queue_capacity_s,
                               scale=cfg.service_scale),
            backend=cfg.queue_engine, device=self.device)

        # -- telemetry on the virtual clock ----------------------------------
        self.hub = TelemetryHub(queue_capacity=cfg.queue_capacity_pkts,
                                clock=self.clock.now,
                                stale_after=cfg.stale_after_s,
                                fill_mode="occupancy")
        self.reassemblers: dict[int, object] = {}
        self._reported_timeouts: dict[int, int] = defaultdict(int)

        # -- accounting --------------------------------------------------------
        self.emit_time: dict[tuple[int, int], float] = {}
        self.emit_step: dict[tuple[int, int], int] = {}
        self.bundles_vanished = 0
        self.latencies: list[float] = []
        self.event_members: dict[tuple[int, int], set[int]] = defaultdict(set)
        self.corrupt = 0
        self.discarded = 0
        self.packets_sent = 0
        self.packets_delivered = 0
        self.bundles_sent = 0
        self.epoch_switches = 0
        self.weight_trajectory: list[tuple[int, dict]] = []
        self.queue_fill_trace: list[tuple[float, list[float]]] = []
        self.per_member_segments: dict[int, int] = defaultdict(int)
        self._expected: dict[tuple[int, int], np.ndarray] = {}

    # -- data plane cache (rebuild only after an epoch-state change) ----------
    def dataplane(self) -> DataPlane:
        return self._dp_cache.get()

    def _reassembler(self, member: int):
        if member not in self.reassemblers:
            self.reassemblers[member] = self.dataplane().make_reassembler(
                mtu_payload=self.cfg.mtu_payload,
                timeout_windows=self.cfg.timeout_windows)
        return self.reassemblers[member]

    # -- one window ------------------------------------------------------------
    def step(self, step_idx: int) -> None:
        cfg = self.cfg
        if self.scenario is not None and self.scenario.on_step is not None:
            self.scenario.on_step(self, step_idx)

        n_triggers, period_scale = cfg.triggers_per_step, 1.0
        if self.scenario is not None and self.scenario.traffic is not None:
            n_triggers, period_scale = self.scenario.traffic(step_idx, cfg)
        t0 = self.clock.now()
        window_end = t0 + cfg.window_period_s(n_triggers, period_scale)

        # -- DAQ emission (per-trigger timestamps) ----------------------------
        bundles = self.fleet.bundle_window(n_triggers)
        if self.scenario is not None and self.scenario.trigger_boost is not None:
            boosts = [self.scenario.trigger_boost(
                self.rng, bundles[k * cfg.n_daqs].event_number)
                for k in range(n_triggers)]
            for i, b in enumerate(bundles):
                f = boosts[i // cfg.n_daqs]
                if f > 1.0:
                    b.payload = np.resize(b.payload, int(len(b.payload) * f))
        self.bundles_sent += len(bundles)
        trigger_t = t0 + np.arange(n_triggers) * cfg.trigger_period_s * period_scale
        emit_b = np.repeat(trigger_t, cfg.n_daqs)
        for b, t in zip(bundles, emit_b):
            self.emit_time[(b.event_number, b.daq_id)] = float(t)
            self.emit_step[(b.event_number, b.daq_id)] = step_idx
            self._expected[(b.event_number, b.daq_id)] = b.payload

        # -- segmentation (timestamps ride as a side column) ------------------
        batch = segment_bundles(bundles, cfg.mtu_payload)
        n = len(batch)
        self.packets_sent += n
        bundle_of_row = np.cumsum(batch.seg_index == 0) - 1
        t_emit = emit_b[bundle_of_row]
        wire_bytes = (batch.payload_len.astype(np.float64)
                      + HEADER_BYTES + SEG_HDR_BYTES + IP_UDP_BYTES)

        # -- DAQ uplink serialization + WAN hop -------------------------------
        daq_link = batch.daq_id.astype(np.int64)
        t_up, up_keep = self.daq_uplinks.transit(daq_link, t_emit, wire_bytes)
        rows_up = np.flatnonzero(up_keep)
        delivery = self.wan.transit(t_up[rows_up], wire_bytes[rows_up])
        src = rows_up[delivery.src]
        arrived = batch.take(src)
        t_lb = delivery.t_arrive
        self.packets_delivered += len(arrived)
        if len(arrived) == 0:
            self._post_window(step_idx, window_end, {})
            return

        # -- LB routing: the lb_route kernel, fixed pipeline latency ----------
        # one DAQ -> instance assignment, used by both routing and the audit
        iid_np = (arrived.daq_id % cfg.n_instances).astype(np.uint64)
        member, _node, _lane, valid = self.dataplane().route_window(
            arrived, instance_id=iid_np if cfg.n_instances > 1 else None)
        self.discarded += int((~valid).sum())
        t_out = t_lb + cfg.lb_latency_s
        arrived_bytes = wire_bytes[src]
        # atomicity audit on unique (instance, event, member) triples — one
        # np.unique pass, O(#bundles) not O(#packets) host work
        rows_v = np.flatnonzero(valid)
        triples = np.unique(np.stack(
            [iid_np[rows_v], arrived.event_number[rows_v].astype(np.uint64),
             member[rows_v].astype(np.uint64)], axis=1), axis=0)
        for i, e, m in triples.tolist():
            self.event_members[(int(i), int(e))].add(int(m))

        # -- LB -> CN downlink + bounded receive queue ------------------------
        rows_ok = np.flatnonzero(valid)
        m_ok = member[rows_ok].astype(np.int64)
        t_cn, dl_keep = self.member_links.transit(
            m_ok, t_out[rows_ok], arrived_bytes[rows_ok])
        rows_cn = rows_ok[dl_keep]
        served = self.farm.serve(m_ok[dl_keep], t_cn[dl_keep],
                                 arrived_bytes[rows_ok][dl_keep])
        rows_acc = rows_cn[~served.dropped]
        dep_acc = served.depart[~served.dropped]

        # -- per-member reassembly at service-completion order ----------------
        done_by_member: dict[int, int] = {}
        if len(rows_acc):
            mem_acc = member[rows_acc]
            mem_ids, groups = group_rows(mem_acc)
            for m, grp in zip(mem_ids.tolist(), groups):
                sel = rows_acc[grp]
                dep_sel = dep_acc[grp]
                order = np.argsort(dep_sel, kind="stable")
                ra = self._reassembler(m)
                ra.push_batch(arrived.take(sel[order]))
                self.per_member_segments[m] += len(sel)
                # timed-out bundles will never complete: purge their emit
                # state so lossy soak runs don't grow (and a late duplicate
                # can't resurrect them into a second "completion")
                for key in ra.last_timed_out_keys:
                    self.emit_time.pop(key, None)
                    self.emit_step.pop(key, None)
                    self._expected.pop(key, None)
                completed = ra.drain_completed()
                done_by_member[m] = len(completed)
                if completed:
                    self._record_completions(arrived, sel[order],
                                             dep_sel[order], completed)
        self._post_window(step_idx, window_end, done_by_member,
                          busy_s=served.busy_s, accepted=served.accepted)

    def _record_completions(self, arrived, sel_o, dep_o, completed) -> None:
        """Latency of each completed group: max service completion over the
        FIRST-served copy of each of its segments (FIFO => that is the
        closing row; a duplicate copy served later must not inflate the
        measured latency). Dedup by (event, daq, seg) keeping service order,
        then one sort + reduceat over (event, daq) — O(#bundles) python,
        never O(#packets)."""
        seg3 = ((arrived.event_number[sel_o].astype(np.uint64) << np.uint64(32))
                | (arrived.daq_id[sel_o].astype(np.uint64) << np.uint64(16))
                | arrived.seg_index[sel_o].astype(np.uint64))
        sorder = np.argsort(seg3, kind="stable")  # keeps dep order
        firsts = sorder[np.concatenate(
            [[True], seg3[sorder][1:] != seg3[sorder][:-1]])]
        enc = ((arrived.event_number[sel_o[firsts]].astype(np.uint64) << np.uint64(16))
               | arrived.daq_id[sel_o[firsts]].astype(np.uint64))
        dep_u = dep_o[firsts]
        korder = np.argsort(enc, kind="stable")
        enc_s, dep_s = enc[korder], dep_u[korder]
        starts = np.flatnonzero(np.concatenate([[True], enc_s[1:] != enc_s[:-1]]))
        gmax = np.maximum.reduceat(dep_s, starts)
        uk_enc = enc_s[starts]
        for key, payload in completed:
            emit = self.emit_time.pop(key, None)
            if emit is None:
                continue  # resurrected duplicate group
            self.emit_step.pop(key, None)
            want = self._expected.pop(key, None)
            if want is not None and not np.array_equal(payload, want):
                self.corrupt += 1
            kenc = (int(key[0]) << 16) | int(key[1])
            pos = np.searchsorted(uk_enc, kenc)
            self.latencies.append(float(gmax[pos]) - emit)

    # -- telemetry + control loop at the window boundary -----------------------
    def _post_window(self, step_idx: int, window_end: float,
                     done_by_member: dict[int, int],
                     busy_s: Optional[np.ndarray] = None,
                     accepted: Optional[np.ndarray] = None) -> None:
        """All telemetry is *measured* plant state: queue fill from the
        Lindley backlog, step time from accepted work seconds per segment,
        ingest backlog from the reassemblers — on the virtual clock."""
        cfg = self.cfg
        self.clock.advance_to(window_end)
        fill = self.farm.fill(now=self.clock.now())
        for m in range(cfg.n_members):
            backlog = int(round(fill[m] * cfg.queue_capacity_pkts))
            if (busy_s is not None and accepted is not None
                    and accepted[m] > 0):
                self.hub.report_step(
                    m, step_time=float(busy_s[m] / accepted[m]),
                    backlog=backlog, processed=done_by_member.get(m, 0))
            else:
                self.hub.report_queue(m, backlog)
            ra = self.reassemblers.get(m)
            if ra is not None:
                new_t = ra.stats.n_timed_out_groups - self._reported_timeouts[m]
                self._reported_timeouts[m] = ra.stats.n_timed_out_groups
                self.hub.report_ingest(m, pending=ra.n_incomplete,
                                       completed=done_by_member.get(m, 0),
                                       timed_out=new_t)

        self._purge_vanished(step_idx)

        if (not cfg.frozen_weights and cfg.reweight_every
                and (step_idx + 1) % cfg.reweight_every == 0):
            snap = self.hub.snapshot()
            for cp in self.cps:
                sub = {m: t for m, t in snap.items() if m in cp.members}
                eid = cp.feedback(sub, self.fleet.event_number)
                if eid is not None:
                    self.epoch_switches += 1
                cp.garbage_collect(self.fleet.event_number)
            self.weight_trajectory.append(
                (step_idx, {m: round(w, 4) for cp in self.cps
                            for m, w in cp.weights.items()}))
        self.queue_fill_trace.append(
            (self.clock.now(), [round(float(f), 4) for f in fill]))

    def _purge_vanished(self, step_idx: int) -> None:
        """Bundles that lost every segment before any reassembler saw them
        (WAN/downlink loss, queue drops, discards) never time out anywhere,
        so their emit state would leak in soak runs — purge on a horizon
        comfortably past the reassembly timeout and account them."""
        horizon = max(4 * (self.cfg.timeout_windows or 1), 64)
        if step_idx % 32 == 31:
            dead = [k for k, s in self.emit_step.items()
                    if s < step_idx - horizon]
            for k in dead:
                self.emit_time.pop(k, None)
                self.emit_step.pop(k, None)
                self._expected.pop(k, None)
            self.bundles_vanished += len(dead)

    # -- whole run --------------------------------------------------------------
    def run(self) -> SimReport:
        if self.cfg.engine == "fused":
            from repro_torch.simnet import fused
            if fused.fused_supported(self.cfg, self.scenario):
                return fused.FusedEngine(self).run()
            # outside the fused scope (hooks, >16 members, ...): the host
            # engine, which covers every config
        elif self.cfg.engine != "host":
            raise ValueError(f"unknown engine {self.cfg.engine!r}")
        t_wall = time.perf_counter()
        for i in range(self.cfg.steps):
            self.step(i)
        wall = time.perf_counter() - t_wall

        pending = sum(ra.n_incomplete for ra in self.reassemblers.values())
        timed_out = sum(ra.stats.n_timed_out_groups
                        for ra in self.reassemblers.values())
        dups = sum(ra.stats.n_duplicate for ra in self.reassemblers.values())
        lat = np.asarray(self.latencies)
        completed = len(self.latencies)

        violations = []
        split = sum(1 for ms in self.event_members.values() if len(ms) > 1)
        if split:
            violations.append(f"{split} events split across members")
        if self.corrupt:
            violations.append(f"{self.corrupt} corrupt bundles")
        lossless = (self.wan.n_lost == 0 and self.daq_uplinks.n_lost == 0
                    and self.member_links.n_lost == 0
                    and self.farm.n_dropped == 0 and self.discarded == 0)
        if lossless and completed + pending + timed_out < self.bundles_sent:
            violations.append("bundles unaccounted with zero loss")

        weights = {}
        for cp in self.cps:
            weights.update({str(m): round(w, 4) for m, w in cp.weights.items()})
        return SimReport(
            scenario=self.scenario.name if self.scenario else "custom",
            steps=self.cfg.steps,
            sim_time_s=self.clock.now(),
            wall_s=wall,
            packets_sent=self.packets_sent,
            packets_delivered=self.packets_delivered,
            packets_lost_wan=self.wan.n_lost + self.daq_uplinks.n_lost,
            packets_lost_downlink=self.member_links.n_lost,
            packets_dropped_queue=self.farm.n_dropped,
            packets_discarded_invalid=self.discarded,
            duplicates_absorbed=dups,
            bundles_sent=self.bundles_sent,
            bundles_completed=completed,
            bundles_pending=pending,
            bundles_timed_out=timed_out,
            bundles_vanished=self.bundles_vanished,
            latency_p50_s=float(np.percentile(lat, 50)) if completed else 0.0,
            latency_p99_s=float(np.percentile(lat, 99)) if completed else 0.0,
            latency_max_s=float(lat.max()) if completed else 0.0,
            latency_mean_s=float(lat.mean()) if completed else 0.0,
            epoch_switches=self.epoch_switches,
            final_weights=weights,
            weight_trajectory=self.weight_trajectory,
            queue_fill_trace=self.queue_fill_trace,
            per_member_segments=dict(sorted(self.per_member_segments.items())),
            violations=violations,
        )
