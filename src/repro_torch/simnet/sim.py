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

Controld mode (``controld=True``): the CNs are clients of a
``controld.ControlDaemon`` (register / batched heartbeats / leases / ticks on
the virtual clock), optionally an HA cluster of warm standbys
(``ha=True``). Tracing (``trace=True``) records per-bundle stage spans into a
``telemetry.trace.TraceBuffer``; ``metrics_every > 0`` runs a
``telemetry.registry.MetricsRegistry`` over the run.

The port of the JAX package's ``repro.simnet.sim`` with its host engine and
its fused engine (``simnet.fused``). The routing tables, the random draws of
the links and the ``"torch"`` queue engine live on ``SimConfig.device``
(default ``"cuda"``); the daemon's state stays on the host. Tracing and
metrics run on both engines: the fused engine replays them on the host from
its step's returned arrays.
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

    # controld mode: CNs are *clients* of a session-oriented control daemon
    # (controld) — register / heartbeat / lease lifecycle on the virtual
    # clock instead of the embedded per-instance feedback call.
    controld: bool = False
    controld_policy: object = "proportional"  # str, or one str per instance
    controld_policy_params: dict = dataclasses.field(default_factory=dict)
    lease_s: Optional[float] = None          # default: 10 nominal windows

    # controld HA mode (requires controld=True): the CP is an HACluster of
    # warm standbys behind a FailoverTransport whose backoff sleeps *advance
    # the virtual clock* — killing the leader (scenario hook or
    # ha_kill_every) fast-forwards sim time by ~one lease term while the
    # retrying client drives a standby's promotion.
    ha: bool = False
    ha_nodes: int = 2
    ha_term_s: Optional[float] = None        # default: 6 nominal windows
    ha_kill_every: int = 0                   # soak leg: kill leader every N windows

    # observability: metrics_every > 0 enables a MetricsRegistry over the
    # run (E2E latency histogram, queue-fill gauges, window/packet totals)
    # and — when metrics_path is set — appends one JSONL time-series row
    # every that-many windows.
    metrics_every: int = 0
    metrics_path: Optional[str] = None

    # tracing: trace=True attaches a telemetry.trace.TraceBuffer — per-
    # bundle stage spans (head-sampled at trace_sample via mix64 on the
    # event number, plus a top-k tail reservoir of the slowest bundles).
    trace: bool = False
    trace_sample: float = 1.0
    trace_tail_k: int = 64

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
    # controld-mode lifecycle accounting (zero in embedded-CP mode)
    daemon_restarts: int = 0
    leases_expired: int = 0
    heartbeats_rejected: int = 0
    engine: str = "host"           # which engine produced this report
    # HA-mode failover accounting (zero outside cfg.ha)
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


def _rss_bytes() -> float:
    """Current resident set size (Linux /proc; peak-RSS fallback)."""
    try:
        with open("/proc/self/statm") as f:
            import os
            return float(int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        import resource
        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     * 1024)


class Simulator:
    """Drives one scenario end to end on virtual time."""

    def __init__(self, cfg: SimConfig, scenario: Optional[Scenario] = None):
        if cfg.n_members % cfg.n_instances:
            raise ValueError("n_members must divide evenly across instances")
        if cfg.n_instances > 1 and cfg.n_daqs < cfg.n_instances:
            raise ValueError("need at least one DAQ per instance")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.scenario = scenario
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(cfg.seed)

        # -- per-bundle tracing (cfg.trace) — created before the control
        # plane so the daemon can record per-message spans into it
        self.trace = None
        self._trace_pid0 = 0           # delivered-row counter = packet pid
        self._lat_keys: list[int] = []  # bundle key per self.latencies entry
        if cfg.trace:
            from repro_torch.telemetry.trace import TraceBuffer, TraceConfig
            self.trace = TraceBuffer(TraceConfig(
                head_rate=cfg.trace_sample, tail_k=cfg.trace_tail_k,
                seed=cfg.seed))

        # -- control planes (one per LB instance, paper §I-C) -----------------
        per_inst = cfg.n_members // cfg.n_instances
        self.instance_members: list[list[int]] = [
            list(range(i * per_inst, (i + 1) * per_inst))
            for i in range(cfg.n_instances)]
        self.daemon = None
        self.client = None
        self.tokens: list[str] = []
        self.muted: set[int] = set()          # members whose heartbeats stop
        self.daemon_restarts = 0
        self.restart_digest_mismatches = 0
        self.heartbeats_rejected = 0
        # HA-mode state (cfg.ha): the cluster, kill/promotion bookkeeping
        self.cluster = None
        self.ha_failovers = 0
        self.ha_revivals = 0
        self.ha_digest_mismatches = 0
        self.ha_failover_durations: list[float] = []
        self._ha_last_failover_s = 0.0
        self._ha_kill_t: Optional[float] = None
        self._ha_pre_kill_digest: Optional[str] = None
        if cfg.controld:
            self._start_controld()
        else:
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

        # -- live metrics (cfg.metrics_every > 0) -----------------------------
        self.metrics = None
        self._ts_writer = None
        self._lat_emitted = 0
        if cfg.metrics_every > 0:
            self._init_metrics()

    def _init_metrics(self) -> None:
        from repro_torch.telemetry.export import TimeSeriesWriter
        from repro_torch.telemetry.registry import MetricsRegistry
        reg = self.metrics = MetricsRegistry()
        self._lat_hist = reg.histogram(
            "simnet_e2e_latency_seconds",
            "Bundle end-to-end latency (emission -> last-segment service).")
        self._fill_mean = reg.gauge(
            "simnet_queue_fill_mean", "Mean farm queue fill this window.")
        self._fill_max = reg.gauge(
            "simnet_queue_fill_max", "Max farm queue fill this window.")
        self._windows = reg.counter(
            "simnet_windows_total", "Simulated windows completed.")
        # cumulative totals read straight off the simulator at scrape time
        reg.gauge("simnet_packets_sent",
                  "Segments emitted by the DAQ fleet."
                  ).set_function(lambda: self.packets_sent)
        reg.gauge("simnet_packets_delivered",
                  "Segments that survived uplink + WAN."
                  ).set_function(lambda: self.packets_delivered)
        reg.gauge("simnet_bundles_completed",
                  "Bundles fully reassembled."
                  ).set_function(lambda: len(self.latencies))
        reg.gauge("simnet_epoch_switches",
                  "Hit-less epoch switches scheduled by the control loop."
                  ).set_function(lambda: self.epoch_switches)
        # soak-trend gauges (scripts/analyze_soak.py slope-gates these):
        # pending state must stay bounded over a long run, RSS must not creep
        reg.gauge("simnet_bundles_pending",
                  "Bundles emitted but not yet reassembled or timed out "
                  "(in flight + awaiting segments)."
                  ).set_function(
                      lambda: self.bundles_sent - len(self.latencies)
                      - sum(ra.stats.n_timed_out_groups
                            for ra in self.reassemblers.values()))
        reg.gauge("process_rss_bytes",
                  "Resident set size at scrape time (soak growth gate; "
                  "machine state, excluded from engine-parity checks)."
                  ).set_function(_rss_bytes)
        if self.cluster is not None:
            # soak failover leg: analyze_soak gates bounded failover
            # duration and no post-failover RSS/pending slope change
            reg.gauge("controld_ha_failovers",
                      "Leader failovers completed so far."
                      ).set_function(lambda: float(self.ha_failovers))
            reg.gauge("controld_ha_last_failover_s",
                      "Duration of the most recent leader failover in sim "
                      "seconds (0 before the first)."
                      ).set_function(lambda: self._ha_last_failover_s)
        if self.cfg.metrics_path:
            self._ts_writer = TimeSeriesWriter(self.cfg.metrics_path, reg)

    def _emit_metrics(self, step_idx: int, fill) -> None:
        if self.metrics is None:
            return
        new = self.latencies[self._lat_emitted:]
        if new:
            self._lat_hist.observe_many(new)
            if self.trace is not None and self._lat_keys:
                from repro_torch.telemetry.trace import trace_id
                keys = self._lat_keys[self._lat_emitted:]
                self._lat_hist.put_exemplars(
                    new, [trace_id(k) for k in keys])
            self._lat_emitted = len(self.latencies)
        self._windows.inc()
        self._fill_mean.set(float(np.mean(fill)))
        self._fill_max.set(float(np.max(fill)))
        if (self._ts_writer is not None
                and (step_idx + 1) % self.cfg.metrics_every == 0):
            self._ts_writer.write(step=step_idx,
                                  t_sim=round(self.clock.now(), 9))

    # -- controld mode: the CP is a *service* the CNs talk to ------------------
    def _lease_s(self) -> float:
        cfg = self.cfg
        if cfg.lease_s is not None:
            return cfg.lease_s
        base = 10.0 * cfg.window_period_s(cfg.triggers_per_step)
        if cfg.ha:
            # a CN lease must comfortably outlive a leader failover
            # (~1.25x the leadership term): the outage advances virtual
            # time, and a shorter CN lease would lapse farm-wide on
            # every takeover
            base = max(base, 2.5 * self._ha_term_s())
        return base

    def _ha_term_s(self) -> float:
        cfg = self.cfg
        return (cfg.ha_term_s if cfg.ha_term_s is not None
                else 6.0 * cfg.window_period_s(cfg.triggers_per_step))

    def _start_controld(self) -> None:
        """Stand up a ControlDaemon on the virtual clock; every CN registers
        as a client of its instance's reservation (one tenant per virtual LB
        instance) and will heartbeat at window boundaries. HA mode swaps the
        single daemon for an HACluster behind a FailoverTransport whose
        retry sleeps advance the virtual clock — a retrying heartbeat alone
        drives a standby's lease claim and promotion."""
        from repro_torch.controld import (ControlDaemon, ControldClient,
                                    FailoverTransport, HACluster,
                                    InProcTransport, Journal, RetryPolicy)
        cfg = self.cfg
        if cfg.ha:
            term = self._ha_term_s()
            self.cluster = HACluster(
                n_nodes=cfg.ha_nodes, clock=self.clock.now, term_s=term,
                daemon_kwargs=dict(
                    n_instances=cfg.n_instances, lease_s=self._lease_s(),
                    epoch_horizon=max(16, 8 * cfg.triggers_per_step),
                    max_members=max(64, 4 * cfg.n_members)))
            # backoff well under the lease term so promotion overshoot is
            # a fraction of the 1.25x-term failover gate; sleeps advance
            # virtual time (the outage costs sim seconds, not wall time)
            retry = RetryPolicy(base_s=term / 16.0, cap_s=term / 8.0,
                                max_elapsed_s=60.0 * term, seed=cfg.seed)
            transport = FailoverTransport(
                self.cluster.client_endpoints(), retry=retry,
                sleep=self.clock.advance, clock=self.clock.now)
            client = ControldClient(transport, client_id=f"sim{cfg.seed}")
            daemon = self.cluster.leader().daemon
        else:
            daemon = ControlDaemon(
                n_instances=cfg.n_instances, clock=self.clock.now,
                lease_s=self._lease_s(),
                epoch_horizon=max(16, 8 * cfg.triggers_per_step),
                max_members=max(64, 4 * cfg.n_members),
                journal=Journal(), trace=self.trace)
            client = ControldClient(InProcTransport(daemon))
        policies = cfg.controld_policy
        if isinstance(policies, str):
            policies = [policies] * cfg.n_instances
        self.tokens = []
        for inst, ids in enumerate(self.instance_members):
            r = client.reserve(policy=policies[inst], instance_hint=inst,
                               policy_params=cfg.controld_policy_params)
            self.tokens.append(r["token"])
            # whole instance membership in one frame / one journal entry
            reg = client.register_batch(r["token"], ids, lane_bits=1)
            assert not reg["rejected"], reg["rejected"]
        client.tick(current_event=0)  # starts every session (epoch 0)
        self._bind_daemon(daemon, client)

    def _bind_daemon(self, daemon, client) -> None:
        self.daemon = daemon
        self.client = client
        sessions = [daemon.sessions[t] for t in self.tokens]
        self.managers = [s.manager for s in sessions]
        self.cps = [s.cp for s in sessions]

    def _instance_of(self, member: int) -> int:
        return member // (self.cfg.n_members // self.cfg.n_instances)

    def reregister(self, member: int) -> None:
        """A CN whose lease lapsed rejoins its reservation (scenario hook)."""
        self.client.register(self.tokens[self._instance_of(member)],
                             member_id=member, node_id=member, lane_bits=1)

    def restart_daemon(self) -> None:
        """Kill the daemon and recover a fresh one from its journal — the
        hit-less restart scenario. Reservation tokens survive (they are
        deterministic journal state); calendars must come back byte-identical
        (audited via state_digest -> a violation on mismatch)."""
        from repro_torch.controld import ControlDaemon, ControldClient, InProcTransport
        assert self.daemon is not None, "restart_daemon needs controld mode"
        cfg = self.cfg
        digest = self.daemon.state_digest()
        recovered = ControlDaemon.recover(
            self.daemon.journal,
            n_instances=cfg.n_instances, clock=self.clock.now,
            lease_s=self._lease_s(),
            epoch_horizon=max(16, 8 * cfg.triggers_per_step),
            max_members=max(64, 4 * cfg.n_members), trace=self.trace)
        self.daemon_restarts += 1
        if recovered.state_digest() != digest:
            self.restart_digest_mismatches += 1
        self._bind_daemon(recovered, ControldClient(InProcTransport(recovered)))
        # recompile the routing tables from the recovered managers
        self._dp_cache = DataPlaneCache(self.managers, device=self.device)

    def kill_leader(self) -> None:
        """SIGKILL the HA leader (scenario hook / soak leg). Promotion is
        client-driven: this window's heartbeats retry against the standbys
        until the lease lapses and one claims it — ``_ha_after_window``
        then audits the takeover and rebinds the sim to the successor."""
        assert self.cluster is not None, "kill_leader needs controld HA mode"
        leader = self.cluster.leader()
        if leader is None:
            return  # previous kill still failing over
        self._ha_pre_kill_digest = leader.daemon.state_digest()
        self._ha_kill_t = self.clock.now()
        leader.kill()

    def _ha_after_window(self) -> None:
        """Detect a promotion that this window's client traffic drove:
        audit the successor's resume digest against the dead leader's last
        digest (byte-identical or a violation), record the failover
        duration, rebind managers/CPs/routing to the promoted daemon, and
        revive the corpse as a fresh standby (full-backlog catch-up)."""
        lead = self.cluster.leader()
        if lead is None or lead.daemon is self.daemon:
            return
        self.ha_failovers += 1
        dur = 0.0
        if self._ha_kill_t is not None and lead.promoted_at is not None:
            dur = lead.promoted_at - self._ha_kill_t
        self.ha_failover_durations.append(dur)
        self._ha_last_failover_s = dur
        lead.record_failover(dur)
        if (self._ha_pre_kill_digest is not None
                and lead.promoted_digest != self._ha_pre_kill_digest):
            self.ha_digest_mismatches += 1
        self._ha_kill_t = None
        self._ha_pre_kill_digest = None
        self._bind_daemon(lead.daemon, self.client)
        self._dp_cache = DataPlaneCache(self.managers,
                                        device=self.device)
        for node in self.cluster.nodes:
            if not node.alive:
                self.cluster.revive(node)
                self.ha_revivals += 1

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
        tb = self.trace
        if tb is not None:
            from repro_torch.telemetry.trace import bundle_key
            key_b = bundle_key([b.event_number for b in bundles],
                               [b.daq_id for b in bundles])
            tb.record_window("emit_wait", key_b, t0, emit_b)

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
        key_r = pid_r = None
        if tb is not None:
            from repro_torch.telemetry.trace import bundle_key
            key_r = bundle_key(arrived.event_number, arrived.daq_id)
            pid_r = (np.uint64(self._trace_pid0)
                     + np.arange(len(src), dtype=np.uint64))
            self._trace_pid0 += len(src)
            tb.record_window("uplink", key_r, t_emit[src], t_up[src],
                             pid=pid_r)
            tb.record_window("wan", key_r, t_up[src], t_lb, pid=pid_r)
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
        if tb is not None:
            tb.record_window("lb", key_r, t_lb, t_out, pid=pid_r)
            tb.record_window("downlink", key_r[rows_cn], t_out[rows_cn],
                             t_cn[dl_keep], pid=pid_r[rows_cn],
                             aux=m_ok[dl_keep])
            m_acc = m_ok[dl_keep][~served.dropped]
            svc = self.farm.service_time(
                m_acc, arrived_bytes[rows_ok][dl_keep][~served.dropped])
            tb.record_window("farm_wait", key_r[rows_acc],
                             t_cn[dl_keep][~served.dropped], dep_acc - svc,
                             pid=pid_r[rows_acc], aux=m_acc)
            tb.record_window("service", key_r[rows_acc], dep_acc - svc,
                             dep_acc, pid=pid_r[rows_acc], aux=m_acc)

        # -- per-member reassembly at service-completion order ----------------
        done_by_member: dict[int, int] = {}
        traced: list[tuple[int, float, float, float]] = []  # key, t0, t1, emit
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
                                             dep_sel[order], completed, traced)
        if tb is not None and traced:
            rk = np.asarray([k for k, _, _, _ in traced], np.uint64)
            tr_t1 = np.asarray([t1 for _, _, t1, _ in traced])
            tb.record_window("reassembly", rk,
                             np.asarray([t0 for _, t0, _, _ in traced]), tr_t1)
            tb.complete_window(rk, np.asarray([e for _, _, _, e in traced]), tr_t1)
        self._post_window(step_idx, window_end, done_by_member,
                          busy_s=served.busy_s, accepted=served.accepted)

    def _record_completions(self, arrived, sel_o, dep_o, completed,
                            traced: list) -> None:
        """Latency of each completed group: max service completion over the
        FIRST-served copy of each of its segments (FIFO => that is the
        closing row; a duplicate copy served later must not inflate the
        measured latency). Dedup by (event, daq, seg) keeping service order,
        then one sort + reduceat over (event, daq) — O(#bundles) python,
        never O(#packets). With tracing on, each completion's (key, first
        and last service, emission) goes to ``traced``."""
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
        gmin = np.minimum.reduceat(dep_s, starts)
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
            t_done = float(gmax[pos])
            self.latencies.append(t_done - emit)
            if self.trace is not None:
                self._lat_keys.append(kenc)
                traced.append((kenc, float(gmin[pos]), t_done, emit))

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
        if self.trace is not None:
            self.trace.end_window()
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

        if cfg.controld:
            if (self.cluster is not None and cfg.ha_kill_every
                    and (step_idx + 1) % cfg.ha_kill_every == 0
                    and step_idx + 1 < cfg.steps):
                self.kill_leader()
            self._controld_window(step_idx, fill, busy_s, accepted)
            if self.cluster is not None:
                self._ha_after_window()
            self.queue_fill_trace.append(
                (self.clock.now(), [round(float(f), 4) for f in fill]))
            self._purge_vanished(step_idx)
            self._emit_metrics(step_idx, fill)
            return

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
        self._emit_metrics(step_idx, fill)

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

    def _controld_window(self, step_idx: int, fill,
                         busy_s, accepted) -> None:
        """The controld-mode control loop: every live CN heartbeats its
        *measured* occupancy (the same number the embedded hub would call
        fill) — one ``SendStateBatch`` per instance per window, not one
        message per CN — then the daemon ticks at the reweight cadence:
        lease expiry, one fused policy feedback over the member lanes, and
        epoch GC all happen inside the service."""
        cfg = self.cfg
        cap = max(cfg.queue_capacity_pkts, 1)
        if self.trace is not None:
            from repro_torch.telemetry.trace import trace_id
            # window-scoped trace context: daemon-side spans of this
            # window's control messages correlate under one id
            self.client.trace = trace_id((1 << 62) | step_idx)
        for inst, ids in enumerate(self.instance_members):
            live, fills, rates = [], [], []
            for m in ids:
                if m in self.muted:
                    continue  # a silent CN daemon: its lease will lapse
                ra = self.reassemblers.get(m)
                backlog = max(int(round(fill[m] * cap)),
                              ra.n_incomplete if ra is not None else 0)
                rate = 1.0
                if (busy_s is not None and accepted is not None
                        and accepted[m] > 0):
                    step_time = float(busy_s[m] / accepted[m])
                    rate = 1.0 / step_time if step_time > 0 else 1.0
                live.append(m)
                fills.append(min(1.0, backlog / cap))
                rates.append(rate)
            if live:
                reply = self.client.send_state_batch(
                    self.tokens[inst], live, fills, rates)
                # lapsed leases come back as per-member rejections: the
                # protocol says re-register, not heartbeat
                self.heartbeats_rejected += len(reply["rejected"])
        if (not cfg.frozen_weights and cfg.reweight_every
                and (step_idx + 1) % cfg.reweight_every == 0):
            res = self.client.tick(current_event=self.fleet.event_number)
            for r in res["sessions"].values():
                if r.get("epoch") is not None:
                    self.epoch_switches += 1
            self.weight_trajectory.append(
                (step_idx, {m: round(w, 4) for cp in self.cps
                            for m, w in cp.weights.items()}))

    # -- whole run --------------------------------------------------------------
    def run(self) -> SimReport:
        if self.cfg.engine == "fused":
            from repro_torch.simnet import fused
            if fused.fused_supported(self.cfg, self.scenario):
                return fused.FusedEngine(self).run()
            # outside the fused scope (hooks, controld, >16 members, ...):
            # the host engine, which covers every config
        elif self.cfg.engine != "host":
            raise ValueError(f"unknown engine {self.cfg.engine!r}")
        t_wall = time.perf_counter()
        for i in range(self.cfg.steps):
            self.step(i)
        wall = time.perf_counter() - t_wall
        if self._ts_writer is not None:
            self._ts_writer.close()

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
        if self.restart_digest_mismatches:
            violations.append(
                f"{self.restart_digest_mismatches} daemon restarts did not "
                "replay to byte-identical state")
        if self.cluster is not None:
            if self.ha_digest_mismatches:
                violations.append(
                    f"{self.ha_digest_mismatches} failovers resumed from a "
                    "digest differing from the dead leader's last state")
            limit = 1.25 * self._ha_term_s()
            slow = [d for d in self.ha_failover_durations if d > limit]
            if slow:
                violations.append(
                    f"{len(slow)} failovers exceeded 1.25x the lease term "
                    f"(worst {max(slow):.3f}s vs limit {limit:.3f}s)")
            if self._ha_kill_t is not None:
                violations.append(
                    "leader killed but no standby promoted by run end")

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
            daemon_restarts=self.daemon_restarts,
            ha_failovers=self.ha_failovers,
            ha_revivals=self.ha_revivals,
            ha_failover_durations=[round(d, 6)
                                   for d in self.ha_failover_durations],
            leases_expired=(sum(s.counters["leases_expired"]
                                for s in self.daemon.sessions.values())
                            if self.daemon is not None else 0),
            heartbeats_rejected=self.heartbeats_rejected,
        )
