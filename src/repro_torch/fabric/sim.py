"""FabricSim: a two-tier LB fabric on virtual time.

A fleet of DAQs sprays event bundles across a tier of K LB instances via
two-phase VLB (``fabric.spray``), an elephant detector (``fabric.elephant``)
strict-source-routes heavy streams onto reserved calendar lanes, and the
whole plant — DAQ uplinks, per-LB ingress trunks, the inter-LB fabric hop,
per-member downlinks, bounded CN queues — runs on the existing simnet
machinery (token-bucket ``LinkSet`` banks + Lindley ``FarmQueues``).

Lane partition (DESIGN.md §Fabric): every LB instance carries TWO calendars
(stacked as ``DataPlane.from_instances`` entries ``lb*2 + class``): the
*spray* calendar and the *reserved* calendar. With isolation ON the spray
calendar is programmed over the mice members and the reserved calendar over
the last ``reserved_fraction`` of the farm — elephants can't queue a byte on
a mouse's downlink or CN. With isolation OFF both calendars span the whole
farm (the control group the ``elephant_mice`` gate measures against).

Everything is window-atomic struct-of-arrays: one window's segments flow
emission -> uplink -> ingress trunk -> (optional) fabric hop -> owner
calendar -> downlink -> queue as array programs, and every segment is
accounted exactly once (the conservation identity in ``run()`` is a hard
violation, not a best-effort counter). Killing a tier member at a window
boundary is therefore hit-less by construction; the spray plane re-indexes
over the survivors deterministically.

``controld=True`` makes the fabric a first-class tenant of the control
daemon: one ``ReserveFabric`` reservation (2K sessions), members registered
per lane class, and ``kill_lb`` tears the dead LB's sessions down with
``DeregisterBatch`` + ``Free`` — K instances' teardown in 2 frames each.

The port of the JAX package's ``repro/fabric/sim.py``. The stacked tables
of the 2K calendars, the links' random draws and the ``"torch"`` queue
engine live on ``FabricConfig.device`` (default ``"cuda"``): every window
routes in one ``lb_route`` launch on the card, through the kernel's
shared-memory design up to 2K = 12 calendars of 64 member slots and its
"global" design above (K = 8: 16 x 64). Host state (the spray plane, the
detector, the accounting, the daemon) stays numpy and Python.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.control_plane import LoadBalancerControlPlane
from repro_torch.core.dataplane import DataPlaneCache
from repro_torch.core.epoch import EpochManager
from repro_torch.core.protocol import HEADER_BYTES
from repro_torch.core.tables import MemberSpec
from repro_torch.data.segmentation import SEG_HDR_BYTES, next_pow2
from repro_torch.device import resolve_device
from repro_torch.fabric.elephant import ElephantConfig, ElephantDetector
from repro_torch.fabric.spray import spray_paths
from repro_torch.simnet.clock import VirtualClock
from repro_torch.simnet.links import LinkConfig, LinkSet
from repro_torch.simnet.queues import FarmConfig, FarmQueues
from repro_torch.telemetry.trace import TraceBuffer, TraceConfig, bundle_key, trace_id

IP_UDP_BYTES = 28
WIRE_OVERHEAD = HEADER_BYTES + SEG_HDR_BYTES + IP_UDP_BYTES


@dataclasses.dataclass
class FabricConfig:
    """One fabric run's shape. Scenario presets override fields of this."""

    steps: int = 40
    k_lbs: int = 4                 # LB tier size
    n_members: int = 16            # global CN farm (shared by the tier)
    n_daqs: int = 8
    triggers_per_step: int = 4
    trigger_period_s: float = 1e-3
    mean_bundle_bytes: int = 12_000
    daq_scale: Optional[np.ndarray] = None   # [D] per-DAQ size multiplier
    mtu_payload: int = 2048
    seed: int = 0

    # spray plane
    mode: str = "vlb"              # "vlb" | "direct" (per-DAQ static hash)
    isolate: bool = True           # partition the farm across lane classes
    reserved_fraction: float = 0.25
    detector: ElephantConfig = dataclasses.field(
        default_factory=ElephantConfig)

    # LB data plane: where the stacked tables, the links' random draws and
    # the "torch" queue engine live ("cuda" launches the kernels; "cpu" runs
    # their plain versions)
    device: str = "cuda"
    lb_latency_s: float = 4e-6

    # links: per-DAQ uplink, per-LB ingress trunk, per-LB fabric (inter-LB)
    # port, per-member downlink
    daq_uplink: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=400e6, jitter_s=1e-5))
    lb_ingress: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=250e6,
                                           prop_delay_s=2e-4, jitter_s=1e-5))
    lb_fabric: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=250e6,
                                           prop_delay_s=5e-5, jitter_s=1e-5))
    member_link: LinkConfig = dataclasses.field(
        default_factory=lambda: LinkConfig(rate_Bps=50e6,
                                           prop_delay_s=5e-5, jitter_s=1e-5))

    # farm service model (per-member ~50 MB/s default)
    service_per_packet_s: float = 1e-5
    service_per_byte_s: float = 2e-8
    queue_capacity_s: float = 0.05
    queue_engine: str = "np"       # "np" | "torch" (float64 on ``device``)

    # control plane: local calendars (default) or a ReserveFabric tenant
    controld: bool = False
    controld_policy: str = "proportional"
    tick_every: int = 5
    lease_s: Optional[float] = None

    # tracing: per-bundle stage spans (telemetry.trace). Per-LB spans carry
    # the stacked-calendar instance id (lb*2 + class) as ``aux``, so the
    # two VLB hops and the elephant/mice lane split are visible per span;
    # two-hop paths show a distinct "fabric" stage in the span tree.
    trace: bool = False
    trace_sample: float = 1.0
    trace_tail_k: int = 64

    def window_period_s(self) -> float:
        return self.triggers_per_step * self.trigger_period_s


@dataclasses.dataclass
class FabricScenario:
    """A named fabric preset: config overrides + live hooks."""

    name: str
    description: str
    overrides: dict = dataclasses.field(default_factory=dict)
    daq_scale: Optional[Callable[[int], np.ndarray]] = None
    on_step: Optional[Callable[["FabricSim", int], None]] = None

    def build_config(self, **extra) -> FabricConfig:
        cfg = FabricConfig(**{**self.overrides, **extra})
        if self.daq_scale is not None:
            cfg.daq_scale = self.daq_scale(cfg.n_daqs)
        return cfg


@dataclasses.dataclass
class FabricReport:
    """What a fabric run measured (per-class latency is the headline)."""

    scenario: str
    steps: int
    mode: str
    isolate: bool
    k_lbs: int
    sim_time_s: float
    wall_s: float
    # segment conservation (sums exactly to segments_sent; audited in run())
    segments_sent: int
    segments_served: int
    lost_uplink: int
    lost_ingress: int
    lost_fabric: int
    discarded_invalid: int
    lost_downlink: int
    dropped_queue: int
    # bundles: lost = at least one segment lost anywhere
    bundles_sent: int
    bundles_completed: int
    bundles_lost: int
    # latency, fabric-wide and per class
    latency_p50_s: float
    latency_p99_s: float
    latency_max_s: float
    mice_completed: int
    mice_p50_s: float
    mice_p99_s: float
    elephant_completed: int
    elephant_p50_s: float
    elephant_p99_s: float
    # tier balance: bytes traversing each LB (phase 1 + phase 2 arrivals)
    lb_load_bytes: list
    max_lb_load_frac: float
    # detector
    elephants_detected: int
    detector_transitions: int
    lbs_killed: list
    violations: list

    @property
    def packets_per_sec(self) -> float:
        return self.segments_sent / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["packets_per_sec"] = round(self.packets_per_sec, 1)
        for k, v in list(d.items()):
            if isinstance(v, float):
                d[k] = round(v, 9)
        return d


def _pct(lat: np.ndarray, q: float) -> float:
    return float(np.percentile(lat, q)) if len(lat) else 0.0


class FabricSim:
    """Drives one fabric scenario end to end on virtual time."""

    def __init__(self, cfg: FabricConfig,
                 scenario: Optional[FabricScenario] = None,
                 metrics=None):
        if cfg.k_lbs < 1:
            raise ValueError("need at least one LB in the tier")
        if not (0.0 < cfg.reserved_fraction < 1.0):
            raise ValueError("reserved_fraction must be in (0, 1)")
        if cfg.n_members < 2:
            raise ValueError("the lane partition needs >= 2 members")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.scenario = scenario
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(cfg.seed)
        self.trace: Optional[TraceBuffer] = None
        self._trace_pid0 = 0
        if cfg.trace:
            self.trace = TraceBuffer(TraceConfig(
                head_rate=cfg.trace_sample, tail_k=cfg.trace_tail_k,
                seed=cfg.seed))

        m = cfg.n_members
        r = min(max(1, int(round(cfg.reserved_fraction * m))), m - 1)
        self.reserved_members = list(range(m - r, m))
        self.spray_members = list(range(m - r))
        # isolation OFF: both calendars span the whole farm — elephants and
        # mice share every downlink and queue (the control group)
        self._lane_sets = ((self.spray_members, self.reserved_members)
                           if cfg.isolate
                           else (list(range(m)), list(range(m))))

        self.live: list[int] = list(range(cfg.k_lbs))
        self.killed: list[int] = []
        self.daemon = None
        self.client = None
        self.fabric_id = ""
        self.tokens: list[tuple[str, str]] = []
        if cfg.controld:
            self._start_controld()
        else:
            self.managers = []
            for _lb in range(cfg.k_lbs):
                for members in self._lane_sets:
                    em = EpochManager(max_members=max(64, 4 * m))
                    cp = LoadBalancerControlPlane(em)
                    cp.policy.epoch_horizon = max(
                        16, 8 * cfg.triggers_per_step)
                    cp.start({mm: MemberSpec(node_id=mm, lane_bits=1)
                              for mm in members})
                    self.managers.append(em)
        self._dp_cache = DataPlaneCache(self.managers, device=self.device)

        # -- plant ------------------------------------------------------------
        self.daq_scale = (np.ones(cfg.n_daqs)
                          if cfg.daq_scale is None
                          else np.asarray(cfg.daq_scale, np.float64))
        if self.daq_scale.shape != (cfg.n_daqs,):
            raise ValueError("daq_scale must be one multiplier per DAQ")
        dev = self.device
        self.daq_uplinks = LinkSet([
            dataclasses.replace(cfg.daq_uplink, seed=cfg.seed + 11)
            for _ in range(cfg.n_daqs)], device=dev)
        self.lb_ingress = LinkSet([
            dataclasses.replace(cfg.lb_ingress, seed=cfg.seed + 23)
            for _ in range(cfg.k_lbs)], device=dev)
        self.lb_fabric = LinkSet([
            dataclasses.replace(cfg.lb_fabric, seed=cfg.seed + 37)
            for _ in range(cfg.k_lbs)], device=dev)
        self.member_links = LinkSet([
            dataclasses.replace(cfg.member_link, seed=cfg.seed + 53)
            for _ in range(m)], device=dev)
        self.farm = FarmQueues(
            FarmConfig.uniform(m, per_packet_s=cfg.service_per_packet_s,
                               per_byte_s=cfg.service_per_byte_s,
                               capacity_s=cfg.queue_capacity_s),
            backend=cfg.queue_engine, device=dev)
        self.detector = ElephantDetector(cfg.n_daqs, cfg.detector)

        # -- accounting -------------------------------------------------------
        self.event_base = 1
        self.segments_sent = 0
        self.segments_served = 0
        self.lost_uplink = 0
        self.lost_ingress = 0
        self.lost_fabric = 0
        self.discarded = 0
        self.lost_downlink = 0
        self.dropped_queue = 0
        self.bundles_sent = 0
        self.bundles_completed = 0
        self.bundles_lost = 0
        self.lat_mice: list[float] = []
        self.lat_elephant: list[float] = []
        self.lb_load_bytes = np.zeros(cfg.k_lbs, np.float64)
        self.total_wire_bytes = 0.0
        self.event_members: dict[tuple[int, int], set[int]] = defaultdict(set)

        # -- fabric gauges on the metrics registry ----------------------------
        self._g_load = None
        self._g_elephants = None
        if metrics is not None:
            g = metrics.gauge("fabric_lb_load",
                              "Bytes traversing each LB instance.",
                              labelnames=("lb",))
            self._g_load = [g.labels(lb=str(j)) for j in range(cfg.k_lbs)]
            self._g_elephants = metrics.gauge(
                "fabric_elephants",
                "DAQ streams currently classified as elephants.")

    # -- controld: the fabric as a first-class tenant -------------------------
    def _start_controld(self) -> None:
        from repro_torch.controld import (ControlDaemon, ControldClient,
                                          InProcTransport, Journal)
        cfg = self.cfg
        lease = (cfg.lease_s if cfg.lease_s is not None
                 else 10.0 * cfg.steps * cfg.window_period_s())
        self.daemon = ControlDaemon(
            n_instances=2 * cfg.k_lbs, clock=self.clock.now, lease_s=lease,
            epoch_horizon=max(16, 8 * cfg.triggers_per_step),
            max_members=max(64, 4 * cfg.n_members), journal=Journal(),
            device=self.device, trace=self.trace)
        self.client = ControldClient(InProcTransport(self.daemon))
        fab = self.client.reserve_fabric(
            k=cfg.k_lbs, policy=cfg.controld_policy,
            reserved_fraction=cfg.reserved_fraction)
        self.fabric_id = fab["fabric"]
        for sess, members in zip(
                fab["sessions"],
                [self._lane_sets] * cfg.k_lbs):
            spray_set, reserved_set = members
            for token, ids in ((sess["spray"], spray_set),
                               (sess["reserved"], reserved_set)):
                reg = self.client.register_batch(token, ids, lane_bits=1)
                assert not reg["rejected"], reg["rejected"]
            self.tokens.append((sess["spray"], sess["reserved"]))
        self.client.tick(current_event=0)   # starts every session
        # ReserveFabric pops instances in (lb, class) order, so session
        # managers stack exactly as instance_id = lb*2 + class
        self.managers = [self.daemon.sessions[t].manager
                         for pair in self.tokens for t in pair]

    def kill_lb(self, lb: int) -> None:
        """Fail one tier member at a window boundary (hit-less: windows are
        atomic, and the spray plane re-indexes over the survivors). In
        controld mode the dead LB's members drain via one DeregisterBatch
        frame per lane class and both sessions are freed."""
        if lb not in self.live:
            return
        if len(self.live) == 1:
            raise ValueError("cannot kill the last live LB")
        self.live.remove(lb)
        self.killed.append(lb)
        if self.client is not None:
            spray_set, reserved_set = self._lane_sets
            for token, ids in ((self.tokens[lb][0], spray_set),
                               (self.tokens[lb][1], reserved_set)):
                self.client.deregister_batch(token, ids)
                self.client.free(token)

    # -- one window -----------------------------------------------------------
    def step(self, step_idx: int) -> None:
        cfg = self.cfg
        if self.scenario is not None and self.scenario.on_step is not None:
            self.scenario.on_step(self, step_idx)
        t_triggers, d = cfg.triggers_per_step, cfg.n_daqs
        t0 = self.clock.now()
        window_s = cfg.window_period_s()

        # classes come from the detector state as of the PREVIOUS window —
        # classification is causal, never clairvoyant
        elephant_daq = self.detector.elephant

        # -- emission: one bundle per (trigger, DAQ) --------------------------
        ev = (self.event_base + np.arange(t_triggers)).astype(np.uint64)
        self.event_base += t_triggers
        ev_b = np.repeat(ev, d)
        daq_b = np.tile(np.arange(d, dtype=np.int64), t_triggers)
        size_b = np.maximum(
            (cfg.mean_bundle_bytes * self.daq_scale[daq_b]
             * self.rng.gamma(4.0, 0.25, size=len(ev_b))).astype(np.int64),
            64)
        t_emit_b = t0 + np.repeat(np.arange(t_triggers), d) * cfg.trigger_period_s
        klass_b = elephant_daq[daq_b].astype(np.int64)
        inter_b, owner_b, entropy_b = spray_paths(
            ev_b, daq_b, self.live, mode=cfg.mode, seed=cfg.seed)
        tb = self.trace
        if tb is not None:
            key_b = bundle_key(ev_b, daq_b)
            tb.record_window("emit_wait", key_b,
                             np.full(len(ev_b), t0), t_emit_b,
                             aux=klass_b)

        # -- segmentation (struct-of-arrays, one repeat) ----------------------
        nseg_b = np.maximum(
            -(-size_b // cfg.mtu_payload), 1).astype(np.int64)
        bidx = np.repeat(np.arange(len(ev_b)), nseg_b)
        n = len(bidx)
        seg_in_b = np.arange(n) - np.repeat(np.cumsum(nseg_b) - nseg_b,
                                            nseg_b)
        is_last = seg_in_b == nseg_b[bidx] - 1
        payload = np.where(
            is_last, size_b[bidx] - (nseg_b[bidx] - 1) * cfg.mtu_payload,
            cfg.mtu_payload)
        wire = payload.astype(np.float64) + WIRE_OVERHEAD
        self.segments_sent += n
        self.bundles_sent += len(ev_b)
        self.total_wire_bytes += float(wire.sum())
        if tb is not None:
            key_s = key_b[bidx]
            pid_s = np.uint64(self._trace_pid0) + np.arange(n, dtype=np.uint64)
            self._trace_pid0 += n

        # -- DAQ uplink -------------------------------------------------------
        rows = np.arange(n)
        t_arr, keep = self.daq_uplinks.transit(
            daq_b[bidx], t_emit_b[bidx], wire)
        self.lost_uplink += int((~keep).sum())
        rows, t_now = rows[keep], t_arr[keep]
        if tb is not None:
            tb.record_window("uplink", key_s[rows], t_emit_b[bidx[rows]],
                             t_now, pid=pid_s[rows], aux=daq_b[bidx[rows]])

        # -- phase 1: ingress trunk of the intermediate LB --------------------
        inter_s = inter_b[bidx]
        owner_s = owner_b[bidx]
        t_arr, keep = self.lb_ingress.transit(
            inter_s[rows], t_now, wire[rows])
        self.lost_ingress += int((~keep).sum())
        t_in = t_now
        rows, t_now = rows[keep], t_arr[keep] + cfg.lb_latency_s
        self.lb_load_bytes += np.bincount(
            inter_s[rows], weights=wire[rows], minlength=cfg.k_lbs)
        if tb is not None:
            # per-LB + per-class span: aux is the stacked instance id
            tb.record_window("lb", key_s[rows], t_in[keep], t_now,
                             pid=pid_s[rows],
                             aux=inter_s[rows] * 2 + klass_b[bidx[rows]])

        # -- phase 2: inter-LB fabric hop for two-hop rows --------------------
        two_hop = inter_s[rows] != owner_s[rows]
        sub = rows[two_hop]
        if len(sub):
            t_fab, keep_fab = self.lb_fabric.transit(
                inter_s[sub], t_now[two_hop], wire[sub])
            self.lost_fabric += int((~keep_fab).sum())
            landed = sub[keep_fab]
            self.lb_load_bytes += np.bincount(
                owner_s[landed], weights=wire[landed],
                minlength=cfg.k_lbs)
            keep_all = np.ones(len(rows), bool)
            keep_all[two_hop] = keep_fab
            t_merged = t_now.copy()
            t_merged[two_hop] = t_fab + cfg.lb_latency_s
            if tb is not None and len(landed):
                # two-hop rows get a distinct "fabric" span, so VLB paths
                # show up as a deeper span tree than direct one-hop rows
                tb.record_window(
                    "fabric", key_s[landed], t_now[two_hop][keep_fab],
                    t_fab[keep_fab] + cfg.lb_latency_s, pid=pid_s[landed],
                    aux=owner_s[landed] * 2 + klass_b[bidx[landed]])
            rows, t_now = rows[keep_all], t_merged[keep_all]

        # -- the owner's calendar: the production routing engine --------------
        if len(rows):
            iid = (owner_s[rows] * 2 + klass_b[bidx[rows]]).astype(np.int32)
            member, valid = self._route(ev_b[bidx[rows]],
                                        entropy_b[bidx[rows]], iid)
            self.discarded += int((~valid).sum())
            # event-affinity audit on unique (instance, event, member)
            # triples — O(#bundles) host work, never O(#segments)
            rows_v = np.flatnonzero(valid)
            triples = np.unique(np.stack(
                [iid[rows_v].astype(np.uint64),
                 ev_b[bidx[rows[rows_v]]],
                 member[rows_v].astype(np.uint64)], axis=1), axis=0)
            for i, e, mm in triples.tolist():
                self.event_members[(int(i), int(e))].add(int(mm))
            rows, t_now, member = (rows[valid], t_now[valid],
                                   member[rows_v].astype(np.int64))

        # -- downlink + bounded CN queue --------------------------------------
        if len(rows):
            t_arr, keep = self.member_links.transit(member, t_now, wire[rows])
            self.lost_downlink += int((~keep).sum())
            t_in = t_now
            rows, t_now, member = rows[keep], t_arr[keep], member[keep]
            if tb is not None:
                tb.record_window("downlink", key_s[rows], t_in[keep], t_now,
                                 pid=pid_s[rows], aux=member)
        if len(rows):
            served = self.farm.serve(member, t_now, wire[rows])
            acc = ~served.dropped
            self.dropped_queue += int(served.dropped.sum())
            if tb is not None and acc.any():
                svc = self.farm.service_time(member[acc], wire[rows][acc])
                dep_a = served.depart[acc]
                tb.record_window("farm_wait", key_s[rows[acc]], t_now[acc],
                                 dep_a - svc, pid=pid_s[rows[acc]],
                                 aux=member[acc])
                tb.record_window("service", key_s[rows[acc]], dep_a - svc,
                                 dep_a, pid=pid_s[rows[acc]],
                                 aux=member[acc])
            rows, dep = rows[acc], served.depart[acc]
        else:
            dep = np.empty((0,), np.float64)
        self.segments_served += len(rows)

        # -- bundle completion: all segments served ---------------------------
        nb = len(ev_b)
        got = np.bincount(bidx[rows], minlength=nb)
        done = got == nseg_b
        if done.any():
            t_done = np.full(nb, -np.inf)
            np.maximum.at(t_done, bidx[rows], dep)
            lat = t_done[done] - t_emit_b[done]
            kd = klass_b[done]
            self.lat_mice.extend(lat[kd == 0].tolist())
            self.lat_elephant.extend(lat[kd == 1].tolist())
            if tb is not None:
                rmin = np.full(nb, np.inf)
                np.minimum.at(rmin, bidx[rows], dep)
                tb.record_window("reassembly", key_b[done], rmin[done],
                                 t_done[done], aux=klass_b[done])
                tb.complete_window(key_b[done], t_emit_b[done], t_done[done])
        self.bundles_completed += int(done.sum())
        self.bundles_lost += int(nb - done.sum())

        # -- detector + gauges at the window boundary -------------------------
        emitted = np.bincount(daq_b[bidx], weights=wire, minlength=d)
        mask = self.detector.update(emitted, window_s)
        if self._g_load is not None:
            for j, g in enumerate(self._g_load):
                g.set(float(self.lb_load_bytes[j]))
            self._g_elephants.set(float(mask.sum()))

        self.clock.advance_to(t0 + window_s)
        if tb is not None:
            tb.end_window()
        if (self.client is not None and cfg.tick_every
                and (step_idx + 1) % cfg.tick_every == 0):
            if tb is not None:
                self.client.trace = trace_id((1 << 62) | step_idx)
            self.client.tick(current_event=int(self.event_base))

    def _route(self, ev, entropy, iid) -> tuple[np.ndarray, np.ndarray]:
        """Route one window through the stacked calendars in one
        ``lb_route`` launch, padded to a power of two so window-size jitter
        keeps the launch shapes few (padding rows route harmlessly and are
        sliced away)."""
        n = len(ev)
        size = next_pow2(n)
        ev_p = np.zeros(size, np.uint64)
        en_p = np.zeros(size, np.uint32)
        iid_p = np.zeros(size, np.int32)
        ev_p[:n], en_p[:n], iid_p[:n] = ev, entropy, iid
        r = self._dp_cache.get().route_events(ev_p, en_p, instance_id=iid_p)
        member, valid = torch.stack([r.member, r.valid.to(torch.int32)])[:, :n].cpu().numpy()
        return member, valid.astype(bool)

    # -- whole run ------------------------------------------------------------
    def run(self) -> FabricReport:
        t_wall = time.perf_counter()
        for i in range(self.cfg.steps):
            self.step(i)
        wall = time.perf_counter() - t_wall

        violations = []
        split = sum(1 for ms in self.event_members.values() if len(ms) > 1)
        if split:
            violations.append(
                f"{split} (instance, event) pairs split across members")
        accounted = (self.segments_served + self.lost_uplink
                     + self.lost_ingress + self.lost_fabric + self.discarded
                     + self.lost_downlink + self.dropped_queue)
        if accounted != self.segments_sent:
            violations.append(
                f"segment conservation broken: {self.segments_sent} sent, "
                f"{accounted} accounted")
        if self.bundles_completed + self.bundles_lost != self.bundles_sent:
            violations.append("bundle conservation broken")
        for lb in self.killed:
            if self.lb_load_bytes[lb] > 0 and lb in self.live:
                violations.append(f"killed LB {lb} still live")

        lat_all = np.asarray(self.lat_mice + self.lat_elephant)
        lat_m = np.asarray(self.lat_mice)
        lat_e = np.asarray(self.lat_elephant)
        total = max(self.total_wire_bytes, 1.0)
        return FabricReport(
            scenario=self.scenario.name if self.scenario else "custom",
            steps=self.cfg.steps,
            mode=self.cfg.mode,
            isolate=self.cfg.isolate,
            k_lbs=self.cfg.k_lbs,
            sim_time_s=self.clock.now(),
            wall_s=wall,
            segments_sent=self.segments_sent,
            segments_served=self.segments_served,
            lost_uplink=self.lost_uplink,
            lost_ingress=self.lost_ingress,
            lost_fabric=self.lost_fabric,
            discarded_invalid=self.discarded,
            lost_downlink=self.lost_downlink,
            dropped_queue=self.dropped_queue,
            bundles_sent=self.bundles_sent,
            bundles_completed=self.bundles_completed,
            bundles_lost=self.bundles_lost,
            latency_p50_s=_pct(lat_all, 50),
            latency_p99_s=_pct(lat_all, 99),
            latency_max_s=float(lat_all.max()) if len(lat_all) else 0.0,
            mice_completed=len(lat_m),
            mice_p50_s=_pct(lat_m, 50),
            mice_p99_s=_pct(lat_m, 99),
            elephant_completed=len(lat_e),
            elephant_p50_s=_pct(lat_e, 50),
            elephant_p99_s=_pct(lat_e, 99),
            lb_load_bytes=[round(float(b), 1) for b in self.lb_load_bytes],
            max_lb_load_frac=float(self.lb_load_bytes.max()) / total,
            elephants_detected=int(self.detector.ever_elephant.sum()),
            detector_transitions=self.detector.transitions,
            lbs_killed=list(self.killed),
            violations=violations,
        )
