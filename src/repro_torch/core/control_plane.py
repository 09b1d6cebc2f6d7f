"""Control plane: telemetry-driven dynamic load balancing (paper §I-B.4/5).

"Once an experiment starts running, for various reasons some compute nodes
will be faster or slower than others. The load balancer needs a mechanism to
change the weighting of the work it is delivering to each compute node."

The controller consumes per-member telemetry (receive-queue fill fraction and
processing rate — what the real EJ-FAT CP reads from CN daemons; in this
framework: per-DP-worker step time and backlog from telemetry/metrics.py),
produces new calendar weights with a PI controller per member, and schedules
hit-less epoch switches through the EpochManager. It also handles elastic
membership (add/remove CNs mid-run) and straggler mitigation (weight decay
for slow members).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from repro_torch.core.epoch import EpochManager, ReconfigurationError
from repro_torch.core.tables import MemberSpec, TableError

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MemberTelemetry:
    """One feedback sample from a member (CN / DP worker)."""

    fill: float = 0.0          # receive-queue fill fraction in [0, 1]
    rate: float = 1.0          # events/s processed (relative ok)
    healthy: bool = True


@dataclasses.dataclass
class TelemetryArray:
    """One window of telemetry for ``[M]`` members as struct-of-arrays —
    the array-native form ``update_weights``/``feedback`` accept so the
    whole policy update runs as one fused pass (``WeightPolicy.update_lanes``)
    instead of M scalar dict updates.

    ``present[i] = False`` is the array form of a missing dict entry
    (``telemetry.get(mid) is None``): that member's weight and controller
    state are left untouched. ``present & ~healthy`` is an explicit drain."""

    member_ids: np.ndarray      # int64[M]
    fill: np.ndarray            # float64[M]
    rate: np.ndarray            # float64[M]
    healthy: np.ndarray         # bool[M]
    present: Optional[np.ndarray] = None   # bool[M]; None = all present

    @classmethod
    def from_dict(cls, telemetry: dict, member_ids) -> "TelemetryArray":
        """Lift a ``{member_id: MemberTelemetry | None}`` dict onto lanes
        aligned with ``member_ids`` (missing / None -> not present)."""
        ids = np.asarray(list(member_ids), np.int64)
        samples = [telemetry.get(int(m)) for m in ids]
        return cls(
            member_ids=ids,
            fill=np.asarray([0.0 if t is None else t.fill for t in samples],
                            np.float64),
            rate=np.asarray([1.0 if t is None else t.rate for t in samples],
                            np.float64),
            healthy=np.asarray([True if t is None else bool(t.healthy)
                                for t in samples], bool),
            present=np.asarray([t is not None for t in samples], bool))

    def align(self, member_ids) -> "TelemetryArray":
        """Re-lane onto ``member_ids``: members absent from this snapshot
        come back ``present=False`` (scalar-path "no sample"). The common
        case — already in the caller's lane order — is a no-op."""
        ids = np.asarray(member_ids, np.int64)
        if ids.shape == self.member_ids.shape and np.array_equal(
                ids, self.member_ids):
            return self
        if len(self.member_ids) == 0:
            # an empty window (no heartbeats at all) ≡ the empty dict: every
            # member is simply not-present (gathering via src=0 from
            # zero-length arrays would IndexError)
            n = len(ids)
            return TelemetryArray(
                member_ids=ids, fill=np.zeros(n), rate=np.ones(n),
                healthy=np.ones(n, bool), present=np.zeros(n, bool))
        pos = {int(m): i for i, m in enumerate(self.member_ids.tolist())}
        idx = np.asarray([pos.get(int(m), -1) for m in ids.tolist()],
                         np.int64)
        have = idx >= 0
        src = np.where(have, idx, 0)
        present = (np.ones(len(self.member_ids), bool)
                   if self.present is None else self.present)
        return TelemetryArray(
            member_ids=ids,
            fill=np.where(have, self.fill[src], 0.0),
            rate=np.where(have, self.rate[src], 1.0),
            healthy=np.where(have, self.healthy[src], True),
            present=have & present[src])


@dataclasses.dataclass
class ControlPolicy:
    target_fill: float = 0.5   # setpoint for receive-queue occupancy
    kp: float = 0.5            # proportional gain on (target - fill)
    ki: float = 0.1            # integral gain
    min_weight: float = 0.05   # floor so a member stays reachable
    max_weight: float = 8.0
    epoch_horizon: int = 1024  # events in the future to place the boundary


class LoadBalancerControlPlane:
    """Monitors telemetry, recomputes weights, drives epoch transitions.

    The reweighting math itself is pluggable (``repro_torch.controld.policy``):
    ``reweighter`` is any ``WeightPolicy``; the default reproduces the
    historical proportional-PI update built from this instance's
    ``ControlPolicy`` gains. controld reservations select a policy per
    tenant (e.g. the EJFAT-style PID fill controller).
    """

    def __init__(self, manager: EpochManager, policy: ControlPolicy | None = None,
                 reweighter=None):
        self.manager = manager
        self.policy = policy or ControlPolicy()
        if reweighter is None:
            # deferred import: controld builds on core, not the reverse —
            # only the default-policy shim reaches back into controld
            from repro_torch.controld.policy import PolicyConfig, ProportionalPolicy
            p = self.policy
            reweighter = ProportionalPolicy(PolicyConfig(
                target_fill=p.target_fill, kp=p.kp, ki=p.ki,
                min_weight=p.min_weight, max_weight=p.max_weight))
        self.reweighter = reweighter
        # engine for TelemetryArray updates: "np" (bit-identical to the
        # scalar dict path) or "torch" (one fused call on ``array_device``)
        self.array_engine = "np"
        self.array_device = "cuda"
        self.weights: dict[int, float] = {}
        self.members: dict[int, MemberSpec] = {}
        self.gc_skipped: list[tuple[int, str]] = []  # last sweep's (epoch_id, reason)
        self._scheduled_weights: dict[int, float] = {}  # as of the last epoch

    # -- lifecycle -----------------------------------------------------------
    def start(self, members: dict[int, MemberSpec], weights: Optional[dict] = None) -> int:
        self.members = dict(members)
        self.weights = {m: 1.0 for m in members} if weights is None else dict(weights)
        self.reweighter.reset(members)
        eid = self.manager.initialize(self.members, self.weights)
        self._scheduled_weights = dict(self.weights)
        return eid

    # -- feedback ------------------------------------------------------------
    def update_weights(self, telemetry) -> dict[int, float]:
        """One policy update: slow/full members shed slots, fast/empty
        members gain (see the concrete ``WeightPolicy`` for the math).

        ``telemetry`` is either the classic ``{member_id: MemberTelemetry}``
        dict or a ``TelemetryArray`` — the array form runs the whole update
        as one fused ``update_lanes`` pass over every member (the controld
        hot path: no per-member dict churn)."""
        if isinstance(telemetry, TelemetryArray):
            ids = np.fromiter(self.weights.keys(), np.int64,
                              len(self.weights))
            arr = telemetry.align(ids)
            w = np.fromiter(self.weights.values(), np.float64, len(ids))
            new = self.reweighter.update_lanes(
                ids, w, arr.fill, arr.healthy, present=arr.present,
                engine=self.array_engine, device=self.array_device)
            self.weights = {int(m): float(v)
                            for m, v in zip(ids.tolist(), new.tolist())}
        else:
            self.weights = self.reweighter.update(self.weights, telemetry)
        return self.weights

    def feedback(self, telemetry,
                 current_event: int,
                 reweight_threshold: float = 0.05) -> Optional[int]:
        """One closed-loop tick: PI-update the weights from telemetry and, if
        the result differs materially from what the *live epoch* was
        scheduled with (membership delta, a member going to zero / coming
        back, or a relative weight change above ``reweight_threshold``),
        schedule a hit-less epoch switch. Returns the new epoch id, or None
        when the weighting was left in place (no pointless reconfigurations —
        every epoch switch costs calendar rows until the old epoch quiesces).

        Hysteresis: while the previously scheduled boundary is still ahead of
        the traffic (the switch hasn't taken effect), no new epoch is
        scheduled — rescheduling before the last reconfiguration even
        activates would only stack up undrained future epochs and exhaust
        the calendar rows (paper §III-C: reconfigure, *wait to quiesce*,
        then reconfigure again).
        """
        cur = self.manager.records.get(self.manager.current_epoch)
        if cur is not None and current_event < cur.start_event:
            self.update_weights(telemetry)  # keep integrating telemetry
            return None
        sched = self._scheduled_weights
        new = self.update_weights(telemetry)
        changed = set(sched) != set(new)
        if not changed:
            for mid, w in new.items():
                sw = sched.get(mid, 0.0)
                if (w == 0.0) != (sw == 0.0):
                    changed = True
                    break
                if sw > 0 and abs(w - sw) / sw > reweight_threshold:
                    changed = True
                    break
        if not changed:
            return None
        return self.schedule_epoch(current_event)

    # -- elastic membership ----------------------------------------------------
    def add_members(self, members: dict[int, MemberSpec], weight: float = 1.0) -> None:
        for mid, spec in members.items():
            self.members[mid] = spec
            self.weights[mid] = weight
            self.reweighter.add_member(mid)

    def remove_members(self, member_ids) -> None:
        for mid in member_ids:
            self.members.pop(mid, None)
            self.weights.pop(mid, None)
            self.reweighter.forget_member(mid)

    def mark_failed(self, member_ids) -> None:
        """Fault handling: failed members are removed from the *next* epoch;
        the current epoch is immutable (stateless data plane keeps running)."""
        self.remove_members(member_ids)

    # -- quiesce / garbage collection ---------------------------------------------
    def garbage_collect(self, processed_event: int) -> list[int]:
        """Quiesce every drained epoch (end_event <= high-watermark of
        processed events). The paper's 'after waiting an appropriate time
        for all events from the previous Epoch to have quiesced' — here the
        watermark is explicit. Frees calendar rows + member entries.

        Epochs whose teardown is (legitimately) not yet possible — still
        reachable from the LPM table, or racing a concurrent reconfiguration
        — are recorded in ``gc_skipped`` (reset each sweep, so it reflects
        the most recent pass) and logged, then retried on the next sweep.
        Any other exception is a bug and propagates.
        """
        freed = []
        self.gc_skipped = []
        for eid, rec in sorted(self.manager.records.items()):
            if (rec.active and rec.end_event is not None
                    and rec.end_event <= processed_event
                    and eid != self.manager.current_epoch):
                try:
                    self.manager.quiesce(eid)
                    freed.append(eid)
                except (ReconfigurationError, TableError) as exc:
                    self.gc_skipped.append((eid, str(exc)))
                    logger.warning("gc: skipping epoch %d: %s", eid, exc)
        return freed

    # -- epoch scheduling --------------------------------------------------------
    def schedule_epoch(self, current_event: int, boundary: Optional[int] = None) -> int:
        """Activate the new weighting/membership at a near-future boundary."""
        if boundary is None:
            boundary = current_event + self.policy.epoch_horizon
        # Rapid successive reconfigurations: the boundary must stay strictly
        # ahead of the (possibly just-created) current epoch's start.
        cur = self.manager.records.get(self.manager.current_epoch)
        if cur is not None:
            boundary = max(boundary, cur.start_event + 1)
        live = {m: s for m, s in self.members.items() if self.weights.get(m, 0.0) > 0.0}
        live_w = {m: self.weights[m] for m in live}
        if not live:
            raise RuntimeError("no healthy members to schedule")
        eid = self.manager.reconfigure(live, live_w, boundary)
        self._scheduled_weights = dict(self.weights)
        return eid
