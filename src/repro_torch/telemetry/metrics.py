"""Per-member telemetry: what the control plane consumes.

Mirrors the real EJ-FAT deployment where CN daemons report receive-queue fill
and processing rate back to the control plane. Here members are DP workers
(or serving replicas); fill is estimated from queue depth / step-time EWMAs
plus the reassembly incomplete-buffer backlog reported by the ingest lanes
(``report_ingest``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable

from repro_torch.core.control_plane import MemberTelemetry

# The production metrics surface (Prometheus registry) lives next door in
# telemetry.registry; re-export it here so `telemetry.metrics` is the single
# import point for both the per-member hub and the service-level registry.
from repro_torch.telemetry.registry import (  # noqa: F401  (re-exports)
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
)


@dataclasses.dataclass
class _MemberStats:
    ewma_step_time: float = 0.0
    backlog: int = 0
    processed: int = 0
    healthy: bool = True
    last_seen: float = 0.0
    # ingest-side accounting (reassembly daemons, DESIGN.md §Ingest)
    ingest_pending: int = 0      # incomplete reassembly buffers (groups)
    ingest_completed: int = 0
    ingest_timed_out: int = 0


class TelemetryHub:
    """Collects member reports; emits control-plane telemetry snapshots.

    ``clock`` is injectable (default wall time) so simulated deployments
    (the JAX package's ``repro.simnet``) can run the hub on virtual time. When ``stale_after``
    is set, a member whose last report is older than that many clock ticks is
    reported unhealthy in ``snapshot()`` — the paper's liveness rule: a CN
    daemon that stops feeding back is presumed down and drains hit-lessly.

    ``fill_mode`` selects what ``snapshot()`` calls fill:

    * ``"blend"`` (default) — the legacy estimate for deployments whose
      backlog numbers are coarse (DP workers): half queue fraction, half
      relative slowness vs the fastest member. The slowness term saturates
      fast — any member ~1.4x slower than the fastest reads over-target even
      with an empty queue — which is the right bias when backlog is unreliable
      but *starves* a heterogeneous farm whose queues are actually fine.
    * ``"occupancy"`` — fill IS the measured receive-queue occupancy
      (backlog / queue_capacity), what the real EJ-FAT CN daemons report.
      Service-rate differences only matter through the queues they actually
      build, so a 2x-slow member with an empty queue keeps its share.
      ``repro.simnet`` runs in this mode.
    """

    def __init__(self, alpha: float = 0.2, queue_capacity: int = 64,
                 clock: Callable[[], float] = time.time,
                 stale_after: float | None = None,
                 fill_mode: str = "blend"):
        if fill_mode not in ("blend", "occupancy"):
            raise ValueError(f"unknown fill_mode {fill_mode!r}")
        self.alpha = alpha
        self.queue_capacity = queue_capacity
        self.clock = clock
        self.stale_after = stale_after
        self.fill_mode = fill_mode
        self.members: dict[int, _MemberStats] = defaultdict(_MemberStats)

    def report_step(self, member_id: int, step_time: float, backlog: int = 0,
                    processed: int = 1) -> None:
        s = self.members[member_id]
        s.ewma_step_time = (step_time if s.ewma_step_time == 0
                            else (1 - self.alpha) * s.ewma_step_time
                            + self.alpha * step_time)
        s.backlog = backlog
        s.processed += processed
        s.last_seen = self.clock()

    def report_queue(self, member_id: int, backlog: int) -> None:
        """Queue-depth-only report (no step ran this tick — e.g. an idle
        decode replica). Without it a member's last busy-tick backlog would
        stick forever and keep its fill high after it drained."""
        s = self.members[member_id]
        s.backlog = backlog
        s.last_seen = self.clock()

    def report_ingest(self, member_id: int, pending: int,
                      completed: int = 0, timed_out: int = 0) -> None:
        """Reassembly-lane report: ``pending`` incomplete (event, daq)
        buffers right now (the real receive-queue backlog the paper's CN
        daemons feed back), plus completion/timeout counters. The pending
        backlog folds into the member's queue-fill estimate in snapshot()."""
        s = self.members[member_id]
        s.ingest_pending = pending
        s.ingest_completed += completed
        s.ingest_timed_out += timed_out
        s.last_seen = self.clock()

    def is_stale(self, member_id: int) -> bool:
        """True when the member's last report is older than ``stale_after``."""
        if self.stale_after is None:
            return False
        s = self.members.get(member_id)
        if s is None:
            return True
        return (self.clock() - s.last_seen) > self.stale_after

    def report_failure(self, member_id: int) -> None:
        self.members[member_id].healthy = False

    def report_recovered(self, member_id: int) -> None:
        self.members[member_id].healthy = True

    def snapshot(self) -> dict[int, MemberTelemetry]:
        out = {}
        # stale members must not anchor t_ref: a dead-but-fast node would
        # inflate every live member's relative slowness indefinitely
        times = [s.ewma_step_time for mid, s in self.members.items()
                 if s.healthy and s.ewma_step_time > 0
                 and not self.is_stale(mid)]
        t_ref = min(times) if times else 1.0
        for mid, s in self.members.items():
            if self.is_stale(mid):
                out[mid] = MemberTelemetry(fill=1.0, rate=0.0, healthy=False)
                continue
            # The backlog is whichever queue is deeper: the decode/work queue
            # or the reassembly incomplete-buffer backlog (ingest daemons).
            backlog = max(s.backlog, s.ingest_pending)
            if self.fill_mode == "occupancy":
                fill = min(1.0, backlog / max(self.queue_capacity, 1))
            else:
                # blend: half backlog fraction, half relative slowness — a
                # member 2x slower than the fastest behaves like a 2x-full
                # queue even when its (coarse) backlog number reads low.
                rel = s.ewma_step_time / t_ref if t_ref > 0 else 1.0
                fill = min(1.0, 0.5 * (backlog / max(self.queue_capacity, 1)) +
                           0.5 * (1 - 1 / max(rel, 1e-6)) * 2)
            rate = 1.0 / s.ewma_step_time if s.ewma_step_time > 0 else 1.0
            out[mid] = MemberTelemetry(fill=max(0.0, fill), rate=rate,
                                       healthy=s.healthy)
        return out
