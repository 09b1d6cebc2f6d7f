"""End-to-end data pipeline: DAQs -> segmentation -> WAN transport -> LB
route -> per-member receive lanes -> reassembly -> training batches.

Every stage is batched: one vectorized segmentation pass per trigger window
(``segment_bundles``), one masked-permutation WAN pass
(``WANTransport.deliver_batch``), one ``DataPlane.route`` kernel launch, and
one sort-based reassembly plan per receive lane (``BatchReassembler``) — no
per-packet Python loop anywhere. ``device`` (default ``"cuda"``) is where
the WAN draws and the routing run; it raises when CUDA is missing.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.dataplane import DataPlane, DataPlaneCache
from repro_torch.core.epoch import EpochManager
from repro_torch.data.daq import DAQConfig, DAQFleet
from repro_torch.data.reassembly import BatchReassembler, ReassemblyStats
from repro_torch.data.segmentation import (
    DEFAULT_MTU_PAYLOAD,
    PacketBatch,
    group_rows,
    segment_bundles,
)
from repro_torch.data.transport import TransportConfig, WANTransport
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineStats:
    n_packets: int = 0
    n_routed: int = 0
    n_discarded: int = 0
    per_member: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    per_lane: dict = dataclasses.field(default_factory=lambda: defaultdict(int))


class StreamingPipeline:
    """Drives DAQ traffic through the LB into per-member reassembly lanes."""

    def __init__(self, daq_cfg: DAQConfig, transport_cfg: TransportConfig,
                 manager: EpochManager, device="cuda",
                 mtu_payload: int = DEFAULT_MTU_PAYLOAD,
                 reassembly_timeout_windows: int | None = None):
        self.device = resolve_device(device)
        self.fleet = DAQFleet(daq_cfg)
        self.wan = WANTransport(transport_cfg, device=self.device)
        self.manager = manager
        self.mtu_payload = mtu_payload
        self._timeout = reassembly_timeout_windows
        # lane-indexed batched reassemblers per member (entropy RSS lanes)
        self.lanes: dict[tuple[int, int], BatchReassembler] = {}
        self.stats = PipelineStats()
        self.routed_log: list[tuple[int, int, int]] = []  # (event, member, lane)
        self._dp_cache = DataPlaneCache(manager, device=self.device)

    def _dataplane(self) -> DataPlane:
        """Tables recompile only after the epoch state changes (audit-log
        watermark), not once per arrival window."""
        return self._dp_cache.get()

    def _lane(self, member: int, lane: int) -> BatchReassembler:
        key = (member, lane)
        if key not in self.lanes:
            self.lanes[key] = self._dataplane().make_reassembler(
                mtu_payload=self.mtu_payload, timeout_windows=self._timeout)
        return self.lanes[key]

    def _route_batch(self, batch: PacketBatch):
        """One batched DataPlane call for the whole arrival window."""
        return self._dataplane().route_window(batch)

    def pump(self, n_triggers: int) -> list[np.ndarray]:
        """Run n triggers end to end; returns completed bundle payloads."""
        bundles = self.fleet.bundle_window(n_triggers)
        batch = segment_bundles(bundles, self.mtu_payload)
        arrived = self.wan.deliver_batch(batch)
        if len(arrived) == 0:
            return []
        member, _node, lane, valid = self._route_batch(arrived)
        ok = valid.astype(bool)
        self.stats.n_packets += len(arrived)
        self.stats.n_discarded += int((~ok).sum())
        self.stats.n_routed += int(ok.sum())
        rows_ok = np.flatnonzero(ok)
        mm, ll = member[rows_ok], lane[rows_ok]
        self.routed_log.extend(
            zip(arrived.event_number[rows_ok].tolist(), mm.tolist(),
                ll.tolist()))
        if not len(rows_ok):
            return []
        pairs, groups = group_rows(np.stack([mm, ll], axis=1))
        done = []
        for (m, l), grp in zip(pairs.tolist(), groups):
            self.stats.per_member[m] += len(grp)
            self.stats.per_lane[(m, l)] += len(grp)
            done.extend(self._lane(m, l).push_batch(arrived.take(rows_ok[grp])))
        return done

    def event_member_map(self) -> dict[int, set[int]]:
        """event number -> set of members that received any of its packets.
        The paper's atomicity invariant: every set has size 1."""
        out: dict[int, set[int]] = defaultdict(set)
        for ev, m, _l in self.routed_log:
            out[ev].add(m)
        return out

    # -- ingest telemetry (feeds the control plane) ---------------------------
    def ingest_backlog(self) -> dict[int, int]:
        """Per-member incomplete-buffer backlog across its receive lanes."""
        out: dict[int, int] = defaultdict(int)
        for (m, _l), ra in self.lanes.items():
            out[m] += ra.n_incomplete
        return dict(out)

    def reassembly_stats(self) -> ReassemblyStats:
        """Aggregated loss/timeout/duplicate accounting over all lanes."""
        agg = ReassemblyStats()
        for ra in self.lanes.values():
            s = ra.stats
            agg.n_pushed += s.n_pushed
            agg.n_duplicate += s.n_duplicate
            agg.n_completed += s.n_completed
            agg.n_timed_out_groups += s.n_timed_out_groups
            agg.n_timed_out_segments += s.n_timed_out_segments
        return agg


def batches_from_bundles(payloads: list[np.ndarray], seq_len: int,
                         batch_size: int) -> list[np.ndarray]:
    """Decode token payloads (first seq_len*4 bytes) into [B, T] batches."""
    toks = []
    for p in payloads:
        t = np.frombuffer(p[: seq_len * 4].tobytes(), "<i4")
        if len(t) == seq_len:
            toks.append(t)
    out = []
    for i in range(0, len(toks) - batch_size + 1, batch_size):
        out.append(np.stack(toks[i : i + batch_size]))
    return out
