"""The unified data plane: one routing/dispatch entry point for the system.

The paper's keystone is a single low-latency pipeline — parse -> epoch ->
calendar -> member rewrite — that every packet traverses identically at line
rate. ``DataPlane`` is that pipeline's facade: it owns the compiled
``DeviceTables`` (one LB instance, or the paper's four virtual instances
stacked on a leading dim) on one device and exposes

    route(headers)          -> Route        (batched; one kernel launch)
    route_window(batch)     -> host arrays  (pow2-padded arrival window)
    route_events(ev, ent)   -> Route        (host-side event numbers)
    plan(member)            -> (pos, counts)  per-member dispatch plan
    dispatch(...) / combine(...) -> per-member packed buffers + drops
    redistribute(mesh, ...) -> the all_to_all exchange across ranks
    segment(bundles)        -> PacketBatch  (vectorized segmentation §II-C)
    reassembly_plan(...)    -> sort-based completion detection
    make_reassembler(...)   -> stateful batched CN-side reassembler

There is no backend switch: the device of the tables decides. On a CUDA
device ``route``, ``plan`` and the device reassembly plan launch the
hand-written kernels (``kernels/``); on the CPU they take the kernels' plain
PyTorch versions. Constructors default to ``device="cuda"`` and raise when
CUDA is missing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import router as _router
from repro_torch.core.protocol import encode_headers, words_to_tensor
from repro_torch.core.router import Route
from repro_torch.core.tables import DeviceTables, stack_tables
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataPlane:
    """Facade over the programmed tables + routing/dispatch kernels."""

    tables: DeviceTables

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_manager(cls, manager, device="cuda") -> "DataPlane":
        """One LB instance from an EpochManager (or anything with
        ``device_tables(device)``)."""
        return cls(tables=manager.device_tables(resolve_device(device)))

    @classmethod
    def from_instances(cls, managers, device="cuda") -> "DataPlane":
        """Stacked virtual instances (paper §I-C) from per-instance managers."""
        dev = resolve_device(device)
        return cls(tables=stack_tables([m.device_tables(dev) for m in managers]))

    def with_tables(self, tables: DeviceTables) -> "DataPlane":
        """Freshly programmed tables (epoch switch)."""
        return dataclasses.replace(self, tables=tables)

    # -- introspection -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def multi_instance(self) -> bool:
        return self.tables.seg_row.ndim == 2

    @property
    def n_instances(self) -> int:
        return int(self.tables.seg_row.shape[0]) if self.multi_instance else 1

    # -- routing -------------------------------------------------------------
    def route(self, headers: torch.Tensor, instance_id=None) -> Route:
        """Route a batch of wire header words [N, 4] (int32 bits of the u32
        words, or int64 values) in one kernel launch.

        ``instance_id`` (i32[N], from the L3 filter) is required iff the
        tables are stacked multi-instance.
        """
        from repro_torch.kernels.lb_route import lb_route

        if headers.ndim != 2 or headers.shape[-1] != 4:
            raise ValueError(f"headers must be [N, 4] words, got {tuple(headers.shape)}")
        if self.multi_instance and instance_id is None:
            raise ValueError("stacked tables require per-packet instance_id")
        if not self.multi_instance and instance_id is not None:
            raise ValueError("instance_id given but tables are single-instance")
        headers = headers.to(device=self.device, dtype=torch.int32).contiguous()
        if instance_id is not None:
            instance_id = instance_id.to(device=self.device, dtype=torch.int32).contiguous()
        member, node, lane, valid = lb_route(headers, self.tables, instance_id)
        return Route(member=member, node=node, lane=lane, valid=valid > 0)

    def route_window(self, batch, instance_id=None):
        """Route a host-side ``PacketBatch`` arrival window.

        Pads the window to a power of two so window-size jitter keeps the
        launch shapes few; padding rows carry a zero magic and fail header
        validation, so they can never alias a real packet. Returns host
        ``(member, node, lane, valid)`` arrays sliced back to the window.
        """
        from repro_torch.data.segmentation import next_pow2

        n = len(batch)
        words = np.zeros((next_pow2(n), 4), np.uint32)
        words[:n] = batch.headers
        iid = None
        if instance_id is not None:
            iid_np = np.zeros((words.shape[0],), np.int32)
            iid_np[:n] = instance_id
            iid = torch.from_numpy(iid_np).to(self.device)
        r = self.route(words_to_tensor(words, self.device), iid)
        out = torch.stack([r.member, r.node, r.lane, r.valid.to(torch.int32)])
        member, node, lane, valid = out[:, :n].cpu().numpy()
        return member, node, lane, valid.astype(bool)

    def route_events(self, event_numbers, entropy, instance_id=None) -> Route:
        """Route host-side events (uint64 numbers + entropy) in one call.

        Encodes protocol headers and goes through the same ``route`` path, so
        hosts that never see wire packets still traverse the identical
        pipeline.
        """
        ev = np.asarray(event_numbers, np.uint64)
        en = np.asarray(entropy, np.uint32)
        headers = words_to_tensor(encode_headers(ev, en), self.device)
        iid = None if instance_id is None else torch.as_tensor(
            np.asarray(instance_id, np.int32), device=self.device)
        return self.route(headers, iid)

    # -- dispatch (pack routed packets into per-member buffers) --------------
    def plan(self, member: torch.Tensor, n_members: int):
        """Per-packet buffer positions + per-member totals (pos=-1 invalid)."""
        from repro_torch.kernels.dispatch import dispatch_plan

        member = member.to(device=self.device, dtype=torch.int32).contiguous()
        return dispatch_plan(member, n_members=n_members)

    def member_positions(self, member, n_members: int, capacity: int):
        """(pos, keep, counts) — the capacity-bounded sort-based pack."""
        return _router.member_positions(member, n_members, capacity)

    def dispatch(self, payload, member, n_members: int, capacity: int):
        """Scatter payloads into [n_members, capacity, ...] + occupancy."""
        return _router.dispatch(payload, member, n_members, capacity)

    def combine(self, payload, member, pos, n_members: int, capacity: int):
        """Scatter by a precomputed plan; returns (buf, occ, dropped)."""
        return combine_payloads(payload, member, pos, n_members=n_members,
                                capacity=capacity)

    # -- redistribution across ranks -----------------------------------------
    def redistribute(self, mesh, axis_names, capacity_per_src: int):
        """Build the all_to_all exchange (LB -> CN delivery) over the mesh's
        process group (``router.make_redistribute``)."""
        return _router.make_redistribute(mesh, axis_names, capacity_per_src)

    # -- ingest (segmentation & reassembly, paper §II-C) ----------------------
    @staticmethod
    def segment(bundles, mtu_payload: Optional[int] = None):
        """Segment a bundle batch into a PacketBatch (one vectorized pass).

        Host-side by construction (DAQ bundles are host bytes); the LB does
        not participate in segmentation.
        """
        from repro_torch.data import segmentation as _seg

        mtu = _seg.DEFAULT_MTU_PAYLOAD if mtu_payload is None else mtu_payload
        return _seg.segment_bundles(bundles, mtu)

    def reassembly_plan(self, ev_hi, ev_lo, daq, seg_index, n_segs, valid):
        """Sort-based reassembly program for one window on this plane's
        device (the ``seg_masks`` kernel on the card)."""
        from repro_torch.data import reassembly as _ra

        return _ra.reassembly_plan(ev_hi, ev_lo, daq, seg_index, n_segs, valid)

    def make_reassembler(self, mtu_payload: Optional[int] = None,
                         timeout_windows: Optional[int] = None,
                         device_plan: bool = False):
        """A stateful BatchReassembler. The CN reassembly daemon is host-side
        (the LB does not participate, paper §II-C), so the default engine is
        the numpy plan; ``device_plan=True`` runs the plan on this plane's
        device instead (device-resident ingest)."""
        from repro_torch.data import reassembly as _ra
        from repro_torch.data import segmentation as _seg

        mtu = _seg.DEFAULT_MTU_PAYLOAD if mtu_payload is None else mtu_payload
        return _ra.BatchReassembler(
            mtu_payload=mtu, timeout_windows=timeout_windows,
            engine="device" if device_plan else "np", device=self.device)


class DataPlaneCache:
    """Audit-log-watermark cache around ``DataPlane.from_manager`` /
    ``from_instances``.

    Hosts that stream against mutable ``EpochManager``s must not recompile
    tables once per arrival window — only after a control plane actually
    touches the epoch state. The audit log length (summed across managers
    for the stacked multi-instance case) is that watermark.
    """

    def __init__(self, manager, device="cuda"):
        """``manager``: one EpochManager, or a list of them (one per
        stacked virtual LB instance)."""
        self.managers = manager if isinstance(manager, (list, tuple)) \
            else [manager]
        self.device = resolve_device(device)
        self._dp: Optional[DataPlane] = None
        self._version = -1

    @property
    def manager(self):
        return self.managers[0]

    def get(self) -> DataPlane:
        version = sum(len(m.audit) for m in self.managers)
        if self._dp is None or version != self._version:
            if len(self.managers) > 1:
                self._dp = DataPlane.from_instances(self.managers, self.device)
            else:
                self._dp = DataPlane.from_manager(self.managers[0], self.device)
            self._version = version
        return self._dp


def combine_payloads(payload, member, pos, *, n_members: int, capacity: int):
    """Scatter payloads by (member, pos) into [n_members, capacity, ...] buffers.

    Returns (buffers, occupancy, dropped_count). Drops (pos >= capacity) are
    counted, never silent.
    """
    keep = (member >= 0) & (pos >= 0) & (pos < capacity)
    buf, occ = _router.scatter_by_plan(payload, member, pos, keep,
                                       n_members, capacity)
    dropped = ((member >= 0) & ~keep).sum()
    return buf, occ, dropped
