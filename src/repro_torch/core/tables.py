"""The P4 match-action table suite (paper fig. 4), host + device representations.

Pipeline order (paper §III):

    L2 Input Filter -> L3 Input Filter -> Calendar Epoch Assignment
        -> Calendar to Member Map -> Member Lookup and Rewrite

The L2/L3 filters are control-plane/NIC concerns (MAC/IP identities); they
are modeled host-side and select the LB *instance*. The last three tables are
the data plane proper and compile to dense tensors (``DeviceTables``) read by
the plain router and the CUDA ``lb_route`` kernel. Epoch LPM entries are kept
P4-faithful (core/lpm.py) and compiled to a sorted-boundary segment
representation at programming time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import lpm
from repro_torch.core.protocol import CALENDAR_SLOTS, LB_SERVICE_PORT, split64
from repro_torch.device import resolve_device

# Fixed device-table capacities.
MAX_EPOCH_SEGMENTS = 16  # distinct contiguous event-number segments
MAX_EPOCH_ROWS = 8       # resident calendars (past/current/future epochs)
DEFAULT_MAX_MEMBERS = 512


class TableError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    """Value side of the 'Member Lookup and Rewrite' table.

    ``node_id`` is the destination node, ``base_lane``/``lane_bits`` replace
    the UDP base port / entropy-mask width (2**lane_bits receive lanes per
    member — the paper's RSS mechanism). ``ip``/``mac`` are kept for
    protocol fidelity.
    """

    node_id: int
    base_lane: int = 0
    lane_bits: int = 0  # 2**lane_bits contiguous lanes
    ip: str = ""
    mac: str = ""
    udp_base_port: int = LB_SERVICE_PORT + 1

    def __post_init__(self):
        if not 0 <= self.lane_bits <= 16:
            raise TableError("entropy/lane bits must be a power-of-2 range, 0..16")


@dataclasses.dataclass(frozen=True)
class L2Entry:
    mac_da: str
    src_mac: str  # preferred unicast MAC SA for responses


@dataclasses.dataclass(frozen=True)
class L3Entry:
    ethertype: int  # 0x0800 IPv4 / 0x86dd IPv6 / 0x0806 ARP
    dst_ip: str
    src_ip: str  # preferred unicast IP for responses
    instance_id: int


class L2L3Filter:
    """Layer 2 + Layer 3 input filters. Reject-by-default (paper §III-B.1)."""

    def __init__(self):
        self.l2: dict[str, L2Entry] = {}
        self.l3: dict[tuple[int, str], L3Entry] = {}

    def add_l2(self, entry: L2Entry) -> None:
        self.l2[entry.mac_da.lower()] = entry

    def add_l3(self, entry: L3Entry) -> None:
        self.l3[(entry.ethertype, entry.dst_ip.lower())] = entry

    def admit(self, mac_da: str, ethertype: int, dst_ip: str) -> Optional[L3Entry]:
        """Returns the matched L3 entry (with instance id) or None (drop)."""
        if mac_da.lower() not in self.l2:
            return None
        return self.l3.get((ethertype, dst_ip.lower()))


@dataclasses.dataclass
class DeviceTables:
    """Dense tensors for the data-plane lookups, all on one device.

    seg_* describe sorted half-open segments of the event-number space:
    event e belongs to segment i where i is the largest index with
    seg_start_i <= e; ``seg_row[i]`` is the row in ``calendars`` (or -1 =>
    discard). Calendars hold member ids; member_* hold the rewrite table.
    The u32 segment starts are int64 tensors holding the unsigned value.
    Stacked virtual instances carry a leading instance dim on every field.
    """

    seg_start_hi: torch.Tensor  # int64[MAX_EPOCH_SEGMENTS]  (u32 values)
    seg_start_lo: torch.Tensor  # int64[MAX_EPOCH_SEGMENTS]  (u32 values)
    seg_row: torch.Tensor       # int32[MAX_EPOCH_SEGMENTS]
    calendars: torch.Tensor     # int32[MAX_EPOCH_ROWS, 512]
    member_node: torch.Tensor   # int32[M]
    member_base_lane: torch.Tensor  # int32[M]
    member_lane_mask: torch.Tensor  # int32[M]  ((1<<lane_bits) - 1)
    member_valid: torch.Tensor  # int32[M]

    @property
    def max_members(self) -> int:
        return int(self.member_node.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.seg_row.device

    def fields(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def instance(self, i: int) -> "DeviceTables":
        """One instance's tables out of a stacked set."""
        return DeviceTables(**{k: v[i] for k, v in self.fields().items()})


_U32_FIELDS = ("seg_start_hi", "seg_start_lo")


def device_tables_from_numpy(fields: dict, device="cuda") -> DeviceTables:
    """Numpy arrays of the 8 table fields (e.g. the JAX package's
    ``DeviceTables`` with each field through ``np.asarray``) -> the port's
    ``DeviceTables`` on ``device``. The u32 segment starts become int64."""
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(DeviceTables):
        a = np.asarray(fields[f.name])
        dtype = np.int64 if f.name in _U32_FIELDS else np.int32
        out[f.name] = torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)
    return DeviceTables(**out)


class RouterState:
    """Host-side mutable programming state for ONE LB instance.

    Owns the P4-faithful structures (LPM table over event numbers, calendar
    rows, member map) and compiles them to `DeviceTables`.
    """

    def __init__(self, max_members: int = DEFAULT_MAX_MEMBERS, n_slots: int = CALENDAR_SLOTS):
        self.n_slots = n_slots
        self.max_members = max_members
        self.epoch_lpm = lpm.LPMTable()
        self.calendars: dict[int, np.ndarray] = {}  # epoch_id -> int32[n_slots]
        self.members: dict[int, MemberSpec] = {}    # member_id -> spec
        self._epoch_rows: dict[int, int] = {}       # epoch_id -> device row
        self._free_rows = list(range(MAX_EPOCH_ROWS))

    # -- Member Lookup and Rewrite table ------------------------------------
    def insert_member(self, member_id: int, spec: MemberSpec) -> None:
        if not 0 <= member_id < self.max_members:
            raise TableError(f"member id {member_id} out of range (max {self.max_members})")
        self.members[member_id] = spec

    def delete_member(self, member_id: int) -> None:
        for eid, cal in self.calendars.items():
            if (cal == member_id).any():
                raise TableError(
                    f"member {member_id} still referenced by calendar epoch {eid}"
                )
        del self.members[member_id]

    # -- Calendar to Member Map table ---------------------------------------
    def insert_calendar(self, epoch_id: int, calendar: np.ndarray) -> None:
        calendar = np.asarray(calendar, dtype=np.int32)
        if calendar.shape != (self.n_slots,):
            raise TableError(f"calendar must have {self.n_slots} slots")
        # Paper NOTE: all slots MUST have a member assigned.
        missing = set(np.unique(calendar).tolist()) - set(self.members)
        if missing:
            raise TableError(f"calendar references unprogrammed members {sorted(missing)}")
        if epoch_id in self.calendars:
            raise TableError(f"epoch {epoch_id} calendar is immutable once programmed")
        if not self._free_rows:
            raise TableError("no free calendar rows; quiesce old epochs first")
        self.calendars[epoch_id] = calendar
        self._epoch_rows[epoch_id] = self._free_rows.pop(0)

    def delete_calendar(self, epoch_id: int) -> None:
        for _, data in self.epoch_lpm.entries.items():
            if data == epoch_id:
                raise TableError(f"epoch {epoch_id} still reachable from LPM table")
        del self.calendars[epoch_id]
        self._free_rows.append(self._epoch_rows.pop(epoch_id))

    # -- Calendar Epoch Assignment table ------------------------------------
    def connect_epoch_range(self, lo: int, hi: int, epoch_id: int) -> list[lpm.Prefix]:
        if epoch_id not in self.calendars:
            raise TableError("downstream tables must be populated before connecting an epoch")
        return self.epoch_lpm.insert_range(lo, hi, epoch_id)

    def set_wildcard_epoch(self, epoch_id: int) -> None:
        if epoch_id not in self.calendars:
            raise TableError("downstream tables must be populated before connecting an epoch")
        self.epoch_lpm.set_wildcard(epoch_id)

    def reachable_epochs(self) -> set[int]:
        return {d for d in self.epoch_lpm.entries.values() if d is not None}

    # -- Compilation ----------------------------------------------------------
    def compile_numpy(self) -> dict[str, np.ndarray]:
        """The 8 table fields as host arrays (u32 starts as uint32)."""
        segs = self.epoch_lpm.boundaries()
        if len(segs) > MAX_EPOCH_SEGMENTS:
            raise TableError(
                f"{len(segs)} epoch segments exceed device capacity {MAX_EPOCH_SEGMENTS}"
            )
        starts = np.zeros(MAX_EPOCH_SEGMENTS, dtype=np.uint64)
        rows = np.full(MAX_EPOCH_SEGMENTS, -1, dtype=np.int32)
        for i, (start, eid) in enumerate(segs):
            starts[i] = start
            rows[i] = self._epoch_rows[eid] if eid is not None and eid in self._epoch_rows else -1
        # Pad trailing segments at the top of the event space, repeating the
        # last real row so an event equal to 2**64-1 still routes correctly
        # (the compare-count lookup lands on the last padded segment).
        pad_row = rows[len(segs) - 1] if segs else np.int32(-1)
        for i in range(len(segs), MAX_EPOCH_SEGMENTS):
            starts[i] = np.uint64(2**64 - 1)
            rows[i] = pad_row

        cal = np.zeros((MAX_EPOCH_ROWS, self.n_slots), dtype=np.int32)
        for eid, c in self.calendars.items():
            cal[self._epoch_rows[eid]] = c

        m = self.max_members
        node = np.full(m, -1, dtype=np.int32)
        base = np.zeros(m, dtype=np.int32)
        mask = np.zeros(m, dtype=np.int32)
        valid = np.zeros(m, dtype=np.int32)
        for mid, spec in self.members.items():
            node[mid] = spec.node_id
            base[mid] = spec.base_lane
            mask[mid] = (1 << spec.lane_bits) - 1
            valid[mid] = 1

        hi, lo = split64(starts)
        return dict(seg_start_hi=hi, seg_start_lo=lo, seg_row=rows,
                    calendars=cal, member_node=node, member_base_lane=base,
                    member_lane_mask=mask, member_valid=valid)

    def compile(self, device="cuda") -> DeviceTables:
        return device_tables_from_numpy(self.compile_numpy(), device)


def stack_tables(tables: list[DeviceTables]) -> DeviceTables:
    """Stack per-instance tables along a leading 'LB instance' dimension.

    The paper supports four independent virtual LB instances per device
    (§I-C); the router gathers by instance id.
    """
    return DeviceTables(**{
        f.name: torch.stack([getattr(t, f.name) for t in tables])
        for f in dataclasses.fields(DeviceTables)})
