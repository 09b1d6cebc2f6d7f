"""Hit-less epoch reconfiguration (paper §III-B.2..4 and §III-C).

The paper's central operational procedure: a new configuration is built
*from the end of the P4 pipeline toward the start* — members first, then the
calendar, then the epoch LPM connection — so that by the time an Event Number
can reach a new epoch, every downstream table it needs is already programmed.
Activation is the LPM/wildcard flip; cleanup happens only after the old epoch
has quiesced. Epochs that are reachable are immutable.

`EpochManager` enforces that ordering mechanically and keeps an audit log so
tests can assert the invariants (no reachable-epoch mutation, build-backwards
order, zero-drop transitions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.calendar import build_calendar
from repro_torch.core.tables import DeviceTables, MemberSpec, RouterState, TableError


class ReconfigurationError(RuntimeError):
    pass


@dataclasses.dataclass
class EpochRecord:
    epoch_id: int
    start_event: int           # inclusive
    end_event: Optional[int]   # exclusive; None = open-ended (wildcard)
    prefixes: list = dataclasses.field(default_factory=list)
    members: dict = dataclasses.field(default_factory=dict)  # member_id -> MemberSpec
    active: bool = True


class EpochManager:
    """Drives one LB instance through initialize / reconfigure / quiesce."""

    def __init__(self, max_members: int = 512):
        self.state = RouterState(max_members=max_members)
        self.records: dict[int, EpochRecord] = {}
        self._next_epoch_id = 0
        self._next_member_id = 0
        self.audit: list[tuple] = []
        self.current_epoch: Optional[int] = None

    # -- member id allocation (control plane owns ids, paper §III-B.2) ------
    def allocate_member_ids(self, n: int) -> list[int]:
        ids = list(range(self._next_member_id, self._next_member_id + n))
        self._next_member_id += n
        return ids

    def _allocate_epoch_id(self) -> int:
        eid = self._next_epoch_id
        self._next_epoch_id += 1
        return eid

    # -- initialization (out-of-service, paper §III-B) ------------------------
    def initialize(self, members: dict[int, MemberSpec], weights) -> int:
        """Program members -> calendar -> map ALL event numbers to epoch 0."""
        if self.records:
            raise ReconfigurationError("already initialized; use reconfigure()")
        eid = self._allocate_epoch_id()
        # 1) Populate Member Lookup and Rewrite (end of pipeline).
        for mid, spec in members.items():
            self.state.insert_member(mid, spec)
            self.audit.append(("member_insert", eid, mid))
        # 2) Populate the Calendar for this epoch.
        cal = build_calendar(
            np.asarray(sorted(members), dtype=np.int32),
            np.asarray([weights[m] for m in sorted(members)], dtype=np.float64),
            n_slots=self.state.n_slots,
        )
        self.state.insert_calendar(eid, cal)
        self.audit.append(("calendar_insert", eid))
        # 3) Connect: map the entire Event Number space to the first epoch.
        self.state.set_wildcard_epoch(eid)
        self.audit.append(("epoch_connect", eid))
        self.records[eid] = EpochRecord(
            epoch_id=eid, start_event=0, end_event=None, prefixes=[],
            members=dict(members),
        )
        self.current_epoch = eid
        return eid

    # -- in-service reconfiguration (paper §III-C) -----------------------------
    def reconfigure(
        self,
        members: dict[int, MemberSpec],
        weights,
        boundary_event: int,
    ) -> int:
        """Activate a new epoch at ``boundary_event`` without disruption.

        Steps follow §III-C literally; the old epoch's range is pinned with
        explicit LPM prefixes *before* the wildcard is flipped, so no event is
        ever routed by a half-programmed configuration.
        """
        if self.current_epoch is None:
            raise ReconfigurationError("initialize() first")
        cur = self.records[self.current_epoch]
        if cur.end_event is not None:
            raise ReconfigurationError("current epoch already bounded")
        if boundary_event <= cur.start_event:
            raise ReconfigurationError("boundary must be in the (near) future")

        # 1) Allocate the next free Calendar Epoch ID.
        eid = self._allocate_epoch_id()
        # 2) Insert new Member entries for any CNs changed in the next epoch.
        for mid, spec in members.items():
            if mid not in self.state.members or self.state.members[mid] != spec:
                self.state.insert_member(mid, spec)
                self.audit.append(("member_insert", eid, mid))
        # 3) Compute and insert an entirely new calendar under the new id.
        cal = build_calendar(
            np.asarray(sorted(members), dtype=np.int32),
            np.asarray([weights[m] for m in sorted(members)], dtype=np.float64),
            n_slots=self.state.n_slots,
        )
        self.state.insert_calendar(eid, cal)
        self.audit.append(("calendar_insert", eid))
        # 4) Pin the current epoch: LPM prefixes over [cur.start, boundary).
        prefixes = self.state.connect_epoch_range(
            cur.start_event, boundary_event, cur.epoch_id
        )
        cur.prefixes.extend(prefixes)
        cur.end_event = boundary_event
        self.audit.append(("epoch_pin", cur.epoch_id, cur.start_event, boundary_event))
        # 5) Flip the wildcard to the new epoch => activation.
        self.state.set_wildcard_epoch(eid)
        self.audit.append(("epoch_connect", eid))

        self.records[eid] = EpochRecord(
            epoch_id=eid, start_event=boundary_event, end_event=None,
            members=dict(members),
        )
        self.current_epoch = eid
        return eid

    # -- cleanup after quiesce (paper §III-C tail) ------------------------------
    def quiesce(self, epoch_id: int) -> None:
        """Tear down a drained epoch: LPM prefixes -> calendar -> members."""
        rec = self.records[epoch_id]
        if rec.end_event is None or epoch_id == self.current_epoch:
            raise ReconfigurationError("cannot quiesce the active epoch")
        # 1) Delete the LPM prefix matches (disconnects the epoch).
        self.state.epoch_lpm.delete_many(rec.prefixes)
        self.audit.append(("epoch_disconnect", epoch_id))
        # 2) Delete the LB Calendar for the epoch.
        self.state.delete_calendar(epoch_id)
        self.audit.append(("calendar_delete", epoch_id))
        # 3) Delete any unreferenced member rewrites.
        still_used = set()
        for cal in self.state.calendars.values():
            still_used.update(int(v) for v in np.unique(cal))
        for mid in list(self.state.members):
            if mid not in still_used:
                try:
                    self.state.delete_member(mid)
                    self.audit.append(("member_delete", mid))
                except TableError:
                    pass
        rec.active = False

    # -- device view -----------------------------------------------------------
    def device_tables(self, device="cuda") -> DeviceTables:
        return self.state.compile(device)
