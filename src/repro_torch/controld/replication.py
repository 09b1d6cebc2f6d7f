"""WAL shipping for controld HA (leader side) and the standby apply path.

The leader's journal is the single source of truth (every mutating
message is WAL-appended before it executes — ``daemon.py``), so
replication is exactly "ship the WAL": each handled message's fresh
entries go to every attached standby as one ``ReplicateEntries`` frame
over the ordinary controld transport, and the standby *applies them
through the same journal-replay path a recovering daemon uses* —
``append_entry`` mirrors the entry byte-for-byte into the standby's own
journal, then the message runs under ``_replaying`` with its recorded
clock instant. Determinism of replay (the state-digest property) is what
makes the standby's ``state_digest`` track the leader's exactly.

Protocol (DESIGN.md §Controld-HA):

* shipment  — ``ReplicateEntries(leader, generation, entries)`` where
  ``entries`` is a seq-contiguous batch; empty = probe.
* ack       — the reply data is a wire-form ``ReplicaAck``:
  ``ack_seq`` (standby's journal head) and ``need_from`` >= 0 when the
  batch did not attach to the standby's journal (the leader then ships
  backlog from that seq — ``Journal.read_entries``).
* fencing   — a standby rejects shipments from a generation older than
  the newest it has seen, so a partitioned ex-leader cannot overwrite a
  promoted successor's journal; the rejection tells the ex-leader to
  step down.

Delivery policy: synchronous best-effort. The leader ships (and waits
for the ack) before answering the client, so any reply the client saw
is durable on every *live* standby — a SIGKILLed leader loses only
unacknowledged calls, which the client resends idempotently (request
ids). A standby that errors or disconnects is marked dead and skipped
(one stuck standby must not freeze the control plane); it catches up
via the probe/backlog dance when it re-attaches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.controld import messages as M
from repro_torch.controld.journal import Entry, Journal

#: keep shipment frames far under messages.MAX_FRAME_BYTES (1 MiB)
BATCH_ENTRIES = 256

#: marker a standby uses to reject a stale-generation shipment — the
#: ex-leader seeing it must step down immediately
STALE_GENERATION = "STALE_GENERATION"


def entry_to_wire(e: Entry) -> dict:
    return {"seq": e.seq, "kind": e.kind, "payload": e.payload}


def entry_from_wire(d: dict) -> Entry:
    return Entry(seq=int(d["seq"]), kind=str(d["kind"]),
                 payload=dict(d["payload"]))


def apply_entries(daemon, entries) -> int:
    """Standby-side application: mirror each shipped entry into the
    local journal (exact seq — ``append_entry``), then execute it through
    the daemon's replay path with its recorded instant. This IS the
    recovery path run incrementally, so the standby's ``state_digest``
    tracks the leader byte-for-byte; the request-id dedup cache rebuilds
    too, which is what makes a client resend land correctly on the
    successor after failover."""
    j = daemon.journal
    n = 0
    for e in entries:
        if j is not None:
            j.append_entry(e)
        payload = dict(e.payload)
        recorded_now = payload.pop("now")
        msg = M.from_wire({"kind": e.kind, **payload})
        daemon._replaying = True
        try:
            daemon.handle(msg, now=recorded_now)
        finally:
            daemon._replaying = False
        n += 1
    return n


@dataclasses.dataclass
class ReplicaPeer:
    """Leader-side view of one standby."""

    name: str
    transport: object
    acked_seq: int = -1
    alive: bool = True
    errors: int = 0


class Replicator:
    """Leader-side WAL shipper over a set of standby transports.

    ``ship`` sends fresh entries to every live peer and processes acks
    (including ``need_from`` backlog requests). Returns True if any peer
    fenced us with ``STALE_GENERATION`` — the caller (``HANode``) must
    step down. ``lag`` = journal head minus the slowest live peer's ack
    (the replication-lag gauge)."""

    def __init__(self, node_id: str, journal: Optional[Journal],
                 faults=None):
        self.node_id = node_id
        self.journal = journal
        self.faults = faults
        self.peers: dict[str, ReplicaPeer] = {}

    def attach(self, name: str, transport, generation: int) -> ReplicaPeer:
        """Register a standby and bring it to the journal head: probe for
        its ack seq, then ship whatever backlog it is missing."""
        peer = self.peers[name] = ReplicaPeer(name=name, transport=transport)
        self._ship_peer(peer, [], generation)  # probe; triggers catch-up
        return peer

    def detach(self, name: str) -> None:
        self.peers.pop(name, None)

    def lag(self) -> int:
        if self.journal is None:
            return 0
        live = [p.acked_seq for p in self.peers.values() if p.alive]
        if not live:
            return 0
        return max(0, self.journal.seq - min(live))

    def ship(self, entries, generation: int) -> bool:
        """One shipment round to every live peer; True => we were fenced
        (a peer holds a newer generation) and must step down."""
        if self.faults is not None:
            self.faults.crashpoint("replication.ship")
        wire = [entry_to_wire(e) for e in entries]
        fenced = False
        for peer in self.peers.values():
            if peer.alive:
                fenced |= self._ship_peer(peer, wire, generation)
        return fenced

    def _call(self, peer: ReplicaPeer, wire_entries,
              generation: int) -> Optional[M.ReplicaAck]:
        """One ReplicateEntries round trip; None => peer marked dead or
        (if fenced) the ack is replaced by raising via return code."""
        from repro_torch.controld.transport import TransportError
        msg = M.ReplicateEntries(leader=self.node_id,
                                 generation=int(generation),
                                 entries=tuple(wire_entries))
        try:
            reply = peer.transport.call(msg)
        except TransportError:
            peer.alive = False
            peer.errors += 1
            return None
        if not reply.ok:
            peer.errors += 1
            if STALE_GENERATION in reply.error:
                return M.ReplicaAck(node=peer.name, ack_seq=-2)
            peer.alive = False
            return None
        ack = M.from_wire(reply.data)
        if not isinstance(ack, M.ReplicaAck):
            peer.alive = False
            peer.errors += 1
            return None
        return ack

    def _ship_peer(self, peer: ReplicaPeer, wire_entries,
                   generation: int) -> bool:
        """Ship one batch to one peer, then stream backlog until the peer
        acks the journal *head* — a freshly (re)attached standby is
        brought fully current before this returns, which is what makes
        the synchronous-durability invariant hold for every live peer.
        Returns True when fenced."""
        ack = self._call(peer, wire_entries, generation)
        for _ in range(4096):  # rounds are strictly monotone; bound them
            if ack is None:
                return False
            if ack.ack_seq == -2:  # STALE_GENERATION sentinel
                return True
            peer.acked_seq = max(peer.acked_seq, ack.ack_seq)
            if self.journal is None:
                return False
            if ack.need_from < 0 and peer.acked_seq >= self.journal.seq:
                return False  # converged to head
            start = (ack.need_from if ack.need_from >= 0
                     else peer.acked_seq + 1)
            backlog = self.journal.read_entries(start)
            if not backlog:
                return False
            sent_through = backlog[min(len(backlog), BATCH_ENTRIES) - 1].seq
            chunk = [entry_to_wire(e)
                     for e in backlog[:BATCH_ENTRIES]]
            prev_ack = peer.acked_seq
            ack = self._call(peer, chunk, generation)
            if (ack is not None and ack.ack_seq >= 0
                    and ack.ack_seq <= prev_ack
                    and sent_through > prev_ack):
                # no forward progress — stop rather than loop
                peer.alive = False
                return False
        peer.alive = False  # backlog never converged
        return False
