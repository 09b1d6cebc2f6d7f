"""Typed control-plane message schema (the controld wire protocol).

The paper's control plane is a long-running *service* on the FPGA host:
compute nodes register with it, stream telemetry to it, and hold leases that
expire when they go silent (§I-B.4/5, the CN daemon feedback loop). This
module is the protocol surface of that service — one frozen dataclass per
message, a kind registry, and a canonical JSON wire form shared by both
transports (in-process and length-prefixed socket), so the two are
property-equal by construction: the in-proc path round-trips every message
and reply through the same encoder the socket uses.

Messages:

* ``Reserve`` / ``Free``       — multi-tenant reservation of one virtual LB
  instance (the paper's 4 instances per device, §I-C); ``Reserve`` returns a
  token that scopes every member call to that instance.
* ``ReserveFabric``           — atomically reserve a *tier* of LB instances
  as one fabric: ``k`` LBs, each with a spray session and a reserved-lane
  session (the per-instance lane partition elephant flows are isolated
  onto — DESIGN.md §Fabric). One frame, one journal entry; all-or-nothing.
* ``Register`` / ``Deregister`` — member (CN) lifecycle inside a reservation.
* ``RegisterBatch``            — one bring-up wave of registrations in a
  single frame (parallel arrays), one journal entry; per-member validation
  failures are rejected individually in the reply.
* ``DeregisterBatch``          — the mirror teardown wave: one frame, one
  journal entry, per-member rejections in the reply. Fabric teardown of K
  instances' members is K*2 frames, not thousands of messages.
* ``SendState``               — the heartbeat: carries the MemberTelemetry
  fields (fill / rate / healthy) and renews the member's lease.
* ``SendStateBatch``          — one *window* of heartbeats for many members
  in a single frame: parallel arrays of member ids / fills / rates / health.
  The daemon ingests it as one array scatter into the reservation's
  telemetry lanes (per-member lease semantics identical to M ``SendState``
  messages at the same instant), amortizing the per-message JSON round trip
  that dominates the heartbeat path at farm scale.
* ``Tick``                    — advances the daemon: expires leases, runs the
  policy feedback, garbage-collects drained epochs. Explicit (not a timer)
  so virtual-time drivers and journal replay are deterministic.
* ``Status``                  — admin query, read-only (never journaled).

Every request carries an optional ``trace`` field (a 16-hex trace id from
``telemetry.trace``): both transports pass it through unchanged, and the
daemon — when given a ``TraceBuffer`` — records one ``controld.<kind>`` span
per traced message, linking control-plane work into the same per-window
span trees the data plane emits. ``trace=""`` (the default) records nothing,
and journal replay never records spans (digests are unchanged either way).
"""
from __future__ import annotations

import dataclasses
import json
import struct

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 1 << 20  # a control message is small; 1 MiB is corruption


class MessageError(ValueError):
    """Malformed frame / unknown kind / bad field set."""


@dataclasses.dataclass(frozen=True)
class Reserve:
    """Reserve one virtual LB instance. ``policy`` selects the reweighting
    controller for this reservation (``proportional`` | ``pid``);
    ``policy_params`` overrides its gains. ``instance_hint`` pins a specific
    instance when free (-1 = daemon's choice)."""

    KIND = "reserve"
    policy: str = "proportional"
    policy_params: dict = dataclasses.field(default_factory=dict)
    instance_hint: int = -1
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Free:
    """Release a reservation: drains the session and returns the instance."""

    KIND = "free"
    token: str = ""
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class ReserveFabric:
    """Reserve ``2*k`` virtual LB instances as one two-tier fabric: for each
    of the ``k`` tier members, a *spray* session (the VLB lanes mice traffic
    is obliviously sprayed across) and a *reserved* session (the calendar
    lanes detected elephant flows are strict-source-routed onto).
    All-or-nothing: if fewer than ``2*k`` instances are free the whole
    reservation is rejected. ``reserved_fraction`` records the fabric's
    lane-partition contract (what share of the farm the reserved calendars
    are programmed over) — surfaced in ``Status`` so operators and the
    simulator agree on the partition."""

    KIND = "reserve_fabric"
    k: int = 2
    policy: str = "proportional"
    policy_params: dict = dataclasses.field(default_factory=dict)
    reserved_fraction: float = 0.25
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Register:
    """Add a member (CN) to a reservation. Grants a lease that heartbeats
    renew; re-registering after a lapsed lease is the recovery path."""

    KIND = "register"
    token: str = ""
    member_id: int = 0
    node_id: int = 0
    base_lane: int = 0
    lane_bits: int = 0
    weight: float = 1.0
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class RegisterBatch:
    """One session bring-up (or rejoin wave) of many members in a single
    frame: parallel arrays of member ids / node ids / lanes / weights. The
    daemon handles it as one journal entry with per-member semantics exactly
    ``Register`` at a shared instant — members that fail validation (bad id,
    bad weight, bad lane spec) are *individually* rejected in the reply's
    ``rejected`` map while the rest are admitted; duplicates of a member id
    resolve last-spec-wins. At 10k members this turns ~0.5 s of per-member
    round trips into one frame."""

    KIND = "register_batch"
    token: str = ""
    member_ids: tuple = ()
    node_ids: tuple = ()
    base_lanes: tuple = ()
    lane_bits: tuple = ()
    weights: tuple = ()
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Deregister:
    """Graceful exit: the member drains hit-lessly from the next epoch."""

    KIND = "deregister"
    token: str = ""
    member_id: int = 0
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class DeregisterBatch:
    """One teardown wave of many members in a single frame — the mirror of
    ``RegisterBatch``: one journal entry, per-member semantics exactly
    ``Deregister`` at a shared instant. Members that are not registered are
    *individually* rejected in the reply's ``rejected`` map while the rest
    drain hit-lessly; duplicates of a member id resolve to one deregister
    plus a rejection for the rest."""

    KIND = "deregister_batch"
    token: str = ""
    member_ids: tuple = ()
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class SendState:
    """Heartbeat: one telemetry sample (MemberTelemetry fields) + lease
    renewal. A heartbeat for a lapsed lease is *rejected* — the member must
    re-register (the protocol form of ``TelemetryHub.stale_after``)."""

    KIND = "send_state"
    token: str = ""
    member_id: int = 0
    fill: float = 0.0
    rate: float = 1.0
    healthy: bool = True
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class SendStateBatch:
    """One window of heartbeats for many members: parallel arrays, one
    frame, one journal entry, one telemetry scatter. Per-member semantics
    are exactly ``SendState`` at a shared instant — members whose lease
    lapsed (or who hold none) are *individually* rejected in the reply's
    ``rejected`` map while the rest are accepted; duplicates of a member id
    resolve last-sample-wins."""

    KIND = "send_state_batch"
    token: str = ""
    member_ids: tuple = ()
    fills: tuple = ()
    rates: tuple = ()
    healthy: tuple = ()
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Tick:
    """One daemon step at ``current_event``: expire leases (-> hit-less
    drain), start pending sessions, run policy feedback per session, GC
    drained epochs at ``gc_event`` (-1 = ``current_event``)."""

    KIND = "tick"
    current_event: int = 0
    gc_event: int = -1
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Status:
    """Read-only admin query. With a token: that session; without: all."""

    KIND = "status"
    token: str = ""
    trace: str = ""
    req: str = ""


# -- HA / replication control messages (DESIGN.md §Controld-HA) ---------------
@dataclasses.dataclass(frozen=True)
class ReplicateEntries:
    """Leader -> standby WAL shipment: a contiguous batch of journal
    entries (``[{"seq", "kind", "payload"}, ...]``) the standby must
    append to its own journal and apply through the replay path. An
    *empty* batch is a probe: the reply's ``ReplicaAck`` tells the
    leader where the standby's journal ends (bootstrap / catch-up).
    ``generation`` is the leader's lease generation — a standby rejects
    shipments from a stale generation (fencing a partitioned
    ex-leader)."""

    KIND = "replicate_entries"
    leader: str = ""
    generation: int = 0
    entries: tuple = ()
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class ReplicaAck:
    """Standby -> leader acknowledgement, carried in the
    ``ReplicateEntries`` reply's ``data`` (wire form round-tripped via
    ``to_wire``/``from_wire``): ``ack_seq`` is the last journal seq the
    standby holds; ``need_from`` (>= 0) asks the leader to re-ship from
    that seq when the batch was non-contiguous with the standby's
    journal."""

    KIND = "replica_ack"
    node: str = ""
    ack_seq: int = -1
    need_from: int = -1
    generation: int = 0
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class LeaseClaim:
    """Leadership announcement / fencing: a node that claimed the lease
    (``generation`` from the arbiter) tells a peer. A leader receiving a
    claim with a *newer* generation steps down to standby immediately —
    a partitioned ex-leader must stop accepting mutations the moment it
    hears from its successor, even before its next arbiter read."""

    KIND = "lease_claim"
    node: str = ""
    generation: int = 0
    expires: float = 0.0
    trace: str = ""
    req: str = ""


@dataclasses.dataclass(frozen=True)
class Reply:
    """Every request gets one. ``data`` is kind-specific; protocol errors
    (bad token, lapsed lease, no free instance) come back ``ok=False`` with
    ``error`` set — they are *replies*, not transport failures."""

    ok: bool
    data: dict = dataclasses.field(default_factory=dict)
    error: str = ""


MESSAGE_TYPES = {
    cls.KIND: cls
    for cls in (Reserve, Free, ReserveFabric, Register, RegisterBatch,
                Deregister, DeregisterBatch, SendState, SendStateBatch,
                Tick, Status, ReplicateEntries, ReplicaAck, LeaseClaim)
}
#: HA control-plane kinds: handled by the HA layer (``controld.ha``),
#: never journaled as session state — replication carries journal
#: entries, it must not *generate* them
HA_KINDS = frozenset(
    {ReplicateEntries.KIND, ReplicaAck.KIND, LeaseClaim.KIND})
#: kinds that mutate daemon state and therefore must be journaled
MUTATING_KINDS = frozenset(
    k for k in MESSAGE_TYPES if k != Status.KIND and k not in HA_KINDS)


# -- canonical dict form ------------------------------------------------------
def to_wire(msg) -> dict:
    # shallow field dict, NOT dataclasses.asdict: messages hold no nested
    # dataclasses, and asdict deep-copies every element of a batch message's
    # arrays (it dominated the SendStateBatch hot path by ~10x)
    d = {f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)}
    d["kind"] = msg.KIND
    return d


def from_wire(d: dict):
    d = dict(d)
    kind = d.pop("kind", None)
    cls = MESSAGE_TYPES.get(kind)
    if cls is None:
        raise MessageError(f"unknown message kind {kind!r}")
    try:
        return cls(**d)
    except TypeError as e:
        raise MessageError(f"bad fields for {kind!r}: {e}") from None


def reply_to_wire(r: Reply) -> dict:
    return {"ok": r.ok, "data": r.data, "error": r.error}


def reply_from_wire(d: dict) -> Reply:
    try:
        return Reply(ok=bool(d["ok"]), data=d.get("data") or {},
                     error=d.get("error", ""))
    except (KeyError, TypeError) as e:
        raise MessageError(f"bad reply frame: {e}") from None


# -- length-prefixed framing (the socket wire form) ---------------------------
def _check_frame_size(n: int) -> None:
    if n > MAX_FRAME_BYTES:
        raise MessageError(f"frame too large ({n} bytes)")


def _decode_body(body: bytes) -> dict:
    try:
        return json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MessageError(f"undecodable frame: {e}") from None


def pack_frame(obj: dict) -> bytes:
    body = json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    _check_frame_size(len(body))
    return _LEN.pack(len(body)) + body


def read_frame(recv_exactly) -> dict | None:
    """Read one frame via ``recv_exactly(n) -> bytes`` (returns b'' on EOF
    at a frame boundary -> None)."""
    head = recv_exactly(_LEN.size)
    if not head:
        return None
    if len(head) != _LEN.size:
        raise MessageError("truncated frame header")
    (n,) = _LEN.unpack(head)
    _check_frame_size(n)
    body = recv_exactly(n)
    if len(body) != n:
        raise MessageError("truncated frame body")
    return _decode_body(body)


def parse_frames(buf: bytearray) -> list[dict]:
    """Consume every *complete* frame at the head of ``buf`` (in place) and
    return the decoded bodies — the non-blocking form of ``read_frame`` the
    selector transport uses: whatever half-frame remains stays in ``buf``
    for the next read. Raises ``MessageError`` on an oversized or
    undecodable frame (the connection is corrupt, not just slow)."""
    out = []
    while len(buf) >= _LEN.size:
        (n,) = _LEN.unpack(bytes(buf[:_LEN.size]))
        _check_frame_size(n)
        if len(buf) < _LEN.size + n:
            break
        body = bytes(buf[_LEN.size:_LEN.size + n])
        del buf[:_LEN.size + n]
        out.append(_decode_body(body))
    return out
