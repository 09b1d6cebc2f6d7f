"""controld — the session-oriented control-plane daemon.

The paper's control plane is a long-running service on the FPGA host: CN
daemons *register with* it, stream telemetry to it, and it makes redirection
decisions continuously. ``ControlDaemon`` is that service for this repro
(DESIGN.md §Controld):

* **Reservations** (multi-tenancy, paper §I-C): the daemon owns N virtual LB
  instances; ``Reserve`` leases one to a tenant and returns a token that
  scopes every subsequent member call. Each reservation gets its own
  ``EpochManager`` + ``LoadBalancerControlPlane`` with the reweighting
  policy the tenant selected (``controld.policy``).
* **Leases**: a registered member holds a lease renewed by ``SendState``
  heartbeats. A lease expiring at a ``Tick`` triggers the *same* hit-less
  drain as ``mark_failed`` — removed from the next epoch, in-flight events
  keep routing to it until the boundary. This is ``TelemetryHub.stale_after``
  promoted from a passive snapshot flag to a protocol rule: a heartbeat for
  a lapsed lease is rejected and the member must re-register.
* **Ticks**: all time-driven behavior (lease expiry, session start, policy
  feedback, epoch GC) happens in explicit ``Tick`` messages, so virtual-time
  drivers (simnet) and journal replay are deterministic.
* **Journal**: every mutating message is appended to an event-sourced
  journal (``controld.journal``) with the clock instant it was handled at,
  *before* it executes. ``recover`` replays a journal through a fresh daemon
  and reproduces byte-identical calendar state (``state_digest``) — a
  restarted daemon resumes mid-epoch with identical calendars.

The daemon is transport-agnostic: ``handle`` takes a typed message and
returns a ``Reply``; ``controld.transport`` provides the in-process and
length-prefixed-socket fronts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from bisect import insort
from typing import Callable, Optional

import numpy as np

from repro_torch.controld import messages as M
from repro_torch.controld.journal import Entry, Journal
from repro_torch.controld.policy import make_policy
from repro_torch.core.control_plane import (ControlPolicy, LoadBalancerControlPlane,
                                      TelemetryArray)
from repro_torch.core.epoch import EpochManager
from repro_torch.core.tables import MemberSpec, TableError
from repro_torch.telemetry.registry import SIZE_BUCKETS, MetricsRegistry
from repro_torch.telemetry.trace import parse_trace_id


class SessionError(ValueError):
    """Protocol-level rejection (bad token, lapsed lease, no free instance).
    Returned to the client as ``Reply(ok=False)``, never raised across the
    transport."""


class MemberLanes:
    """Array-native per-reservation member state: lease + telemetry lanes.

    One lane per member id in ``[0, max_members)``. Telemetry lanes default
    to ``MemberTelemetry()`` (fill 0, rate 1, healthy) so a registered
    member that has not heartbeat yet reads exactly what the dict path's
    ``telemetry.get(m, MemberTelemetry())`` produced; ``sampled`` tracks
    which lanes hold a real sample (for status/digest views). A whole
    heartbeat window lands as one fancy-index scatter."""

    def __init__(self, max_members: int):
        self.leased = np.zeros(max_members, bool)
        self.lease_expires = np.full(max_members, -np.inf, np.float64)
        self.fill = np.zeros(max_members, np.float64)
        self.rate = np.ones(max_members, np.float64)
        self.healthy = np.ones(max_members, bool)
        self.sampled = np.zeros(max_members, bool)

    def grant(self, member_id: int, expires: float) -> None:
        self.leased[member_id] = True
        self.lease_expires[member_id] = expires

    def revoke(self, member_ids) -> None:
        """Drop leases AND telemetry lanes (lease expiry / deregister)."""
        idx = np.asarray(member_ids, np.int64)
        self.leased[idx] = False
        self.lease_expires[idx] = -np.inf
        self.clear_samples(idx)

    def clear_samples(self, member_ids) -> None:
        idx = np.asarray(member_ids, np.int64)
        self.fill[idx] = 0.0
        self.rate[idx] = 1.0
        self.healthy[idx] = True
        self.sampled[idx] = False

    def scatter(self, member_ids, fills, rates, healthy,
                expires: float) -> None:
        """One window of accepted heartbeats in one pass (last-sample-wins
        for duplicate ids, numpy scatter semantics)."""
        idx = np.asarray(member_ids, np.int64)
        self.lease_expires[idx] = expires
        self.fill[idx] = fills
        self.rate[idx] = rates
        self.healthy[idx] = healthy
        self.sampled[idx] = True

    # -- views (status / digest / dict-path interop) --------------------------
    def lease_ids(self) -> list[int]:
        return [int(m) for m in np.flatnonzero(self.leased)]

    def lease_view(self) -> dict[int, float]:
        return {int(m): float(self.lease_expires[m])
                for m in np.flatnonzero(self.leased)}

    def telemetry_view(self) -> dict[int, dict]:
        return {int(m): {"fill": float(self.fill[m]),
                         "rate": float(self.rate[m]),
                         "healthy": bool(self.healthy[m])}
                for m in np.flatnonzero(self.sampled)}


@dataclasses.dataclass
class Session:
    """One reservation: a tenant's lease on one virtual LB instance."""

    token: str
    instance: int
    policy_name: str
    manager: EpochManager
    cp: LoadBalancerControlPlane
    lanes: MemberLanes
    pending: dict[int, tuple[MemberSpec, float]] = dataclasses.field(
        default_factory=dict)  # registered before the session started
    started: bool = False
    fabric: str = ""          # ReserveFabric grouping ("" = standalone)
    # per-reservation message-rate quota (token bucket; tokens < 0 = off)
    quota_tokens: float = -1.0
    quota_t: float = 0.0
    counters: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"heartbeats": 0, "epoch_switches": 0,
                                 "leases_expired": 0, "registered": 0,
                                 "deregistered": 0, "quota_rejected": 0})


class _DaemonMetrics:
    """Pre-resolved registry children for the daemon's hot paths.

    Children are looked up ONCE here, at construction, so the per-message
    cost is a dict hit on ``msg.KIND`` plus plain float adds — this is what
    keeps the JAX package's ``bench_metrics`` under its 5% overhead gate. Occupancy is exported
    as callback gauges straight over ``MemberLanes`` arrays: nothing runs
    until a scrape asks.
    """

    def __init__(self, registry: MetricsRegistry, daemon: "ControlDaemon",
                 kinds) -> None:
        self.registry = registry
        msgs = registry.counter(
            "controld_messages_total", "Messages handled, by kind.",
            labelnames=("kind",))
        rejs = registry.counter(
            "controld_rejects_total",
            "Protocol rejections (Reply ok=False), by kind.",
            labelnames=("kind",))
        secs = registry.histogram(
            "controld_handle_seconds", "Message handling latency, by kind.",
            labelnames=("kind",))
        self.messages = {k: msgs.labels(kind=k) for k in kinds}
        self.rejects = {k: rejs.labels(kind=k) for k in kinds}
        self.handle_seconds = {k: secs.labels(kind=k) for k in kinds}
        self.heartbeats = registry.counter(
            "controld_heartbeats_total", "Accepted member heartbeats.")
        self.hb_batch = registry.histogram(
            "controld_heartbeat_batch_size",
            "Members per SendStateBatch window.", buckets=SIZE_BUCKETS)
        self.leases_reaped = registry.counter(
            "controld_leases_reaped_total", "Leases expired at a Tick.")
        self.quota_rejects = registry.counter(
            "controld_quota_rejects",
            "Messages rejected by a reservation's rate quota.")
        self.epoch_switches = registry.counter(
            "controld_epoch_switches_total",
            "Hit-less epoch switches scheduled by policy feedback.")
        registry.gauge(
            "controld_sessions_active", "Live reservations."
        ).set_function(lambda: len(daemon.sessions))
        registry.gauge(
            "controld_instances_free", "Unreserved virtual LB instances."
        ).set_function(lambda: len(daemon._free_instances))

    def watch_session(self, s: "Session") -> None:
        """Callback gauges over one reservation's MemberLanes arrays."""
        lanes = s.lanes
        self.registry.gauge(
            "controld_session_members", "Leased members, by reservation.",
            labelnames=("token",)
        ).labels(token=s.token).set_function(
            lambda: int(lanes.leased.sum()))
        self.registry.gauge(
            "controld_session_mean_fill",
            "Mean reported queue fill over sampled lanes, by reservation.",
            labelnames=("token",)
        ).labels(token=s.token).set_function(
            lambda: float(lanes.fill[lanes.sampled].mean())
            if lanes.sampled.any() else 0.0)

    def drop_session(self, token: str) -> None:
        for name in ("controld_session_members", "controld_session_mean_fill"):
            self.registry.gauge(name, labelnames=("token",)).remove(
                token=token)


class ControlDaemon:
    """Session manager over N virtual LB instances (module docstring)."""

    def __init__(self, n_instances: int = 4,
                 clock: Callable[[], float] = time.time,
                 lease_s: float = 10.0,
                 epoch_horizon: int = 1024,
                 max_members: int = 64,
                 journal: Optional[Journal] = None,
                 policy_engine: str = "np",
                 device="cuda",
                 metrics: Optional[MetricsRegistry] = None,
                 quota_msgs_per_s: Optional[float] = None,
                 quota_burst: Optional[float] = None,
                 trace=None,
                 req_cache_size: int = 4096):
        self.n_instances = n_instances
        self.clock = clock
        self.lease_s = float(lease_s)
        self.epoch_horizon = int(epoch_horizon)
        self.max_members = int(max_members)
        self.journal = journal
        # per-reservation message-rate quota (None = unlimited): a token
        # bucket refilled at quota_msgs_per_s, capped at quota_burst. One
        # noisy tenant exhausts its own bucket, not the daemon — over-quota
        # member-lifecycle/heartbeat messages are protocol rejections.
        # Batch messages cost ONE token: batching is the sanctioned way to
        # say more under the same quota.
        self.quota_msgs_per_s = (None if quota_msgs_per_s is None
                                 else float(quota_msgs_per_s))
        self.quota_burst = (max(16.0, 2.0 * self.quota_msgs_per_s)
                            if quota_burst is None
                            and self.quota_msgs_per_s is not None
                            else None if quota_burst is None
                            else float(quota_burst))
        # engine for the fused per-Tick policy update ("np" = bit-identical
        # to the scalar path, on the host; "torch" = float32 tensor ops on
        # ``device``, the only place the daemon touches a device). Recover a
        # journal with the SAME engine it was written under — replay runs
        # the same arithmetic, so digests only match engine-to-engine.
        # Every other piece of daemon state stays Python/numpy: the digest
        # hashes its JSON form.
        if policy_engine not in ("np", "torch"):
            raise ValueError(f"policy_engine must be 'np' or 'torch', "
                             f"got {policy_engine!r}")
        self.policy_engine = policy_engine
        self.device = device
        self.sessions: dict[str, Session] = {}
        #: fabric groupings from ReserveFabric: id -> {"tokens", "k",
        #: "reserved_fraction"} — the lane-partition contract of record
        self.fabrics: dict[str, dict] = {}
        self._free_instances: list[int] = list(range(n_instances))
        self._token_counter = 0
        self._fabric_counter = 0
        self._replaying = False
        # request-id dedup (idempotent resend across reconnect/failover):
        # client-stamped ``req`` ids map to the reply the daemon already
        # gave, so a resend after a lost reply or a mid-call failover
        # never double-applies. The ``req`` rides in the journal payload,
        # so replay (and a warm standby applying shipped entries) rebuilds
        # this cache deterministically — a resend lands correctly on the
        # *successor* too. FIFO-evicted at ``req_cache_size`` (insertion
        # order is replay-deterministic).
        self.req_cache_size = int(req_cache_size)
        self._req_replies: dict[str, M.Reply] = {}
        self._handlers = {
            M.Reserve.KIND: self._reserve,
            M.Free.KIND: self._free,
            M.ReserveFabric.KIND: self._reserve_fabric,
            M.Register.KIND: self._register,
            M.RegisterBatch.KIND: self._register_batch,
            M.Deregister.KIND: self._deregister,
            M.DeregisterBatch.KIND: self._deregister_batch,
            M.SendState.KIND: self._send_state,
            M.SendStateBatch.KIND: self._send_state_batch,
            M.Tick.KIND: self._tick,
            M.Status.KIND: self._status,
        }
        # metrics=None keeps every hot path bit-identical to the
        # uninstrumented daemon (no branches taken, nothing allocated)
        self._mx = (None if metrics is None
                    else _DaemonMetrics(metrics, self, self._handlers))
        # trace: a telemetry.trace.TraceBuffer — per-message spans for
        # requests that carry a trace id (journal replay records nothing)
        self.trace = trace

    # -- the single entry point ----------------------------------------------
    def handle(self, msg, now: Optional[float] = None) -> M.Reply:
        """Dedup (client request ids), journal (mutating kinds, WAL-style:
        before execution, so replay sees the exact accepted sequence —
        rejected messages replay to the same rejection), execute, reply.
        Protocol errors become ``Reply(ok=False)``; anything else is a bug
        and propagates. A resent ``req`` the daemon has already answered
        returns the cached reply *before* the journal append — a resend is
        never a second WAL entry."""
        fn = self._handlers.get(msg.KIND)
        if fn is None:
            return M.Reply(False, error=f"unhandled message {msg.KIND!r}")
        if now is None:
            now = float(self.clock())
        req = getattr(msg, "req", "")
        if req:
            cached = self._req_replies.get(req)
            if cached is not None:
                return cached
        if (msg.KIND in M.MUTATING_KINDS and not self._replaying
                and self.journal is not None):
            payload = M.to_wire(msg)
            payload.pop("kind")
            payload["now"] = now
            self.journal.append(msg.KIND, payload)
        reply = self._execute(fn, msg, now)
        if req and msg.KIND in M.MUTATING_KINDS:
            self._req_replies[req] = reply
            if len(self._req_replies) > self.req_cache_size:
                del self._req_replies[next(iter(self._req_replies))]
        return reply

    def _execute(self, fn, msg, now: float) -> M.Reply:
        mx = None if self._replaying else self._mx
        tr = (self.trace if self.trace is not None and not self._replaying
              and getattr(msg, "trace", "") else None)
        if mx is None and tr is None:
            try:
                return M.Reply(True, data=fn(msg, now))
            except SessionError as e:
                return M.Reply(False, error=str(e))
        t0 = time.perf_counter()
        ok = True
        try:
            return M.Reply(True, data=fn(msg, now))
        except SessionError as e:
            ok = False
            if mx is not None:
                mx.rejects[msg.KIND].inc()
            return M.Reply(False, error=str(e))
        finally:
            dt = time.perf_counter() - t0
            if mx is not None:
                mx.messages[msg.KIND].inc()
                mx.handle_seconds[msg.KIND].observe(dt)
            if tr is not None:
                self._record_span(tr, msg, now, dt, ok)

    def _record_span(self, tr, msg, now: float, wall_s: float,
                     ok: bool) -> None:
        """One ``controld.<kind>`` span for a traced request: anchored at
        the virtual-clock instant it was handled, with the measured wall
        handling time as its duration (aux = 1 accepted / 0 rejected). A
        malformed trace id is ignored — tracing must never reject a
        message the untraced daemon would accept."""
        try:
            key = parse_trace_id(msg.trace)
        except (TypeError, ValueError):
            return
        tr.record_window("controld." + msg.KIND,
                         np.asarray([key], np.uint64),
                         np.asarray([now], np.float64),
                         np.asarray([now + wall_s], np.float64),
                         aux=np.asarray([1 if ok else 0], np.int64))

    def _session(self, token: str) -> Session:
        s = self.sessions.get(token)
        if s is None:
            raise SessionError(f"unknown or expired reservation {token!r}")
        return s

    def _member_index(self, member_id) -> Optional[int]:
        """Validated lane index, or None when ``member_id`` cannot address a
        lane. A non-integer id (a string or float is valid JSON!) must be a
        protocol rejection, never a TypeError/IndexError — the message is
        already in the WAL, and a handler crash would replay forever."""
        if isinstance(member_id, bool) or not isinstance(
                member_id, (int, np.integer)):
            return None
        mid = int(member_id)
        return mid if 0 <= mid < self.max_members else None

    # -- per-reservation message-rate quota -----------------------------------
    def _charge_quota(self, s: Session, now: float) -> None:
        """Token-bucket admission for one token-scoped message. Refill is
        computed from journaled ``now`` instants, so quota state (and every
        over-quota rejection) replays deterministically from the WAL."""
        if self.quota_msgs_per_s is None:
            return
        if s.quota_tokens < 0:  # session created before quotas were enabled
            s.quota_tokens, s.quota_t = self.quota_burst, now
        elapsed = max(now - s.quota_t, 0.0)
        s.quota_tokens = min(self.quota_burst,
                             s.quota_tokens + elapsed * self.quota_msgs_per_s)
        s.quota_t = now
        if s.quota_tokens < 1.0:
            s.counters["quota_rejected"] += 1
            if self._mx is not None and not self._replaying:
                self._mx.quota_rejects.inc()
            raise SessionError(
                f"reservation {s.token} over its message-rate quota "
                f"({self.quota_msgs_per_s:g} msg/s) — back off, or batch")
        s.quota_tokens -= 1.0

    # -- reservation lifecycle ------------------------------------------------
    def _new_session(self, inst: int, policy, now: float,
                     fabric: str = "") -> Session:
        """One reservation's state on an already-claimed instance."""
        token = f"r{self._token_counter:06d}"
        self._token_counter += 1
        manager = EpochManager(max_members=self.max_members)
        cp = LoadBalancerControlPlane(
            manager, ControlPolicy(epoch_horizon=self.epoch_horizon),
            reweighter=policy)
        cp.array_engine = self.policy_engine
        cp.array_device = self.device
        s = self.sessions[token] = Session(
            token=token, instance=inst, policy_name=policy.name,
            manager=manager, cp=cp, lanes=MemberLanes(self.max_members),
            fabric=fabric)
        if self.quota_msgs_per_s is not None:
            s.quota_tokens, s.quota_t = self.quota_burst, now
        if self._mx is not None:
            # runs during replay too: recovered sessions keep their gauges
            self._mx.watch_session(s)
        return s

    def _reserve(self, msg: M.Reserve, now: float) -> dict:
        if not self._free_instances:
            raise SessionError(
                f"all {self.n_instances} LB instances are reserved")
        if msg.instance_hint >= 0:
            if msg.instance_hint not in self._free_instances:
                raise SessionError(
                    f"instance {msg.instance_hint} is not free")
            inst = msg.instance_hint
            self._free_instances.remove(inst)
        else:
            inst = self._free_instances.pop(0)
        try:
            policy = make_policy(msg.policy, msg.policy_params)
        except ValueError as e:
            insort(self._free_instances, inst)
            raise SessionError(str(e)) from None
        s = self._new_session(inst, policy, now)
        return {"token": s.token, "instance": inst, "policy": policy.name,
                "lease_s": self.lease_s}

    def _reserve_fabric(self, msg: M.ReserveFabric, now: float) -> dict:
        """Atomically reserve a tier of ``k`` LBs, each as a (spray,
        reserved) session pair — the per-instance lane partition. All
        validation happens before any instance is claimed, so a rejection
        leaves the free pool untouched (and replays to the same rejection)."""
        if isinstance(msg.k, bool) or not isinstance(msg.k, int) or msg.k < 1:
            raise SessionError(f"fabric size k={msg.k!r} must be an int >= 1")
        try:
            frac = float(msg.reserved_fraction)
        except (TypeError, ValueError):
            raise SessionError(
                f"reserved_fraction {msg.reserved_fraction!r} is not a "
                "number") from None
        if not (0.0 < frac < 1.0):
            raise SessionError(
                f"reserved_fraction must be in (0, 1), got {frac!r}")
        if len(self._free_instances) < 2 * msg.k:
            raise SessionError(
                f"fabric needs {2 * msg.k} free instances "
                f"(k={msg.k} x spray+reserved), have "
                f"{len(self._free_instances)}")
        try:
            make_policy(msg.policy, msg.policy_params)  # validate only
        except ValueError as e:
            raise SessionError(str(e)) from None
        fabric_id = f"f{self._fabric_counter:06d}"
        self._fabric_counter += 1
        sessions, tokens = [], []
        for lb in range(msg.k):
            pair = {}
            for klass in ("spray", "reserved"):
                inst = self._free_instances.pop(0)
                # one fresh (stateful) policy per session
                policy = make_policy(msg.policy, msg.policy_params)
                s = self._new_session(inst, policy, now, fabric=fabric_id)
                pair[klass] = s.token
                tokens.append(s.token)
            sessions.append({"lb": lb, **pair})
        self.fabrics[fabric_id] = {"tokens": tokens, "k": msg.k,
                                   "reserved_fraction": frac}
        return {"fabric": fabric_id, "k": msg.k, "reserved_fraction": frac,
                "lease_s": self.lease_s, "sessions": sessions}

    def _free(self, msg: M.Free, now: float) -> dict:
        s = self._session(msg.token)
        del self.sessions[msg.token]
        insort(self._free_instances, s.instance)
        if s.fabric and s.fabric in self.fabrics:
            fab = self.fabrics[s.fabric]
            fab["tokens"] = [t for t in fab["tokens"] if t != msg.token]
            if not fab["tokens"]:
                del self.fabrics[s.fabric]
        if self._mx is not None:
            self._mx.drop_session(msg.token)
        return {"instance": s.instance, "counters": dict(s.counters)}

    # -- member lifecycle -----------------------------------------------------
    def _validate_member(self, member_id, node_id, base_lane, lane_bits,
                         weight) -> tuple[int, MemberSpec, float]:
        """One member's registration fields -> (lane, spec, weight), or a
        ``SessionError``. Every field a later (journaled!) step consumes is
        validated HERE, as a protocol rejection: a bad value that only blew
        up inside the starting Tick (e.g. weight=0 in cp.start) would crash
        *after* its WAL append and poison the journal for every future
        recover()."""
        mid = self._member_index(member_id)
        if mid is None:
            raise SessionError(
                f"member id {member_id!r} out of range "
                f"(max {self.max_members})")
        try:
            w = float(weight)
        except (TypeError, ValueError):
            raise SessionError(
                f"weight {weight!r} is not a number") from None
        if not (w > 0.0) or not np.isfinite(w):
            raise SessionError(
                f"weight must be positive and finite, got {weight!r}")
        try:
            spec = MemberSpec(node_id=node_id, base_lane=base_lane,
                              lane_bits=lane_bits)
        except (TableError, TypeError) as e:
            raise SessionError(str(e)) from None
        return mid, spec, w

    def _admit(self, s: Session, mid: int, spec: MemberSpec, weight: float,
               expires: float) -> None:
        s.lanes.grant(mid, expires)
        s.counters["registered"] += 1
        if s.started:
            # (re-)joining a live session: the next tick's feedback sees the
            # membership delta and schedules a hit-less epoch switch
            s.cp.add_members({mid: spec}, weight=weight)
            s.lanes.clear_samples([mid])
        else:
            s.pending[mid] = (spec, weight)

    def _register(self, msg: M.Register, now: float) -> dict:
        s = self._session(msg.token)
        self._charge_quota(s, now)
        mid, spec, weight = self._validate_member(
            msg.member_id, msg.node_id, msg.base_lane, msg.lane_bits,
            msg.weight)
        expires = now + self.lease_s
        self._admit(s, mid, spec, weight, expires)
        return {"member_id": msg.member_id, "lease_expires": expires}

    def _register_batch(self, msg: M.RegisterBatch, now: float) -> dict:
        """One bring-up wave in one journal entry. Per-member semantics are
        exactly N ``Register`` messages at this instant, except validation
        failures are per-member (in the reply's ``rejected`` map) instead of
        per-message; duplicates of an id resolve last-spec-wins."""
        s = self._session(msg.token)
        self._charge_quota(s, now)
        try:
            cols = [list(msg.member_ids), list(msg.node_ids),
                    list(msg.base_lanes), list(msg.lane_bits),
                    list(msg.weights)]
        except TypeError:
            raise SessionError(
                "batch fields must be parallel arrays") from None
        if len({len(c) for c in cols}) != 1:
            raise SessionError("batch arrays must be the same length")
        expires = now + self.lease_s
        accepted, rejected = [], {}
        for member_id, node_id, base_lane, lane_bits, weight in zip(*cols):
            try:
                mid, spec, w = self._validate_member(
                    member_id, node_id, base_lane, lane_bits, weight)
            except SessionError as e:
                rejected[str(member_id)] = str(e)
                continue
            self._admit(s, mid, spec, w, expires)
            accepted.append(mid)
        return {"n_accepted": len(accepted), "member_ids": accepted,
                "lease_expires": expires, "rejected": rejected}

    def _deregister(self, msg: M.Deregister, now: float) -> dict:
        s = self._session(msg.token)
        self._charge_quota(s, now)
        mid = self._member_index(msg.member_id)
        if mid is None or not s.lanes.leased[mid]:
            raise SessionError(f"member {msg.member_id} is not registered")
        s.lanes.revoke([mid])
        s.counters["deregistered"] += 1
        if s.started:
            # graceful exit == the failure drain: out of the next epoch,
            # in-flight events keep their member (epoch immutability)
            s.cp.mark_failed([msg.member_id])
        else:
            s.pending.pop(msg.member_id, None)
        return {"member_id": msg.member_id}

    def _deregister_batch(self, msg: M.DeregisterBatch, now: float) -> dict:
        """One teardown wave in one journal entry — the mirror of
        ``_register_batch``. Per-member semantics are exactly N
        ``Deregister`` messages at this instant (same revoke, same counters,
        same hit-less ``mark_failed`` drain), except unregistered members
        are per-member rejections in the reply; a duplicated id deregisters
        once and rejects the rest (it is no longer leased by then)."""
        s = self._session(msg.token)
        self._charge_quota(s, now)
        try:
            raw = list(msg.member_ids)
        except TypeError:
            raise SessionError("member_ids must be an array") from None
        accepted, rejected = [], {}
        for member_id in raw:
            mid = self._member_index(member_id)
            if mid is None or not s.lanes.leased[mid]:
                rejected[str(member_id)] = (
                    f"member {member_id!r} is not registered")
                continue
            s.lanes.revoke([mid])
            s.counters["deregistered"] += 1
            accepted.append(mid)
        if accepted:
            if s.started:
                # one call, but mark_failed drains per member — digest-
                # identical to N scalar Deregisters at this instant
                s.cp.mark_failed(accepted)
            else:
                for mid in accepted:
                    s.pending.pop(mid, None)
        return {"n_accepted": len(accepted), "member_ids": accepted,
                "rejected": rejected}

    def _send_state(self, msg: M.SendState, now: float) -> dict:
        s = self._session(msg.token)
        self._charge_quota(s, now)
        mid = self._member_index(msg.member_id)
        if mid is None or not s.lanes.leased[mid]:
            raise SessionError(
                f"member {msg.member_id} holds no lease (expired or never "
                "registered) — re-register to rejoin")
        expires = float(s.lanes.lease_expires[mid])
        if expires <= now:
            # the protocol rule, independent of tick cadence: a lapsed lease
            # cannot be renewed by a late heartbeat — the next Tick reaps it
            # (the one drain path); the member must re-register
            raise SessionError(
                f"member {msg.member_id}'s lease lapsed at {expires:.6f} "
                f"(now {now:.6f}) — re-register to rejoin")
        try:
            fill, rate = float(msg.fill), float(msg.rate)
        except (TypeError, ValueError):
            # protocol rejection, not a crash: the message is already in
            # the WAL and must replay to the same rejection
            raise SessionError("fill/rate must be numbers") from None
        new_expires = now + self.lease_s
        s.lanes.scatter([mid], [fill], [rate], [bool(msg.healthy)],
                        new_expires)
        s.counters["heartbeats"] += 1
        if self._mx is not None and not self._replaying:
            self._mx.heartbeats.inc()
        return {"member_id": mid, "lease_expires": new_expires}

    def _send_state_batch(self, msg: M.SendStateBatch, now: float) -> dict:
        """One heartbeat window for many members: a single array scatter
        into the reservation's lanes. Per-member semantics are exactly M
        ``SendState`` messages at this instant, except rejections are
        per-member (in the reply) instead of per-message."""
        s = self._session(msg.token)
        self._charge_quota(s, now)
        try:
            # every id through the same _member_index validation SendState
            # uses: a float/bool/string/huge-int id is a per-member
            # rejection, never an unsafe cast onto the wrong lane — and
            # never an exception after the WAL append (OverflowError from a
            # huge int would replay as a crash on every recover())
            raw = list(msg.member_ids)
            lanes = [self._member_index(m) for m in raw]
            fills = np.asarray(msg.fills, np.float64)
            rates = np.asarray(msg.rates, np.float64)
            healthy = np.asarray(msg.healthy, bool)
        except (TypeError, ValueError, OverflowError):
            raise SessionError(
                "batch fields must be parallel numeric arrays") from None
        if not (fills.ndim == rates.ndim == healthy.ndim == 1
                and len(lanes) == len(fills) == len(rates) == len(healthy)):
            raise SessionError(
                "batch arrays must be 1-D and the same length")
        ids = np.asarray([-1 if ln is None else ln for ln in lanes],
                         np.int64)
        in_range = ids >= 0
        ok = in_range.copy()
        rows = np.flatnonzero(in_range)
        sub = ids[rows]
        ok[rows] = s.lanes.leased[sub] & (s.lanes.lease_expires[sub] > now)
        new_expires = now + self.lease_s
        acc = np.flatnonzero(ok)
        if len(acc):
            s.lanes.scatter(ids[acc], fills[acc], rates[acc], healthy[acc],
                            new_expires)
        n_acc = int(ok.sum())
        s.counters["heartbeats"] += n_acc
        if self._mx is not None and not self._replaying:
            # once per WINDOW, not per member — the batch path must keep
            # its per-heartbeat cost in the array scatter
            self._mx.heartbeats.inc(n_acc)
            self._mx.hb_batch.observe(len(fills))
        rejected = {}
        for i in np.flatnonzero(~ok).tolist():
            if not in_range[i] or not s.lanes.leased[ids[i]]:
                rejected[str(raw[i])] = "no lease — re-register to rejoin"
            else:
                rejected[str(raw[i])] = "lease lapsed — re-register to rejoin"
        return {"n_accepted": n_acc, "lease_expires": float(new_expires),
                "rejected": rejected}

    # -- the daemon step ------------------------------------------------------
    def _tick(self, msg: M.Tick, now: float) -> dict:
        """Expire leases (-> hit-less drain), start pending sessions, run
        each session's policy feedback, GC drained epochs."""
        out = {}
        gc_event = msg.gc_event if msg.gc_event >= 0 else msg.current_event
        for token in sorted(self.sessions):
            s = self.sessions[token]
            lapsed = np.flatnonzero(s.lanes.leased
                                    & (s.lanes.lease_expires <= now))
            expired = [int(m) for m in lapsed]
            if expired:
                s.lanes.revoke(lapsed)
                s.counters["leases_expired"] += len(expired)
                if self._mx is not None and not self._replaying:
                    self._mx.leases_reaped.inc(len(expired))
                if s.started:
                    s.cp.mark_failed(expired)  # the lease-expiry drain path
                else:
                    for m in expired:
                        s.pending.pop(m, None)
            eid = None
            note = ""
            if not s.started and s.pending:
                members = {m: spec for m, (spec, _) in sorted(s.pending.items())}
                weights = {m: w for m, (_, w) in sorted(s.pending.items())}
                try:
                    eid = s.cp.start(members, weights)
                except (ValueError, RuntimeError) as e:
                    # defense in depth: _register validates every field, but
                    # a failed start must degrade to a note — this Tick is
                    # already in the WAL, and an exception here would replay
                    # as the same crash on every recover()
                    note = f"session start failed: {e}"
                else:
                    s.started = True
                    s.pending = {}
            elif s.started and s.cp.members:
                # exactly ONE fused policy update over [M] lanes: gather the
                # members' telemetry lanes (defaults match the dict path's
                # MemberTelemetry() for silent members) and hand the whole
                # window to feedback as arrays — no per-member dict churn
                ids = np.fromiter(s.cp.members.keys(), np.int64,
                                  len(s.cp.members))
                tele = TelemetryArray(
                    member_ids=ids, fill=s.lanes.fill[ids],
                    rate=s.lanes.rate[ids], healthy=s.lanes.healthy[ids])
                try:
                    eid = s.cp.feedback(tele, msg.current_event)
                except RuntimeError as e:
                    # every member drained — keep the last epoch live rather
                    # than tearing the session down (members may re-register)
                    note = str(e)
                    eid = None
                if eid is not None:
                    s.counters["epoch_switches"] += 1
                    if self._mx is not None and not self._replaying:
                        self._mx.epoch_switches.inc()
                s.cp.garbage_collect(gc_event)
            out[token] = {"epoch": eid, "expired": expired}
            if note:
                out[token]["note"] = note
        return {"sessions": out, "now": now}

    # -- read-only admin ------------------------------------------------------
    def _status(self, msg: M.Status, now: float) -> dict:
        tokens = [msg.token] if msg.token else sorted(self.sessions)
        sessions = {}
        for token in tokens:
            s = self._session(token)
            sessions[token] = {
                "instance": s.instance,
                "policy": s.policy_name,
                "started": s.started,
                "fabric": s.fabric,
                "current_epoch": s.manager.current_epoch,
                "members": {
                    str(m): {"lease_remaining": round(exp - now, 9),
                             "weight": s.cp.weights.get(m)}
                    for m, exp in sorted(s.lanes.lease_view().items())},
                "counters": dict(s.counters),
            }
        return {"sessions": sessions,
                "fabrics": {fid: dict(fab)
                            for fid, fab in sorted(self.fabrics.items())},
                "free_instances": list(self._free_instances),
                "journal_seq": self.journal.seq if self.journal else -1,
                # lets a remote admin audit replay/replication fidelity
                # over the wire (the HA failover smoke compares the
                # successor's digest to the dead leader's)
                "state_digest": self.state_digest()}

    # -- event-sourced recovery ----------------------------------------------
    def replay(self, entries: list[Entry]) -> int:
        """Feed a journal history through the handlers with each entry's
        recorded clock instant. Only valid on a virgin daemon."""
        if self.sessions or self._token_counter:
            raise ValueError("replay() requires a fresh daemon")
        self._replaying = True
        try:
            for e in entries:
                payload = dict(e.payload)
                recorded_now = payload.pop("now")
                msg = M.from_wire({"kind": e.kind, **payload})
                self.handle(msg, now=recorded_now)
        finally:
            self._replaying = False
        return len(entries)

    @classmethod
    def recover(cls, journal: Journal, **kwargs) -> "ControlDaemon":
        """Rebuild a daemon from a journal: replay its entries, then keep
        journaling seq-contiguously — and be recoverable again.

        The replayed ``journal`` becomes the live journal: it already holds
        the history and continues appending in place (to its file, for a
        ``Journal.load``-ed one), so recovering from an on-disk journal
        keeps persisting to it without duplicating entries. Pass
        ``live_journal`` to redirect post-recovery appends elsewhere: either
        an *empty* journal (the history is adopted into it — e.g. a fresh
        file after restoring from a snapshot directory) or a
        ``Journal.resume``-d one already positioned at the replayed seq
        (a compacted WAL whose prefix lives in the snapshot dir)."""
        live = kwargs.pop("live_journal", None)
        daemon = cls(journal=None, **kwargs)
        daemon.replay(journal.entries)
        if live is not None:
            if live.seq == -1:
                live.adopt(journal.entries)
            elif live.seq != journal.seq:
                raise ValueError(
                    f"live_journal at seq {live.seq} does not resume the "
                    f"replayed history at seq {journal.seq}")
            daemon.journal = live
        else:
            daemon.journal = journal
        # a file-backed journal's replayed entries are now redundant in RAM
        journal.release_replayed()
        return daemon

    # -- state digest ---------------------------------------------------------
    def state_digest(self) -> str:
        """SHA-256 over the daemon's complete programmable state — calendar
        bytes, LPM entries, member tables, epoch records, weights, leases,
        policy state, counters. Replay is correct iff digests match."""
        h = hashlib.sha256()

        def put(obj):
            h.update(json.dumps(obj, sort_keys=True, default=repr).encode())

        put({"token_counter": self._token_counter,
             "fabric_counter": self._fabric_counter,
             "fabrics": {fid: {"tokens": list(fab["tokens"]),
                               "k": fab["k"],
                               "reserved_fraction": fab["reserved_fraction"]}
                         for fid, fab in sorted(self.fabrics.items())},
             "free_instances": list(self._free_instances),
             "lease_s": self.lease_s})
        for token in sorted(self.sessions):
            s = self.sessions[token]
            leases = s.lanes.lease_view()
            put({"token": token, "instance": s.instance,
                 "policy": s.policy_name, "started": s.started,
                 "fabric": s.fabric,
                 "quota": [s.quota_tokens, s.quota_t],
                 "leases": {str(k): leases[k] for k in sorted(leases)},
                 "telemetry": {str(k): v for k, v in
                               sorted(s.lanes.telemetry_view().items())},
                 "pending": {str(k): (dataclasses.asdict(v[0]), v[1])
                             for k, v in sorted(s.pending.items())},
                 "counters": s.counters,
                 "weights": {str(k): v for k, v in sorted(s.cp.weights.items())},
                 "scheduled": {str(k): v for k, v in
                               sorted(s.cp._scheduled_weights.items())},
                 "policy_state": s.cp.reweighter.state()})
            em = s.manager
            put({"current_epoch": em.current_epoch,
                 "records": {str(eid): {
                     "start": r.start_event, "end": r.end_event,
                     "active": r.active,
                     "prefixes": sorted((p.value, p.length)
                                        for p in r.prefixes),
                     "members": {str(m): dataclasses.asdict(sp)
                                 for m, sp in sorted(r.members.items())}}
                     for eid, r in sorted(em.records.items())}})
            st = em.state
            put({"members": {str(m): dataclasses.asdict(sp)
                             for m, sp in sorted(st.members.items())},
                 "epoch_rows": {str(k): v
                                for k, v in sorted(st._epoch_rows.items())},
                 "free_rows": list(st._free_rows),
                 "lpm": sorted((p.value, p.length, repr(d))
                               for p, d in st.epoch_lpm.entries.items())})
            for eid in sorted(st.calendars):
                h.update(np.ascontiguousarray(
                    st.calendars[eid], dtype=np.int32).tobytes())
        return h.hexdigest()
