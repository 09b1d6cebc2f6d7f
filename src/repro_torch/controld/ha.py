"""controld HA: warm-standby replication + lease-based leader failover.

One ``ControlDaemon`` is a single point of failure: its loss freezes
policy feedback, lease reaping and epoch switches for the whole farm.
This module removes it (DESIGN.md §Controld-HA):

* ``LeaseStore`` / ``FileLeaseStore`` — a tiny shared arbiter holding
  *the* leadership lease: ``(holder, expires, generation)``. Leadership
  is time-bounded — a leader that stops renewing (dead, partitioned)
  loses it one term after its last renewal, and any standby may then
  claim it. ``generation`` increments on every ownership change and
  fences stale leaders.
* ``HANode`` — one replica: a ``ControlDaemon`` plus a role. The
  *leader* serves clients, renews its lease, and ships every fresh WAL
  entry to its standbys before replying (``controld.replication``).
  A *standby* rejects client mutations with a ``NOT_LEADER`` reply
  (the failover transport's cue to try elsewhere), applies shipped
  entries through the journal-replay path so its ``state_digest``
  tracks the leader byte-for-byte, and — on any activity after the
  lease lapses — claims the lease and promotes: the takeover needs no
  external coordinator, a retrying client is enough to drive it.
* ``HACluster`` — the in-proc wiring (simnet, tests, benches): N nodes
  over one arbiter and in-proc transports, with ``kill_leader`` for
  chaos scenarios and ``client_endpoints()`` feeding a
  ``FailoverTransport``.

What counts as downtime: from the instant the leader dies until a
standby's promotion, *mutating* calls are retried by the client (capped
backoff) — the data plane keeps forwarding on the last programmed
epoch tables throughout, so bundles are not lost, decisions are merely
deferred. The scenario gate is that the deferral is bounded by roughly
one lease term and that the successor resumes digest-identical.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional

from repro_torch.controld import messages as M
from repro_torch.controld.daemon import ControlDaemon
from repro_torch.controld.journal import Journal
from repro_torch.controld.replication import (STALE_GENERATION, Replicator,
                                        apply_entries, entry_from_wire)
from repro_torch.controld.transport import (NOT_LEADER, InProcTransport,
                                      TransportError)
from repro_torch.telemetry.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class LeaseState:
    """The arbiter's record: who leads, until when, at which generation."""

    holder: str = ""
    expires: float = -float("inf")
    generation: int = 0


class LeaseStore:
    """In-proc lease arbiter (simnet / tests / single-process clusters).

    ``claim`` grants the lease when it is free, expired, or already held
    by the claimant (renewal); an ownership *change* bumps
    ``generation`` — the fencing token a new leader announces and a
    stale one is rejected by."""

    def __init__(self, term_s: float, clock: Callable[[], float] = time.time):
        self.term_s = float(term_s)
        self.clock = clock
        self._state = LeaseState()

    def read(self) -> LeaseState:
        return self._state

    def claim(self, node_id: str,
              now: Optional[float] = None) -> Optional[LeaseState]:
        now = float(self.clock()) if now is None else float(now)
        st = self.read()
        if st.holder == node_id:
            new = LeaseState(node_id, now + self.term_s, st.generation)
        elif not st.holder or st.expires <= now:
            new = LeaseState(node_id, now + self.term_s, st.generation + 1)
        else:
            return None
        self._write(new)
        return new

    def release(self, node_id: str) -> None:
        if self.read().holder == node_id:
            self._write(LeaseState(holder="", expires=-float("inf"),
                                   generation=self.read().generation))

    def _write(self, st: LeaseState) -> None:
        self._state = st


class FileLeaseStore(LeaseStore):
    """File-backed arbiter for multi-process deployments
    (``run_controld --lease-store``): the lease is one JSON file updated
    via tmp + atomic ``os.replace`` under a short ``O_EXCL`` lock file
    (stale locks from a killed claimant are broken after
    ``lock_timeout_s``)."""

    def __init__(self, path: str, term_s: float,
                 clock: Callable[[], float] = time.time,
                 lock_timeout_s: float = 2.0):
        super().__init__(term_s, clock)
        self.path = path
        self.lock_timeout_s = float(lock_timeout_s)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def read(self) -> LeaseState:
        try:
            with open(self.path, encoding="utf-8") as f:
                d = json.load(f)
            return LeaseState(holder=str(d["holder"]),
                              expires=float(d["expires"]),
                              generation=int(d["generation"]))
        except (OSError, json.JSONDecodeError, KeyError, ValueError):
            return LeaseState()

    def claim(self, node_id: str,
              now: Optional[float] = None) -> Optional[LeaseState]:
        with self._locked():
            return super().claim(node_id, now)

    def release(self, node_id: str) -> None:
        with self._locked():
            super().release(node_id)

    def _write(self, st: LeaseState) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"holder": st.holder, "expires": st.expires,
                       "generation": st.generation}, f)
        os.replace(tmp, self.path)

    def _locked(self):
        store = self

        class _Lock:
            def __enter__(self):
                lock = store.path + ".lock"
                deadline = time.monotonic() + store.lock_timeout_s
                while True:
                    try:
                        fd = os.open(lock, os.O_CREAT | os.O_EXCL
                                     | os.O_WRONLY)
                        os.close(fd)
                        return self
                    except FileExistsError:
                        if time.monotonic() >= deadline:
                            # claimant died holding the lock: break it
                            try:
                                os.unlink(lock)
                            except OSError:
                                pass
                            deadline = (time.monotonic()
                                        + store.lock_timeout_s)
                        time.sleep(0.005)

            def __exit__(self, *exc):
                try:
                    os.unlink(store.path + ".lock")
                except OSError:
                    pass

        return _Lock()


class _HaMetrics:
    """Role gauge, promotion counter, failover histogram, lag gauge."""

    FAILOVER_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                        2.5, 5.0, 10.0, float("inf"))

    def __init__(self, registry: MetricsRegistry, node: "HANode"):
        registry.gauge(
            "controld_ha_role",
            "1 = leader, 0 = standby, by node.", labelnames=("node",)
        ).labels(node=node.node_id).set_function(
            lambda: 1.0 if node.role == "leader" else 0.0)
        registry.gauge(
            "controld_ha_replication_lag",
            "Journal entries the slowest live standby trails the leader "
            "by, by node (0 for standbys).", labelnames=("node",)
        ).labels(node=node.node_id).set_function(
            lambda: float(node.replicator.lag())
            if node.role == "leader" else 0.0)
        self.promotions = registry.counter(
            "controld_ha_promotions_total",
            "Standby-to-leader promotions, by node.",
            labelnames=("node",)).labels(node=node.node_id)
        self.failover_seconds = registry.histogram(
            "controld_ha_failover_seconds",
            "Leader-death-to-promotion duration as measured by the "
            "driving harness (sim / demo).", labelnames=("node",),
            buckets=self.FAILOVER_BUCKETS).labels(node=node.node_id)


class HANode:
    """One replica: a ``ControlDaemon`` + a lease-governed role.

    Transport-facing: ``handle(msg)`` is a drop-in for
    ``ControlDaemon.handle`` — hand an ``HANode`` to ``SocketServer`` or
    ``InProcTransport`` and it serves clients, replication and lease
    fencing on one endpoint."""

    def __init__(self, node_id: str, daemon: ControlDaemon,
                 store: LeaseStore,
                 clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None):
        self.node_id = str(node_id)
        self.daemon = daemon
        self.store = store
        self.clock = daemon.clock if clock is None else clock
        self.faults = faults
        self.role = "standby"
        self.generation = 0
        self.alive = True
        self.replicator = Replicator(self.node_id, daemon.journal,
                                     faults=faults)
        #: standby transports a (future) leader replicates to, by name
        self.peers: dict[str, object] = {}
        self.promotions = 0
        self.promoted_at: Optional[float] = None
        self.promoted_digest: Optional[str] = None
        self._outbox: list = []
        # serializes handle()/step() when a socket deployment runs a
        # lease-renewal ticker thread next to the server's selector loop;
        # uncontended (in-proc, simnet) it is a few ns per call
        self._lock = threading.RLock()
        self._mx = None if metrics is None else _HaMetrics(metrics, self)

    # -- lifecycle -------------------------------------------------------------
    def add_peer(self, name: str, transport) -> None:
        """Declare a peer standby endpoint. A leader attaches it for
        replication immediately; a standby remembers it for when it
        promotes."""
        self.peers[name] = transport
        if self.role == "leader":
            self.replicator.attach(name, transport, self.generation)

    def kill(self) -> None:
        """Model a SIGKILL for in-proc chaos: the node stops answering
        (its transports raise ``TransportError``); state is NOT cleaned
        up, exactly like a dead process."""
        self.alive = False

    def step(self, now: Optional[float] = None) -> None:
        """One lease-protocol beat: a leader renews (and steps down if
        the arbiter says it lost the lease); a standby claims once the
        lease lapsed — promotion is lazy, driven by whoever calls this
        (each handled client message does, so a retrying client alone
        completes a failover)."""
        if not self.alive:
            return
        with self._lock:
            now = float(self.clock()) if now is None else float(now)
            if self.role == "leader":
                got = self.store.claim(self.node_id, now)
                if got is None or got.holder != self.node_id:
                    self._demote()
                else:
                    self.generation = got.generation
                return
            st = self.store.read()
            if st.holder == self.node_id or st.expires <= now:
                got = self.store.claim(self.node_id, now)
                if got is not None and got.holder == self.node_id:
                    self._promote(now, got)

    def reattach_dead_peers(self) -> None:
        """Leader-side repair beat (socket ticker / periodic caller):
        re-probe peers that were marked dead or never attached — a standby
        that came back is caught up from backlog and resumes synchronous
        replication."""
        with self._lock:
            if self.role != "leader":
                return
            for name, transport in self.peers.items():
                p = self.replicator.peers.get(name)
                if p is None or not p.alive:
                    self.replicator.attach(name, transport, self.generation)

    def _promote(self, now: float, lease: LeaseState) -> None:
        self.role = "leader"
        self.generation = lease.generation
        self.promotions += 1
        self.promoted_at = now
        # the digest the successor RESUMES at — captured before any new
        # client message applies, compared by the chaos gates against
        # the dead leader's last digest
        self.promoted_digest = self.daemon.state_digest()
        if self.daemon.journal is not None:
            self.daemon.journal.on_append = self._outbox.append
        if self._mx is not None:
            self._mx.promotions.inc()
        # fence + re-replicate: tell every reachable peer, attach the
        # live ones as this leader's standbys
        for name, transport in self.peers.items():
            try:
                transport.call(M.LeaseClaim(node=self.node_id,
                                            generation=self.generation,
                                            expires=lease.expires))
            except TransportError:
                continue
            self.replicator.attach(name, transport, self.generation)

    def _demote(self) -> None:
        self.role = "standby"
        if self.daemon.journal is not None:
            self.daemon.journal.on_append = None
        self._outbox.clear()
        self.replicator.peers.clear()

    def record_failover(self, duration_s: float) -> None:
        """Observed by the driving harness (sim window loop, --ha-demo):
        leader-death-to-promotion, onto the failover histogram."""
        if self._mx is not None:
            self._mx.failover_seconds.observe(float(duration_s))

    def _fault(self, point: str) -> None:
        if self.faults is not None:
            self.faults.crashpoint(point)

    # -- the transport-facing entry point -------------------------------------
    def handle(self, msg, now: Optional[float] = None) -> M.Reply:
        with self._lock:
            return self._handle(msg, now)

    def _handle(self, msg, now: Optional[float] = None) -> M.Reply:
        if msg.KIND == M.ReplicateEntries.KIND:
            return self._on_replicate(msg)
        if msg.KIND == M.LeaseClaim.KIND:
            return self._on_lease_claim(msg)
        now = float(self.clock()) if now is None else float(now)
        if msg.KIND not in M.MUTATING_KINDS:
            reply = self.daemon.handle(msg, now=now)
            if reply.ok and msg.KIND == M.Status.KIND:
                reply.data["ha"] = {"node": self.node_id, "role": self.role,
                                    "generation": self.generation}
            return reply
        self.step(now)
        if self.role != "leader":
            return M.Reply(False, error=(
                f"{NOT_LEADER}: node {self.node_id} is standby "
                f"(generation {self.generation}) — retry the leader"))
        reply = self.daemon.handle(msg, now=now)
        self._fault("ha.leader.before_ship")
        if self._outbox:
            # copy-and-clear IN PLACE: journal.on_append holds a bound
            # reference to this exact list
            batch = list(self._outbox)
            self._outbox.clear()
            fenced = self.replicator.ship(batch, self.generation)
            if fenced:
                # a peer holds a newer generation: we are an ex-leader
                # that somehow still answered — step down; the client's
                # request id makes its retry against the successor safe
                self._demote()
        self._fault("ha.leader.after_ship")
        return reply

    # -- HA protocol handlers --------------------------------------------------
    def _on_replicate(self, msg: M.ReplicateEntries) -> M.Reply:
        if msg.generation < self.generation:
            return M.Reply(False, error=(
                f"{STALE_GENERATION}: shipment generation "
                f"{msg.generation} < {self.generation}"))
        if msg.generation > self.generation and self.role == "leader":
            self._demote()  # fenced by a newer leader's shipment
        self.generation = max(self.generation, int(msg.generation))
        j = self.daemon.journal
        head = -1 if j is None else j.seq
        entries = [entry_from_wire(d) for d in msg.entries]
        if entries and entries[0].seq > head + 1:
            ack = M.ReplicaAck(node=self.node_id, ack_seq=head,
                               need_from=head + 1,
                               generation=self.generation)
            return M.Reply(True, data=M.to_wire(ack))
        fresh = [e for e in entries if e.seq > head]
        if fresh:
            self._fault("ha.standby.before_apply")
            apply_entries(self.daemon, fresh)
            self._fault("ha.standby.after_apply")
            head = self.daemon.journal.seq if j is not None else (
                fresh[-1].seq)
        ack = M.ReplicaAck(node=self.node_id, ack_seq=head, need_from=-1,
                           generation=self.generation)
        return M.Reply(True, data=M.to_wire(ack))

    def _on_lease_claim(self, msg: M.LeaseClaim) -> M.Reply:
        if msg.generation > self.generation:
            self.generation = int(msg.generation)
            if self.role == "leader":
                self._demote()
        return M.Reply(True, data={"node": self.node_id, "role": self.role,
                                   "generation": self.generation})


class NodeTransport(InProcTransport):
    """In-proc transport onto one ``HANode`` that models process death:
    calls against a killed node raise ``TransportError`` (a connection
    refused), which is what ``FailoverTransport`` fails over on."""

    def __init__(self, node: HANode):
        super().__init__(node)
        self.node = node

    def call(self, msg) -> M.Reply:
        if not self.node.alive:
            raise TransportError(f"node {self.node.node_id} is down")
        return super().call(msg)


class HACluster:
    """N in-proc ``HANode`` replicas over one arbiter — the wiring used
    by simnet's ``leader_failover`` and the HA tests.

    Node 0 claims the lease at construction (the initial leader); every
    node knows every other as a peer, so whichever standby promotes
    later re-attaches the survivors as its own standbys."""

    def __init__(self, n_nodes: int = 2,
                 clock: Callable[[], float] = time.time,
                 term_s: float = 1.0,
                 store: Optional[LeaseStore] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None,
                 daemon_kwargs: Optional[dict] = None):
        if n_nodes < 2:
            raise ValueError("an HA cluster needs >= 2 nodes")
        self.clock = clock
        self.term_s = float(term_s)
        self.store = (LeaseStore(term_s, clock) if store is None else store)
        kw = dict(daemon_kwargs or {})
        kw.setdefault("clock", clock)
        self._daemon_kwargs = kw
        self.nodes: list[HANode] = []
        for i in range(n_nodes):
            daemon = ControlDaemon(journal=Journal(), **kw)
            self.nodes.append(HANode(
                f"cd{i}", daemon, self.store, clock=clock,
                metrics=metrics, faults=faults))
        for node in self.nodes:
            for other in self.nodes:
                if other is not node:
                    node.peers[other.node_id] = NodeTransport(other)
        self.nodes[0].step()  # claim -> leader; attaches peers

    def leader(self) -> Optional[HANode]:
        for node in self.nodes:
            if node.alive and node.role == "leader":
                return node
        return None

    def standbys(self) -> list[HANode]:
        return [n for n in self.nodes
                if n.alive and n.role == "standby"]

    def kill_leader(self) -> HANode:
        leader = self.leader()
        if leader is None:
            raise RuntimeError("no live leader to kill")
        leader.kill()
        return leader

    def step(self, now: Optional[float] = None) -> None:
        for node in self.nodes:
            node.step(now)

    def revive(self, node: HANode) -> None:
        """Bring a killed node back as a *fresh* standby: new daemon,
        empty journal. Its first shipped batch won't attach (gap), the
        ack's ``need_from`` asks for seq 0, and the leader streams the
        whole backlog — full-history catch-up over the normal protocol.
        The node object (and the transports bound to it) is reused, so
        peers and failover endpoints keep working."""
        if node.alive:
            raise RuntimeError(f"node {node.node_id} is not dead")
        node.daemon = ControlDaemon(journal=Journal(), **self._daemon_kwargs)
        node.replicator = Replicator(node.node_id, node.daemon.journal,
                                     faults=node.faults)
        node.role = "standby"
        node.generation = self.store.read().generation
        node._outbox.clear()
        node.promoted_at = None
        node.promoted_digest = None
        node.alive = True
        lead = self.leader()
        if lead is not None and node.node_id in lead.peers:
            lead.replicator.attach(node.node_id, lead.peers[node.node_id],
                                   lead.generation)

    def client_endpoints(self) -> list[NodeTransport]:
        """One transport per node, in node order — feed these to a
        ``FailoverTransport``."""
        return [NodeTransport(n) for n in self.nodes]
