"""repro_torch.controld — session-oriented control-plane service (DESIGN.md
§Controld).

The paper's control plane as a *service*, not a function call: compute nodes
reserve a virtual LB instance, register members, stream heartbeat telemetry,
and hold leases whose expiry triggers the same hit-less drain as an explicit
failure. Per-reservation pluggable reweighting policies (proportional / PID
fill controller), an event-sourced journal with snapshot + replay for
hit-less daemon restart, two property-equal transports (in-process and
length-prefixed socket), and HA: warm-standby WAL replication with
lease-based leader failover (DESIGN.md §Controld-HA).
"""
from repro_torch.controld.daemon import (ControlDaemon, MemberLanes, Session,
                                   SessionError)
from repro_torch.controld.ha import (FileLeaseStore, HACluster, HANode, LeaseState,
                               LeaseStore, NodeTransport)
from repro_torch.controld.journal import Entry, Journal
from repro_torch.controld.messages import (HA_KINDS, MESSAGE_TYPES, MUTATING_KINDS,
                                     Deregister, DeregisterBatch, Free,
                                     LeaseClaim, MessageError, Register,
                                     RegisterBatch, ReplicaAck,
                                     ReplicateEntries, Reply, Reserve,
                                     ReserveFabric, SendState, SendStateBatch,
                                     Status, Tick)
from repro_torch.controld.policy import (POLICIES, PIDFillPolicy, PolicyConfig,
                                   ProportionalPolicy, WeightPolicy,
                                   make_policy)
from repro_torch.controld.replication import Replicator, apply_entries
from repro_torch.controld.transport import (NOT_LEADER, ControldClient,
                                      ControldError, FailoverTransport,
                                      InProcTransport, RetryPolicy,
                                      SocketClient, SocketServer,
                                      TransportError)

__all__ = [
    "ControlDaemon", "MemberLanes", "Session", "SessionError",
    "Entry", "Journal",
    "MESSAGE_TYPES", "MUTATING_KINDS", "HA_KINDS", "MessageError",
    "Reserve", "ReserveFabric", "Free", "Register", "RegisterBatch",
    "Deregister", "DeregisterBatch", "SendState",
    "SendStateBatch", "Tick", "Status", "Reply",
    "ReplicateEntries", "ReplicaAck", "LeaseClaim",
    "POLICIES", "PolicyConfig", "WeightPolicy", "ProportionalPolicy",
    "PIDFillPolicy", "make_policy",
    "Replicator", "apply_entries",
    "LeaseStore", "FileLeaseStore", "LeaseState", "HANode", "HACluster",
    "NodeTransport",
    "ControldClient", "ControldError", "InProcTransport", "SocketClient",
    "SocketServer", "TransportError", "FailoverTransport", "RetryPolicy",
    "NOT_LEADER",
]
