"""EJ-FAT core: the paper's load balancer as PyTorch modules."""

from repro_torch.core.calendar import build_calendar, calendar_counts, quotas_from_weights
from repro_torch.core.control_plane import (
    ControlPolicy,
    LoadBalancerControlPlane,
    MemberTelemetry,
)
from repro_torch.core.epoch import EpochManager, ReconfigurationError
from repro_torch.core.instance import N_INSTANCES, VirtualLoadBalancer
from repro_torch.core.dataplane import DataPlane, DataPlaneCache, combine_payloads
from repro_torch.core.lpm import LPMTable, Prefix, range_to_prefixes
from repro_torch.core.protocol import (
    CALENDAR_SLOTS,
    LB_SERVICE_PORT,
    LBHeader,
    MAGIC,
    decode_fields,
    encode_headers,
    join64,
    split64,
    validate,
)
from repro_torch.core.router import Route, dispatch, member_positions, route
from repro_torch.core.tables import (
    DeviceTables,
    MemberSpec,
    RouterState,
    TableError,
    device_tables_from_numpy,
)

__all__ = [
    "CALENDAR_SLOTS", "ControlPolicy", "DataPlane", "DataPlaneCache",
    "DeviceTables", "EpochManager", "LBHeader", "LB_SERVICE_PORT", "LPMTable",
    "LoadBalancerControlPlane", "MAGIC", "MemberSpec", "MemberTelemetry",
    "N_INSTANCES", "Prefix", "ReconfigurationError", "Route", "RouterState",
    "TableError", "VirtualLoadBalancer", "build_calendar", "calendar_counts",
    "combine_payloads", "decode_fields", "device_tables_from_numpy",
    "dispatch", "encode_headers", "join64", "member_positions",
    "quotas_from_weights", "range_to_prefixes", "route", "split64",
    "validate",
]
