"""Stateless data-plane routing, plain PyTorch.

The routing decision for a packet is a pure function of (header fields,
programmed tables) — examine a single packet with no other history and
determine its final destination (paper §I-B.3). The CUDA kernel behind
``kernels/lb_route.py`` implements the same math for tensors on the card;
this module is the reference semantics it is held to, and also provides the
per-member pack (``member_positions`` / ``dispatch``).

Integer convention: event words arrive as int64 tensors holding the u32
value (``protocol.decode_fields``), so the u64 compare is plain int64 math.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.protocol import SLOT_MASK, validate
from repro_torch.core.tables import DeviceTables
from repro_torch.distributed import dp


@dataclasses.dataclass
class Route:
    member: torch.Tensor  # int32[N]  (-1 => discard)
    node: torch.Tensor    # int32[N]  destination node
    lane: torch.Tensor    # int32[N]  receive lane (UDP port analogue)
    valid: torch.Tensor   # bool[N]


def _ge_u64(e_hi, e_lo, s_hi, s_lo):
    """(e_hi, e_lo) >= (s_hi, s_lo) on u32 pairs held in int64, broadcasting."""
    return (e_hi > s_hi) | ((e_hi == s_hi) & (e_lo >= s_lo))


def _segment_index(s_hi, s_lo, event_hi, event_lo):
    """idx = (#segments with start <= e) - 1, clipped into the table."""
    ge = _ge_u64(event_hi[..., None], event_lo[..., None], s_hi, s_lo)
    idx = ge.sum(dim=-1) - 1
    return idx.clamp(0, s_hi.shape[-1] - 1)


def epoch_row(tables: DeviceTables, event_hi, event_lo):
    """Sorted-boundary segment lookup: row index into the calendar table.

    Equivalent to the P4 LPM 'Calendar Epoch Assignment'.
    idx = (#segments with start <= e) - 1.
    """
    idx = _segment_index(tables.seg_start_hi, tables.seg_start_lo,
                         event_hi.to(torch.int64), event_lo.to(torch.int64))
    return tables.seg_row[idx]


def _finish(ok, member, node, lane, header_words) -> Route:
    if header_words is not None:
        ok = ok & validate(header_words)
    neg = torch.full_like(member, -1)
    return Route(member=torch.where(ok, member, neg),
                 node=torch.where(ok, node, neg),
                 lane=torch.where(ok, lane, neg), valid=ok)


def route(
    tables: DeviceTables,
    event_hi: torch.Tensor,
    event_lo: torch.Tensor,
    entropy: torch.Tensor,
    header_words: torch.Tensor | None = None,
) -> Route:
    """Route N packets. All lookups are vectorized gathers on small tables."""
    event_lo = event_lo.to(torch.int64)
    row = epoch_row(tables, event_hi, event_lo)
    slot = event_lo & SLOT_MASK
    member = tables.calendars[row.clamp(0, tables.calendars.shape[0] - 1).long(), slot]

    m = member.clamp(0, tables.member_node.shape[0] - 1).long()
    node = tables.member_node[m]
    lane = tables.member_base_lane[m] + (
        entropy.to(torch.int32) & tables.member_lane_mask[m])
    ok = (row >= 0) & (tables.member_valid[m] > 0) & (member >= 0)
    return _finish(ok, member, node, lane, header_words)


def route_instances(
    stacked: DeviceTables,
    instance_id: torch.Tensor,
    event_hi, event_lo, entropy,
    header_words=None,
) -> Route:
    """Route packets across virtual LB instances (paper §I-C, 4 instances).

    ``stacked`` carries a leading instance dim (tables.stack_tables); each
    packet's tables are selected by its instance id (from the L3 filter), in
    one fused gather pass (O(N) work regardless of instance count).
    """
    n_inst = stacked.seg_row.shape[0]
    iid = instance_id.to(torch.int64).clamp(0, n_inst - 1)
    event_lo = event_lo.to(torch.int64)

    # Calendar Epoch Assignment on per-packet segment tables [N, S].
    idx = _segment_index(stacked.seg_start_hi[iid], stacked.seg_start_lo[iid],
                         event_hi.to(torch.int64), event_lo)
    row = stacked.seg_row[iid, idx]

    # Calendar to Member Map.
    slot = event_lo & SLOT_MASK
    member = stacked.calendars[
        iid, row.clamp(0, stacked.calendars.shape[1] - 1).long(), slot]

    # Member Lookup and Rewrite.
    m = member.clamp(0, stacked.member_node.shape[-1] - 1).long()
    node = stacked.member_node[iid, m]
    lane = stacked.member_base_lane[iid, m] + (
        entropy.to(torch.int32) & stacked.member_lane_mask[iid, m])
    ok = (row >= 0) & (stacked.member_valid[iid, m] > 0) & (member >= 0)
    return _finish(ok, member, node, lane, header_words)


# ---------------------------------------------------------------------------
# Dispatch: pack routed packets into per-member buffers (capacity model).
# ---------------------------------------------------------------------------

def member_positions(member: torch.Tensor, n_members: int, capacity: int):
    """Position of each packet within its member's buffer (sort-based pack).

    pos_i = #packets j<i with member_j == member_i: a sort of the unique
    keys ``member * n + arrival`` (int64, so no overflow guard is needed)
    followed by a segment-offset subtraction — a packet's position is its
    sorted rank minus the rank of the first packet of its member segment.

    Returns (pos int32[N], keep bool[N], counts int32[n_members]). Packets
    beyond ``capacity`` are dropped, and every drop is accounted by the
    caller.
    """
    n = member.shape[0]
    nn = max(n, 1)
    dev = member.device
    mem = member.to(torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    valid = (mem >= 0) & (mem < n_members)
    mv = torch.where(valid, mem, torch.full_like(mem, n_members))
    sk = torch.sort(mv * nn + i).values     # keys unique: a stable argsort
    sm = sk // nn                           # sorted member ids
    orig = sk % nn                          # original index of each sorted slot
    # One searchsorted (n_members + 1 probes) gives every member's first
    # sorted position AND the per-member totals.
    probes = torch.arange(n_members + 1, dtype=torch.int64, device=dev) * nn
    starts = torch.searchsorted(sk, probes, side="left")
    counts = starts[1:] - starts[:-1]
    pos_sorted = i - starts[sm.clamp(0, n_members)]
    pos = torch.empty_like(pos_sorted).scatter_(0, orig, pos_sorted)
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    keep = valid & (pos < capacity)
    return pos.to(torch.int32), keep, counts.to(torch.int32)


def scatter_by_plan(payload, member, pos, keep, n_members: int, capacity: int):
    """Scatter payload rows into [n_members, capacity, ...] buffers plus an
    occupancy map. Rows with ``keep`` false, or whose member is outside
    ``[0, n_members)``, are written to a spill row past the end and dropped
    (the counterpart of an out-of-bounds scatter index with ``mode="drop"``:
    an in-bounds dummy index would clobber a real packet's slot)."""
    spill = n_members * capacity
    member = member.to(torch.int64)
    inside = keep & (member >= 0) & (member < n_members)
    flat = torch.where(inside, member * capacity + pos.to(torch.int64),
                       torch.full_like(member, spill))
    buf = torch.zeros((spill + 1,) + tuple(payload.shape[1:]),
                      dtype=payload.dtype, device=payload.device)
    buf.index_put_((flat,), payload)
    occ = torch.zeros(spill + 1, dtype=torch.int32, device=payload.device)
    occ.index_put_((flat,), torch.ones_like(flat, dtype=torch.int32))
    return (buf[:spill].reshape((n_members, capacity) + tuple(payload.shape[1:])),
            occ[:spill].reshape(n_members, capacity))


def dispatch(
    payload: torch.Tensor,  # [N, ...]
    member: torch.Tensor,   # int32[N], -1 = dropped
    n_members: int,
    capacity: int,
):
    """Scatter payloads into [n_members, capacity, ...] buffers + occupancy."""
    pos, keep, counts = member_positions(member, n_members, capacity)
    buf, occ = scatter_by_plan(payload, member, pos, keep, n_members, capacity)
    return buf, occ, counts


# ---------------------------------------------------------------------------
# Redistribution across ranks: the "LB -> CN delivery" as an all_to_all.
# ---------------------------------------------------------------------------

def make_redistribute(mesh, axis_names, capacity_per_src: int):
    """Build the exchange of event payloads between data-parallel ranks.

    Each rank plays both DAQ-aggregation point (arrival order) and CN (event
    owner). Within a rank: pack the local events into per-member send
    buffers of ``capacity_per_src`` rows (``dispatch``); one
    ``torch.distributed.all_to_all_single`` over the mesh's process group
    swaps the member dim across ranks, and a second carries the occupancy;
    each member then holds every event routed to it. With one rank along
    ``axis_names`` the packed buffer is the result and no collective runs.

    Returns fn(payload[B_local, ...], member[B_local]) ->
      (recv[W*capacity_per_src, ...], occ[W*capacity_per_src]) on each rank,
      source-major (rows from rank s at ``s*capacity_per_src``), as the
      reference's shard_map returns per shard.
    """
    axis = tuple(axis_names) if isinstance(axis_names, (tuple, list)) else (axis_names,)
    n_members = math.prod(mesh.shape[a] for a in axis)

    def redistribute(payload, member):
        buf, occ, _ = dispatch(payload, member, n_members, capacity_per_src)
        flat = buf.reshape((-1,) + tuple(payload.shape[1:]))
        occ = occ.reshape(-1)
        if n_members > 1:
            if dist.get_world_size(mesh.group) != n_members:
                raise ValueError(f"the process group has {dist.get_world_size(mesh.group)} ranks; "
                                 f"the mesh's {axis} axes have {n_members}")
            flat, occ = dp.all_to_all(flat, mesh.group), dp.all_to_all(occ, mesh.group)
        return flat, occ

    return redistribute
