"""The EJ-FAT data plane (parse -> validate -> epoch -> calendar -> member
rewrite) for a batch of packets: wrapper of the CUDA kernels of
``csrc/ejfat_kernels.cu`` (a persistent grid, 4 packets per thread), in two
designs picked by the tables' size (``_design``): ``lb_route_kernel``
("shared": every block stages all the tables in shared memory) while they
fit a block's shared memory, ``lb_route_global_kernel`` ("global": blocks
stage only the epoch segments and read calendars and member fields from
device memory) above that, e.g. ``farm_1k``'s 4 x 4096 member slots.

Port of the Pallas kernel ``repro/kernels/lb_route.py::lb_route``. Headers
are ``int32[N, 4]`` (the u32 wire words' bits, row-major); tables are one
instance or the stacked virtual instances, in which case ``instance_id``
(``int32[N]``) selects each packet's balancing context. A CUDA input
launches the kernel; a CPU input takes ``ref.lb_route_ref``, and so does a
meta input (shapes and dtypes only: the dry run's, nothing computes); any
other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocol import CALENDAR_SLOTS
from repro_torch.core.tables import MAX_EPOCH_SEGMENTS, DeviceTables
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import lb_route_ref

#: shared memory a block of an H100 can opt in to (227 KB): the "shared"
#: design holds all instances' tables in it, the "global" design the segments
MAX_SHARED_BYTES = 232_448

#: the two designs, in the C entry's numbering
DESIGNS = ("shared", "global")


def _align16(b: int) -> int:
    return (b + 15) & ~15


def smem_bytes(design: str, n_inst: int, n_rows: int, n_members: int) -> int:
    """Shared memory per block of ``design`` (``ejfat_kernels.cu``'s
    ``lb_smem_bytes`` / ``lb_segment_bytes``): member fields as one int4 per
    slot, int32 calendars, u64 starts in rows of 17, int32 segment rows."""
    segments = _align16(8 * n_inst * (MAX_EPOCH_SEGMENTS + 1)) + 4 * n_inst * MAX_EPOCH_SEGMENTS
    if design == "global":
        return segments
    return (_align16(16 * n_inst * n_members)
            + _align16(4 * n_inst * n_rows * CALENDAR_SLOTS) + segments)


def _design(n_inst: int, n_rows: int, n_members: int) -> str:
    """The design for these tables: "shared" while they fit a block's
    shared memory, else "global"."""
    if smem_bytes("shared", n_inst, n_rows, n_members) <= MAX_SHARED_BYTES:
        return "shared"
    return "global"


def lb_route(headers: torch.Tensor, tables: DeviceTables, instance_id=None):
    """Route N packets -> (member, node, lane, valid) int32[N]."""
    multi = tables.seg_row.ndim == 2
    if multi and instance_id is None:
        raise ValueError("stacked tables require per-packet instance_id")
    if not multi and instance_id is not None:
        raise ValueError("instance_id given but tables are single-instance")
    if headers.ndim != 2 or headers.shape[1] != 4:
        raise ValueError(f"headers must be [N, 4] words, got {tuple(headers.shape)}")
    if headers.device.type in ("cpu", "meta"):
        return lb_route_ref(headers, tables, instance_id)
    if headers.device.type != "cuda":
        raise ValueError(f"lb_route: unsupported device {headers.device}")
    return _launch(headers, tables, instance_id)


def _launch(headers, tables: DeviceTables, instance_id):
    dev = headers.device
    n = headers.shape[0]
    n_inst = tables.seg_row.shape[0] if instance_id is not None else 1
    lead = (n_inst,) if instance_id is not None else ()
    n_seg = tables.seg_row.shape[-1]
    n_rows = tables.calendars.shape[-2]
    n_members = tables.member_node.shape[-1]
    _lib.require(headers, "headers", torch.int32, dev, (n, 4))
    if headers.data_ptr() % 16:
        raise ValueError("headers must be 16-byte aligned (one vector load per packet)")
    if n_seg != MAX_EPOCH_SEGMENTS:
        raise ValueError(f"tables must have {MAX_EPOCH_SEGMENTS} epoch segments, got {n_seg}")
    if instance_id is not None:
        _lib.require(instance_id, "instance_id", torch.int32, dev, (n,))
    _lib.require(tables.seg_start_hi, "seg_start_hi", torch.int64, dev, lead + (n_seg,))
    _lib.require(tables.seg_start_lo, "seg_start_lo", torch.int64, dev, lead + (n_seg,))
    _lib.require(tables.seg_row, "seg_row", torch.int32, dev, lead + (n_seg,))
    _lib.require(tables.calendars, "calendars", torch.int32, dev,
                 lead + (n_rows, CALENDAR_SLOTS))
    for name in ("member_node", "member_base_lane", "member_lane_mask", "member_valid"):
        _lib.require(getattr(tables, name), name, torch.int32, dev, lead + (n_members,))
    if tables.calendars.data_ptr() % 16:
        raise ValueError("calendars must be 16-byte aligned (staged in 16-byte copies)")
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return tuple(outs)
    design = _design(n_inst, n_rows, n_members)
    smem = smem_bytes(design, n_inst, n_rows, n_members)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{n_inst} stacked instances need {smem} B of shared memory "
                         f"for their epoch segments, above the {MAX_SHARED_BYTES} B a "
                         "block can hold")
    lib = _lib.lib()
    err = lib.ejfat_lb_route(
        DESIGNS.index(design), headers.data_ptr(),
        None if instance_id is None else instance_id.data_ptr(), n,
        tables.seg_start_hi.data_ptr(), tables.seg_start_lo.data_ptr(),
        tables.seg_row.data_ptr(), tables.calendars.data_ptr(),
        tables.member_node.data_ptr(), tables.member_base_lane.data_ptr(),
        tables.member_lane_mask.data_ptr(), tables.member_valid.data_ptr(),
        n_inst, n_rows, CALENDAR_SLOTS, n_members,
        *(o.data_ptr() for o in outs), _lib.stream_ptr(dev))
    _lib.check(err, "lb_route")
    _lib.LAUNCHES["lb_route"] += 1
    if design == "global":
        _lib.LAUNCHES["lb_route_global"] += 1
    return tuple(outs)
