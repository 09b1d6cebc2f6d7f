"""Reassembly group/duplicate masks over sorted segments: wrapper of the
CUDA kernel ``csrc/ejfat_kernels.cu::seg_masks_kernel``.

Port of the Pallas kernel ``repro/kernels/reassembly.py::seg_masks``. On
columns key-sorted by ``(event_hi, event_lo, daq_id, seg_index, arrival)``:

    new_group[i] = valid[i] and (ev, daq)[i] != (ev, daq)[i-1]
    dup[i]       = valid[i] and (ev, daq)[i] == (ev, daq)[i-1]
                            and seg_index[i] == seg_index[i-1]

Row 0 compares against an all-zero sentinel. Columns are int32 (the u32
values' bits). A CUDA input launches the kernel; a CPU input takes
``ref.seg_masks_ref``. Reached through ``data/reassembly.reassembly_plan``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import seg_masks_ref


def seg_masks(valid, ev_hi, ev_lo, daq, seg_index):
    """(new_group, dup) int32[N] masks over *sorted* segment columns."""
    cols = (valid, ev_hi, ev_lo, daq, seg_index)
    if valid.device.type == "cpu":
        return seg_masks_ref(*cols)
    if valid.device.type != "cuda":
        raise ValueError(f"seg_masks: unsupported device {valid.device}")
    dev = valid.device
    n = valid.shape[0]
    for name, c in zip(("valid", "ev_hi", "ev_lo", "daq", "seg_index"), cols):
        _lib.require(c, name, torch.int32, dev, (n,))
    new_group = torch.empty(n, dtype=torch.int32, device=dev)
    dup = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return new_group, dup
    err = _lib.lib().ejfat_seg_masks(*(c.data_ptr() for c in cols), n,
                                     new_group.data_ptr(), dup.data_ptr(),
                                     _lib.stream_ptr(dev))
    _lib.check(err, "seg_masks")
    _lib.LAUNCHES["seg_masks"] += 1
    return new_group, dup
