"""The fused simulator's calendar rebuild: wrapper of the CUDA kernel
``csrc/simnet_kernels.cu::build_calendar_kernel`` (one block, one thread per
slot; the round-robin in one warp, one ``redux.sync`` per slot over integer
keys; in place of the quota walk, which the round-robin's output never needs,
a parallel check that traps if a member got more slots than its quota).

A device helper of the simulator, not the port of a Pallas kernel: it takes
the place of the JAX package's ``simnet/fused.py::_device_calendar`` under
``lax.cond``. ``build_calendar(w, do_sw, out)`` writes the calendar of the
float64 weights ``w`` (M members, all positive, 1 <= M <= n_slots) into the
int32 ``out`` (``n_slots = out.shape[0]`` slots, at most 512) when the
device bool ``do_sw`` holds, and leaves ``out`` untouched otherwise: the
switch decision is read on the device, so a captured window step has no host
read. The port's host calendar (``core.calendar.build_calendar``) refuses
more members than slots too. A CUDA input launches the kernel; a CPU input
takes ``ref.build_calendar_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import build_calendar_ref

#: members and slots the kernel takes (``kMaxCalMembers``, ``kMaxSlots``)
MAX_MEMBERS = 512
MAX_SLOTS = 512


def build_calendar(w, do_sw, out):
    if w.ndim != 1 or not 1 <= w.shape[0] <= MAX_MEMBERS:
        raise ValueError(f"w must be [M] with 1 <= M <= {MAX_MEMBERS}, got {tuple(w.shape)}")
    if out.ndim != 1 or not 1 <= out.shape[0] <= MAX_SLOTS:
        raise ValueError(f"out must be [n_slots] with 1 <= n_slots <= {MAX_SLOTS}, "
                         f"got {tuple(out.shape)}")
    if w.shape[0] > out.shape[0]:
        raise ValueError(f"more members ({w.shape[0]}) than slots ({out.shape[0]})")
    if w.device.type == "cpu":
        return build_calendar_ref(w, do_sw, out)
    if w.device.type != "cuda":
        raise ValueError(f"build_calendar: unsupported device {w.device}")
    dev = w.device
    _lib.require(w, "w", torch.float64, dev)
    _lib.require(do_sw, "do_sw", torch.bool, dev)
    if do_sw.numel() != 1:
        raise ValueError("do_sw must hold one bool")
    _lib.require(out, "out", torch.int32, dev)
    err = _lib.lib().ejfat_build_calendar(w.data_ptr(), w.shape[0], do_sw.data_ptr(),
                                          out.shape[0], out.data_ptr(), _lib.stream_ptr(dev))
    _lib.check(err, "build_calendar")
    _lib.LAUNCHES["build_calendar"] += 1
    return out
