"""Dispatch planning — per-packet buffer positions: wrapper of the CUDA
kernel ``csrc/ejfat_kernels.cu::dispatch_plan_kernel`` (one launch, single
pass, decoupled look-back across tiles).

Port of the Pallas kernel ``repro/kernels/dispatch.py::dispatch_plan``. For
packet i with member m, pos_i = #packets j<i with member j == m (stable);
pos = -1 for member < 0, and a member >= n_members gets pos 0 and is not
counted. Returns (pos int32[N], counts int32[n_members]). A CUDA input
launches the kernel; a CPU input takes ``ref.dispatch_plan_ref``, and so
does a meta input (shapes and dtypes only: the dry run's, nothing
computes); any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import dispatch_plan_ref

#: members per chunk: the kernel's per-warp histograms are 8 x 1024 int32
#: of shared memory (32 KB) and each thread owns 4 of a chunk's members
#: (``kDpMaxMembers`` in the source); more members run as more chunks, one
#: per row of the grid's second dimension
CHUNK_MEMBERS = 1024
#: the grid's second dimension (65,535 chunks)
MAX_MEMBERS = 65_535 * CHUNK_MEMBERS


def dispatch_plan(member: torch.Tensor, *, n_members: int):
    if member.ndim != 1:
        raise ValueError(f"member must be 1-D, got {tuple(member.shape)}")
    if member.device.type in ("cpu", "meta"):
        return dispatch_plan_ref(member, n_members=n_members)
    if member.device.type != "cuda":
        raise ValueError(f"dispatch_plan: unsupported device {member.device}")
    if not 1 <= n_members <= MAX_MEMBERS:
        raise ValueError(f"n_members must be in [1, {MAX_MEMBERS}], got {n_members}")
    # (the reference's Pallas kernel refuses n_members = 0 too)
    dev = member.device
    n = member.shape[0]
    _lib.require(member, "member", torch.int32, dev, (n,))
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n_members, dtype=torch.int32, device=dev)
    if n == 0:
        return pos, counts.zero_()
    lib = _lib.lib()
    # per chunk of members, the tile counter and the look-back's words (per
    # tile and per group of tiles, per member), cleared by the kernel's host
    # entry on the stream
    scratch = torch.empty(lib.ejfat_dispatch_scratch_words(n, n_members),
                          dtype=torch.int64, device=dev)
    err = lib.ejfat_dispatch_plan(member.data_ptr(), n, n_members, scratch.data_ptr(),
                                  pos.data_ptr(), counts.data_ptr(), _lib.stream_ptr(dev))
    _lib.check(err, "dispatch_plan")
    _lib.LAUNCHES["dispatch_plan"] += 1
    return pos, counts
