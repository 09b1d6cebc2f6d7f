"""The farm queues' bounded Lindley recursion: wrapper of the CUDA kernel
``csrc/simnet_kernels.cu::farm_serve_kernel``. One block per member: a copy
warp streams the member's rows through a ring of shared-memory tiles
(``cp.async`` in, coalesced stores out) while one thread walks them in
order with the next rows' operands already in registers, so only the
float64 chain of each row is serial.

A device helper of the simulator, not the port of a Pallas kernel: it takes
the place of the JAX package's ``lax.scan`` over the farm's time axis
(``repro/simnet/queues.py::_serve_jnp`` and the fused step). Rows come
sorted by (member, arrival, row), member m's at ``[offsets[m], offsets[m +
1])``; everything is float64. Returns ``(dep, drop, w, t_last, w_max)``:
per row the service completion (``inf`` when dropped) and the drop mask,
per member the backlog and clock after its last row and the peak backlog.
A CUDA input launches the kernel; a CPU input takes ``ref.farm_serve_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import farm_serve_ref


def farm_serve(t, s, offsets, w0, t0, cap):
    if t.ndim != 1 or offsets.ndim != 1 or offsets.shape[0] != w0.shape[0] + 1:
        raise ValueError("t must be [N] and offsets [n_members + 1]")
    if t.device.type == "cpu":
        return farm_serve_ref(t, s, offsets, w0, t0, cap)
    if t.device.type != "cuda":
        raise ValueError(f"farm_serve: unsupported device {t.device}")
    dev, n, n_members = t.device, t.shape[0], w0.shape[0]
    _lib.require(t, "t", torch.float64, dev, (n,))
    _lib.require(s, "s", torch.float64, dev, (n,))
    _lib.require(offsets, "offsets", torch.int32, dev, (n_members + 1,))
    for name, x in (("w0", w0), ("t0", t0), ("cap", cap)):
        _lib.require(x, name, torch.float64, dev, (n_members,))
    dep = torch.full((n,), math.inf, dtype=torch.float64, device=dev)
    drop = torch.zeros(n, dtype=torch.bool, device=dev)
    w, t_last, w_max = (torch.empty(n_members, dtype=torch.float64, device=dev)
                        for _ in range(3))
    if n_members == 0:
        return dep, drop, w, t_last, w_max
    err = _lib.lib().ejfat_farm_serve(
        t.data_ptr(), s.data_ptr(), offsets.data_ptr(), w0.data_ptr(), t0.data_ptr(),
        cap.data_ptr(), n_members, dep.data_ptr(), drop.data_ptr(), w.data_ptr(),
        t_last.data_ptr(), w_max.data_ptr(), _lib.stream_ptr(dev))
    _lib.check(err, "farm_serve")
    _lib.LAUNCHES["farm_serve"] += 1
    return dep, drop, w, t_last, w_max
