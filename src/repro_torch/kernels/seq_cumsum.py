"""The downlink FIFO's running sum, added in row order: wrapper of the CUDA
kernel ``csrc/simnet_kernels.cu::seq_cumsum_kernel``. One block: a copy warp
streams tiles through a ring in shared memory (``cp.async`` in, coalesced
stores out) while one thread adds them in row order, each batch's values
loaded into registers before the previous batch's adds, so the adds run back
to back at the card's float64 add latency.

A device helper of the simulator, not the port of a Pallas kernel: the host
engine's FIFO takes ``np.cumsum`` (sequential), and a drop-tail decision
downstream can turn on the last bit of it, so the fused step needs that
association on the card, where ``torch.cumsum`` adds in a tree. float64
``[N]`` in, its inclusive running sum out. A CUDA input launches the kernel;
a CPU input takes ``ref.seq_cumsum_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import seq_cumsum_ref


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return seq_cumsum_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"seq_cumsum: unsupported device {x.device}")
    _lib.require(x, "x", torch.float64, x.device)
    out = torch.empty_like(x)
    err = _lib.lib().ejfat_seq_cumsum(x.data_ptr(), x.shape[0], out.data_ptr(),
                                      _lib.stream_ptr(x.device))
    _lib.check(err, "seq_cumsum")
    _lib.LAUNCHES["seq_cumsum"] += 1
    return out
