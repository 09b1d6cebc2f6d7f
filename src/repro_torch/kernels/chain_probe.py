"""The card's latency of the chains that bound ``farm_serve``,
``seq_cumsum`` and ``build_calendar``: wrapper of
``csrc/simnet_kernels.cu::chain_probe_kernel`` and ``swrr_probe_kernel``.

One thread runs ``n`` dependent ``__dadd_rn`` (the running sum's chain),
then ``n`` rows of the farm recursion in the reference's order
(``farm_row_straight``), then ``n`` rows as the kernel runs them
(``farm_row``, the kernel's own code), with every operand in a register.
Then one warp runs ``n`` smooth weighted round-robin steps as
``build_calendar`` runs them (``swrr_walk``, the kernel's own code: an
integer add, a lane-local max, a ``redux.sync`` max over the warp, a compare
and a subtract), with 1 key a lane (32 members, the kernel at M <= 32) and
with 16 (512 members). Each is timed with ``clock64`` and ``%globaltimer``.
A measurement of the card, not a kernel of the simulator's path: it has no
plain version and runs on a CUDA device only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

PROBE_LEN = 1 << 16


def chain_probe(n: int = PROBE_LEN, device="cuda") -> dict:
    """Cycles and ns per dependent float64 add (``add_*``), per farm row as
    the kernel runs it (``row_*``) and in the reference's order
    (``straight_row_*``), and per round-robin step at 1 and at 16 keys a
    lane (``rr_step_*``, ``rr16_step_*``); one call, synchronised. Raises
    when the two row orders did not end bit-equal or a round-robin key left
    its bound."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_probe measures a CUDA device, got {dev}")
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    sink = torch.zeros(3, dtype=torch.float64, device=dev)
    rr_sink = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.zeros(10, dtype=torch.int64, device=dev)
    err = _lib.lib().ejfat_chain_probe(1.0, 1e-9, n, sink.data_ptr(), out.data_ptr(),
                                       rr_sink.data_ptr(), _lib.stream_ptr(dev))
    _lib.check(err, "chain_probe")
    (add_c, add_ns, straight_c, straight_ns, row_c, row_ns,
     rr_c, rr_ns, rr16_c, rr16_ns) = out.tolist()
    if not bool(torch.isfinite(sink).all()):
        raise RuntimeError(f"chain_probe: the chains ended non-finite or the two row "
                           f"orders differ: {sink.tolist()}")
    if min(rr_sink.tolist()) < 0:
        raise RuntimeError("chain_probe: a round-robin key left its bound")
    return dict(n=n, add_cycles=add_c / n, add_ns=add_ns / n, row_cycles=row_c / n,
                row_ns=row_ns / n, straight_row_cycles=straight_c / n,
                straight_row_ns=straight_ns / n, rr_step_cycles=rr_c / n,
                rr_step_ns=rr_ns / n, rr16_step_cycles=rr16_c / n, rr16_step_ns=rr16_ns / n)
