"""Attention forward with an online softmax: wrapper of two hand-written CUDA
kernels, ``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``, in the JAX layout: q ``[B, T, Hq, d]``, k and v
``[B, T, Hkv, d]`` with ``Hq % Hkv == 0`` (query head h reads KV head
``h // (Hq // Hkv)``), scale ``1/sqrt(d)``, causal meaning key index <= query
index. Key positions past T are always masked, causal or not (where the
Pallas kernel lets its zero padding into a non-causal softmax). A CUDA input
launches a kernel (fp32 or bf16, d in ``HEAD_DIMS``); a CPU input takes
``ref.flash_attention_ref``, and so does a meta input (shapes and dtypes
only: the dry run's, nothing computes); any other device raises.

Two designs compute the same function, chosen by ``_design(dtype, d)``:
``"wgmma"`` (TMA ring, wgmma, warp-specialised; bf16 at d in
``WGMMA_HEAD_DIMS``, 64, 80 and 128, every attention head dim of the configs
the port serves) and ``"mma"`` (mma.sync, fp32 and bf16 at d 16 and 32).
The choice is by shape alone: a failed build or launch of either raises.

Forward only, as the Pallas kernel is: the kernel's output has no
``grad_fn``, so a call on inputs that require grad while autograd records
raises rather than cutting the graph (training attends through the plain
``models.layers.attention``, as the JAX package trains through its
``layers.attention``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import flash_attention_ref

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 80, 128)
#: head dims of the wgmma design (bf16 only)
WGMMA_HEAD_DIMS = (64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _design(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves (dtype, head dim): ``"wgmma"`` or ``"mma"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head -> ``[B, T, Hq, d]`` in q's dtype."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, T, Hq, d] and k, v [B, T, Hkv, d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, t, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B, T and d; Hq a multiple of Hkv)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention is forward only (no backward, as the Pallas "
                           "kernel): call it under torch.no_grad(), or attend through "
                           "models.layers.attention to train")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool):
    dev = q.device
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance; one of {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    design = _design(q.dtype, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        _lib.require(x, name, q.dtype, dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector and TMA loads)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, stream = _lib.lib(), _lib.stream_ptr(dev)
    if design == "wgmma":
        err = lib.ejfat_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, hq, hkv, d, int(bool(causal)), stream)
    else:
        err = lib.ejfat_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, hq, hkv, d, _DTYPE_CODE[q.dtype], int(bool(causal)), stream)
    _lib.check(err, f"flash_attention ({design})")
    _lib.LAUNCHES["flash_attention"] += 1
    if design == "wgmma":
        _lib.LAUNCHES["flash_attention_wgmma"] += 1
    return out
