"""Assigned input shapes x architectures: the 40-cell grid.

Port of the JAX package's ``repro/launch/shapes.py``. Every cell is
(arch x shape); its inputs are tensors on ``device="meta"`` (shape and
dtype, no storage) where the reference has ``ShapeDtypeStruct`` stand-ins.
Skips are documented inapplicabilities: long_500k needs sub-quadratic
attention; encoder-only archs have no decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# sub-quadratic decode support per family/config
def _supports_long(cfg: ModelConfig) -> bool:
    if cfg.family in ("hybrid", "ssm"):
        return True
    if cfg.swa_window is not None:  # SWA ring cache is O(window)
        return True
    return False


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    s = SHAPES[shape]
    if cfg.encoder_only and s.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and not _supports_long(cfg):
        return "pure full-attention arch: quadratic attention inapplicable at 500k"
    return None


def runnable_cells(cfg: ModelConfig) -> list[str]:
    return [k for k in SHAPES if skip_reason(cfg, k) is None]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta tensors for the model inputs of this cell. Header words are
    ``int32`` (the u32 words' bits, as the port carries them:
    ``core/protocol.py``)."""
    s = SHAPES[shape]
    b, t = s.global_batch, s.seq_len
    dtype = getattr(torch, cfg.dtype)
    if s.kind == "decode":  # one new token against a seq_len-deep cache
        return {"tokens": _meta((b,), torch.int32)}
    out = {}
    if s.kind == "train":
        out["labels"] = _meta((b, t), torch.int32)
        out["headers"] = _meta((b, 4), torch.int32)
    if cfg.family == "audio":
        out["embeds"] = _meta((b, t, cfg.d_model), dtype)
    else:
        out["tokens"] = _meta((b, t), torch.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((b, cfg.n_vision_tokens, cfg.d_model), dtype)
    return out


def decode_state_specs(cfg: ModelConfig, shape: str) -> dict:
    """The decode cache of this cell on the meta device (with ``vision``
    for the vlm family: present after the prefill)."""
    from repro_torch.models import model as M

    s = SHAPES[shape]
    state = M.init_decode_state(cfg, s.global_batch, s.seq_len, device=META)
    if cfg.family == "vlm":
        state["vision"] = _meta((s.global_batch, cfg.n_vision_tokens, cfg.d_model),
                                getattr(torch, cfg.dtype))
    return state
