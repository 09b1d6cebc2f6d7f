"""Analytic per-device FLOP and HBM-byte model per (arch x shape) cell.

Port of the JAX package's ``repro/analysis/perfmodel.py``, formula for
formula and in the same order of arithmetic, so the two give equal floats.
It counts the work a step needs, whatever implements it (PaLM appendix-B
style MFU accounting), itemized:

  fwd flops  = 2 * N_active_local * tokens_local + attention/ssm mixer terms
  train      = 4x fwd (bwd = 2x, +1 fwd remat)   [remat=full per layer]
  bytes      = params traffic + moments + saved residuals + mixer working set
               + logits + (decode) cache read

Everything is per device per step, assuming bf16 weights/activations and
fp32 (or int8, for 8-bit Adam) moments. Accuracy target is the bottleneck
decision, not 3 digits; each item is listed in the artifact for inspection.
``analysis/roofline.py`` turns the totals into times on a chip.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import shapes as SH
from repro_torch.models.config import ModelConfig

WB = 2       # bf16 weight/activation bytes
F32B = 4


@dataclasses.dataclass
class PerfEstimate:
    flops: float                 # per device per step
    bytes_hbm: float             # per device per step
    items: dict

    def to_json(self):
        return {"flops": self.flops, "bytes_hbm": self.bytes_hbm,
                "items": self.items}


def _mixer_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Attention-score/value (or SSM) flops per token, full model (all
    layers), excluding the projections (those are in 6N)."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        w = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        eff = w if cfg.swa_window else ctx / 2 if cfg.causal else ctx
        per_layer = 2 * 2 * eff * cfg.n_heads * cfg.hd  # qk^T + pv
        layers = cfg.n_layers
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            layers = cfg.n_layers - n_cross
            per_layer_cross = 2 * 2 * cfg.n_vision_tokens * cfg.n_heads * cfg.hd
            return layers * per_layer + n_cross * per_layer_cross
        return layers * per_layer
    if cfg.family == "hybrid":
        # mamba2 SSD, chunk L=128: intra (L*(N + P)) + state (2*N*P) per head
        L, N, P, H = 128, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
        mamba = 2 * H * (L * (N + P) + 2 * N * P)
        n_attn = cfg.n_layers // cfg.attn_every
        attn = n_attn * 2 * 2 * (ctx / 2) * cfg.n_heads * cfg.hd / cfg.n_layers
        return cfg.n_layers * (mamba + attn)
    if cfg.family == "ssm":
        P, H = cfg.ssm_head_dim, cfg.rwkv_heads
        return cfg.n_layers * 5 * H * P * P  # wkv state read+update
    return 0.0


def _decode_mixer_flops(cfg: ModelConfig, ctx: int) -> float:
    """Per new token: attention against the cache / state update."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        w = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        return cfg.n_layers * 2 * 2 * w * cfg.n_heads * cfg.hd
    if cfg.family == "hybrid":
        N, P, H = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
        mamba = 2 * H * 2 * N * P
        n_attn = cfg.n_layers // cfg.attn_every
        attn = n_attn * 2 * 2 * ctx * cfg.n_heads * cfg.hd / cfg.n_layers
        return cfg.n_layers * (mamba + attn)
    if cfg.family == "ssm":
        P, H = cfg.ssm_head_dim, cfg.rwkv_heads
        return cfg.n_layers * 5 * H * P * P
    return 0.0


def _cache_bytes(cfg: ModelConfig, batch: int, ctx: int) -> float:
    if cfg.family in ("dense", "moe"):
        size = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        return batch * size * cfg.n_kv_heads * cfg.hd * 2 * WB * cfg.n_layers
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return batch * ctx * cfg.n_kv_heads * cfg.hd * 2 * WB * (cfg.n_layers - g)
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        kv = batch * ctx * cfg.n_kv_heads * cfg.hd * 2 * WB * n_attn
        ssm = batch * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * F32B * cfg.n_layers
        return kv + ssm
    if cfg.family == "ssm":
        return batch * cfg.rwkv_heads * cfg.ssm_head_dim ** 2 * F32B * cfg.n_layers
    return 0.0


def estimate(cfg: ModelConfig, shape: str | SH.ShapeSpec, chips: int, dp: int, tp: int,
             *, eight_bit_opt: bool = False) -> PerfEstimate:
    """Per device per step; ``shape`` is a name of ``SHAPES`` or any
    ``ShapeSpec`` (a path's own batch, length and kind)."""
    s = SH.SHAPES[shape] if isinstance(shape, str) else shape
    n_total, n_active = cfg.param_count()
    b, t = s.global_batch, s.seq_len
    tokens = b * t if s.kind != "decode" else b
    tokens_loc = tokens / dp
    p_loc = n_total / chips  # fully sharded (TP x FSDP)
    d = cfg.d_model

    items = {}
    if s.kind == "train":
        fwd = 2 * n_active / chips * tokens + tokens_loc * \
            _mixer_flops_per_token(cfg, t) / tp
        flops = 4.0 * fwd  # bwd 2x + remat refwd 1x
        items["fwd_flops"] = fwd
        # params: read fwd + read remat + read bwd + write; moments r/w
        opt_b = 1 if eight_bit_opt else F32B
        params_traffic = p_loc * WB * 4 + p_loc * F32B  # + f32 grad write
        moments = 2 * 2 * p_loc * opt_b
        resid = cfg.n_layers * (b / dp) * t * d * WB * 3  # save+read+rewrite
        logits = (b / dp) * t * (cfg.vocab / tp) * F32B * 2
        mixer = 4 * (b / dp) * t * d * WB * cfg.n_layers  # qkv/ffn act traffic
        bytes_hbm = params_traffic + moments + resid + logits + mixer
        items.update(params_traffic=params_traffic, moments=moments,
                     residuals=resid, logits=logits, mixer_act=mixer)
    elif s.kind == "prefill":
        fwd = 2 * n_active / chips * tokens + tokens_loc * \
            _mixer_flops_per_token(cfg, t) / tp
        flops = fwd
        cache_w = _cache_bytes(cfg, b, t) / chips
        resid = cfg.n_layers * (b / dp) * t * d * WB * 2
        bytes_hbm = p_loc * WB + cache_w + resid
        items.update(fwd_flops=fwd, params_read=p_loc * WB, cache_write=cache_w,
                     residuals=resid)
    else:  # decode
        fwd = 2 * n_active / chips * b + (b / dp) * _decode_mixer_flops(cfg, t) / tp
        flops = fwd
        cache_r = _cache_bytes(cfg, b, t) / chips
        bytes_hbm = p_loc * WB + cache_r
        items.update(fwd_flops=fwd, params_read=p_loc * WB, cache_read=cache_r)
    items["params_local_bytes"] = p_loc * WB
    return PerfEstimate(flops=flops, bytes_hbm=bytes_hbm, items=items)
