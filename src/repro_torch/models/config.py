"""Model configuration: the JAX package's ``ModelConfig``, field for field,
so a config built for one package describes the same model in the other
(``configs/`` holds all ten archs of the repo)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str          # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int         # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention variants
    rope_theta: float = 1e4
    rope_fraction: float = 1.0      # chatglm "2d rope" => 0.5
    swa_window: Optional[int] = None
    causal: bool = True             # False => encoder-only (hubert)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # >1: shard-local grouped dispatch (beyond-paper perf; DESIGN.md §Perf).
    moe_dispatch_groups: int = 1

    # VLM (modality frontend is a stub: precomputed patch embeddings)
    cross_attn_every: int = 0       # every k-th layer is a cross-attn layer
    n_vision_tokens: int = 0

    # hybrid / ssm
    block_kind: str = "attn"        # attn | mamba2 | rwkv6
    attn_every: int = 0             # zamba2: shared attn after every k mamba blocks
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4

    act: str = "swiglu"             # swiglu | gelu
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.family in ("dense", "moe", "vlm", "audio") and self.n_heads <= 0:
            raise ValueError(f"{self.name}: attention family needs heads")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")
        if self.cross_attn_every:
            if self.n_layers % self.cross_attn_every:
                raise ValueError(f"{self.name}: n_layers must divide into cross-attn groups")
        if self.attn_every and self.n_layers % self.attn_every:
            raise ValueError(f"{self.name}: n_layers must divide into attn_every groups")

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.ssm_head_dim

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS = 6 N D) ---------------
    def param_count(self) -> tuple[int, int]:
        """Returns (total_params, active_params) — active differs for MoE."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

        def ffn_params(width):
            n_mats = 3 if self.act == "swiglu" else 2
            return n_mats * d * width

        total = active = 0
        if self.family in ("dense", "audio"):
            per = attn + ffn_params(ff) + 2 * d
            total = active = self.n_layers * per
        elif self.family == "vlm":
            n_cross = self.n_layers // self.cross_attn_every
            n_self = self.n_layers - n_cross
            per_self = attn + ffn_params(ff) + 2 * d
            per_cross = attn + ffn_params(ff) + 3 * d  # extra kv-src norm
            total = active = n_self * per_self + n_cross * per_cross
        elif self.family == "moe":
            router = d * self.n_experts
            experts = self.n_experts * ffn_params(ff)
            act_experts = self.top_k * ffn_params(ff)
            dense = ffn_params(ff) if self.moe_dense_residual else 0
            per_total = attn + router + experts + dense + 2 * d
            per_active = attn + router + act_experts + dense + 2 * d
            total = self.n_layers * per_total
            active = self.n_layers * per_active
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            mamba = (
                d * (2 * di + 2 * N + H)      # in projections (z, x, B, C, dt)
                + self.conv_kernel * (di + 2 * N)
                + 2 * H                        # A_log, D
                + di * d                       # out proj
                + 2 * d
            )
            n_attn_apps = self.n_layers // self.attn_every if self.attn_every else 0
            shared_attn = attn + ffn_params(ff) + 2 * d if n_attn_apps else 0
            total = active = self.n_layers * mamba + shared_attn
        elif self.family == "ssm":  # rwkv6
            H = self.rwkv_heads
            tmix = 4 * d * d + d * d  # r,k,v,g + out
            decay = d * 64 * 2 + d    # lora for data-dependent decay + w0
            cmix = 2 * d * ff // 2 if False else d * ff + ff * d  # k', v' projections
            per = tmix + decay + cmix + 2 * d + 2 * d  # + token-shift mixes
            total = active = self.n_layers * per
        emb = v * d * 2  # in + out embeddings (untied)
        return total + emb, active + emb
