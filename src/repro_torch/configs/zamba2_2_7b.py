"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention block applied
after every 6 mamba blocks (one shared param set). [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, attn_every=6, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    head_dim=80,
)


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, attn_every=2, ssm_state=8, ssm_expand=2, ssm_head_dim=16,
        head_dim=16, dtype="float32",
    )
