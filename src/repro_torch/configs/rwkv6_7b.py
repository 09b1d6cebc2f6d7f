"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=14336,
    vocab=65536, ssm_head_dim=64,
)


def smoke_config():
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=0, n_kv_heads=0, d_ff=128,
        vocab=256, ssm_head_dim=16, dtype="float32",
    )
