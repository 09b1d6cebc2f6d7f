"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 10th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, rope_theta=5e5,
    cross_attn_every=10, n_vision_tokens=1601,
)


def smoke_config():
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, cross_attn_every=2, n_vision_tokens=16, dtype="float32",
    )
