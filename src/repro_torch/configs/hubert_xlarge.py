"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 — encoder-only; frame-embedding frontend is a STUB
(input_specs provides precomputed frame embeddings).
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, causal=False, act="gelu",
)


def smoke_config():
    return ModelConfig(
        name="hubert-smoke", family="audio",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=32, causal=False, act="gelu", dtype="float32",
    )
