"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
)


def smoke_config():
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=256, dtype="float32",
    )
