"""Architecture registry of the port: ``--arch <id>`` selects one of these.

Each module defines CONFIG (the published config, as in the JAX package's
``repro.configs``) and smoke_config() (a reduced same-family config for the
CPU tests). The port runs every arch of the repo: the dense, moe, vlm,
audio, hybrid and ssm families.
"""
from __future__ import annotations

import importlib

#: the archs, in the JAX package's order (dense: GQA 4 and 2 KV heads, MQA,
#: MHA, fractional RoPE 0.25 and 0.5, head dims 80 and 128; moe: 8 experts
#: with a sliding window, 128 experts with a dense residual; vlm: a
#: cross-attention layer every 10th; audio: an encoder; hybrid: Mamba2 with
#: a shared attention block; ssm: RWKV6)
ARCH_IDS = [
    "llama_3_2_vision_90b",
    "arctic_480b",
    "mixtral_8x22b",
    "granite_20b",
    "stablelm_3b",
    "chatglm3_6b",
    "yi_6b",
    "hubert_xlarge",
    "zamba2_2_7b",
    "rwkv6_7b",
]


def _normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = _normalize(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
