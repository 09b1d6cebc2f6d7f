"""Architecture registry of the port: ``--arch <id>`` selects one of these.

Each module defines CONFIG (the published config, as in the JAX package's
``repro.configs``) and smoke_config() (a reduced same-family config for the
CPU tests). The port runs the dense and moe families; the other archs of
the repo raise ``NotImplementedError`` until their family is ported.
"""
from __future__ import annotations

import importlib

#: archs the port runs (dense family: GQA 4 and 2 KV heads, MQA, MHA,
#: fractional RoPE 0.25 and 0.5, head dims 80 and 128; moe family: 8 experts
#: with a sliding window, 128 experts with a dense residual)
ARCH_IDS = [
    "granite_20b",
    "stablelm_3b",
    "chatglm3_6b",
    "yi_6b",
    "mixtral_8x22b",
    "arctic_480b",
]

#: archs of the JAX package not ported yet, with the ROADMAP item that
#: brings each
_NOT_PORTED = {
    "llama_3_2_vision_90b": "vlm family",
    "hubert_xlarge": "audio family",
    "zamba2_2_7b": "hybrid family",
    "rwkv6_7b": "ssm family",
}


def _normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = _normalize(arch)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: the {_NOT_PORTED[name]} is not ported yet "
            "(ROADMAP.md queue 1, the item \"The other model families\")")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
