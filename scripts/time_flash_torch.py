#!/usr/bin/env python3
"""Time the port's ``flash_attention`` of one source tree on one CUDA card,
beside SDPA, at the prefill shapes the main paths give it.

    python scripts/time_flash_torch.py [--src SRC]

Shapes (B=1, T=4096, bf16, causal): Zamba2-2.7B's shared block and
StableLM-3B (32/32 heads, d=80), Yi-6B (32/4, d=128), Mixtral-8x22B (48/8,
d=128) and Llama-3.2-Vision (64/8, d=128). Each call is first checked
against the plain version (atol 5e-3, rtol 2e-2), then timed with
``chip_smoke.py``'s ``time_on_card`` (graphs of 20 calls behind an
L2-evicting read, median of 7), as is
``torch.nn.functional.scaled_dot_product_attention`` on the same inputs.
Also reports what ``-Xptxas -v`` said of each instance of the wgmma kernel
(registers, spills) and any C75xx warning (wgmma serialized) on it.

``--src`` (default: this checkout's ``src/``) may point at the ``src/`` of
another checkout, such as an unpacked parent commit: its kernels are built
and timed with the same inputs and code, so two trees compare in one call on
one card (run them in turns: parent, change, change, parent). Prints the
card line and one JSON object (ms per shape, the design that ran, the
ptxas lines).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: name -> (Hq, Hkv, d) at B=1, T=4096
SHAPES = {"zamba2_stablelm": (32, 32, 80), "yi_6b": (32, 4, 128),
          "mixtral_8x22b": (48, 8, 128), "llama_vision": (64, 8, 128)}
T = 4096


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    if not Path(_lib.__file__).resolve().is_relative_to(src):
        print(f"FAIL: repro_torch came from {_lib.__file__}, not {src}")
        return 1
    rng = np.random.default_rng(5)
    rows = {}
    for name, (hq, hkv, d) in SHAPES.items():
        mk = lambda h: torch.from_numpy(rng.standard_normal(
            (1, T, h, d), dtype=np.float32)).to("cuda", torch.bfloat16)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        before = _lib.LAUNCHES["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=True)
        design = "wgmma" if _lib.LAUNCHES["flash_attention_wgmma"] > before else "mma"
        want = flash_attention_ref(q, k, v, causal=True)
        cs.check(torch.allclose(got.float(), want.float(), atol=5e-3, rtol=2e-2),
                 f"{name}: flash_attention differs from plain")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, _ = cs.time_on_card(torch, lambda: flash_attention(q, k, v, causal=True))
        sdpa_ms, _ = cs.time_on_card(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        rows[name] = dict(ms=ms, sdpa_ms=sdpa_ms, design=design,
                          shape=f"B=1 T={T} {hq}/{hkv} heads d={d}")
        del q, k, v, qt, kt, vt, got, want
    log = (_lib.build().parent / "nvcc.log").read_text().splitlines()
    ptxas = {}
    for i, ln in enumerate(log):
        found = re.search(r"Function properties for \S*flash_wgmma_kernelILi(\d+)E", ln)
        if found:
            ptxas[f"d={found.group(1)}"] = "; ".join(
                x.replace("ptxas info    :", "").strip() for x in log[i + 1:i + 3])
    warnings = [ln.strip() for ln in log if "C75" in ln and "flash_wgmma" in ln]
    print(cs.card_line())
    print(json.dumps(dict(src=str(src), flash_attention=rows, ptxas=ptxas,
                          ptxas_warnings=warnings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
