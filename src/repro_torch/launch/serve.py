"""Serving launcher: LB-front-door engine with batched synthetic requests.

The port of ``repro.launch.serve``: the same arguments and smoke config,
plus ``--device`` (default ``cuda``). It serves the dense, moe, hybrid and
ssm archs; the engine refuses the vlm and audio ones (as the reference's
fails on them).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--lane-bits", type=int, default=1)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(cfg, ServeConfig(n_replicas=args.replicas,
                                         lane_bits=args.lane_bits,
                                         max_len=256, device=str(dev)), params)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 16))),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    eng.run_until_done()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s on {dev})")
    print("per-replica routing:", dict(sorted(eng.stats["routed"].items())))
    return eng


if __name__ == "__main__":
    main()
