"""Where the time goes in the port's closed loop: host phases and device busy
share, from one ``torch.profiler`` trace of the full-width straggler loop.

Runs ``repro_torch.closed_loop`` on the card at ``closed_loop.FULL_WIDTH``,
the size ``chip_smoke.py`` uses (64 members, 16 DAQs, 128 triggers/step,
64 kB bundles, MTU payload 8948, 512 member slots), under the profiler, after
two untraced warm-up steps, and prints one JSON line: the card's name and
power limit (``nvidia-smi``), wall seconds, host seconds per phase, the
device's busy time (the sum of kernel and copy intervals on the card, one
stream, so they do not overlap) and idle share, and the ten device ops that
take the most time (names cut to 80 characters).

    PYTHONPATH=src python scripts/profile_closed_loop_torch.py [--steps 10]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import closed_loop


def loop_args(steps: int):
    return closed_loop.parse_args(closed_loop.FULL_WIDTH + ["--steps", str(steps)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    closed_loop.run(loop_args(2))  # build + warm up
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = closed_loop.run(loop_args(args.steps))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_us = 0.0
    by_name: dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            by_name[e.name[:80]] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {
        "device": card,
        "steps": args.steps, "wall_s": wall,
        "phase_s": res.phase_s, "step_s_median": sorted(res.step_s)[len(res.step_s) // 2],
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "top_device_ops_s": {k: v / 1e6 for k, v in top},
        "violations": res.summary["violations"],
    }
    print(json.dumps(out))
    return 1 if res.summary["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
