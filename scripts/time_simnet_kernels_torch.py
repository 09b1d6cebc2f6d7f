#!/usr/bin/env python3
"""Time the simulator's two ring kernels, ``farm_serve`` and ``seq_cumsum``,
of one source tree on one CUDA card, each held exactly equal to its plain
version.

    python scripts/time_simnet_kernels_torch.py [--src SRC] [--reps N]
        [--fused-windows W]

Times, in ms, with ``chip_smoke.py``'s timing code and inputs (a full-width
window of 16,384 rows; graphs of 200 calls, inputs in L2, as the fused step
leaves them; ``--reps`` timings each, all printed): ``farm_serve`` over 16
and 64 members, ``seq_cumsum``, and ``torch.cumsum`` on the same values as
the library yardstick. Where the tree has the chain probe
(``repro_torch.kernels.chain_probe``), also its ns per dependent float64 add
and per farm row, and each kernel's time over its chain bound. Then, unless
``--fused-windows 0``, the fused engine at ``chip_smoke.py``'s full-width
straggler traffic (16 members, K = 8) for W windows, twice (the first run
captures the program, the second reuses it): the second run's replay
median (CUDA events around each graph replay, ms per 8 windows) and its
windows/s on the host clock.

``--src`` (default: this checkout's ``src/``) may point at the ``src/`` of
another checkout, such as an unpacked parent commit: its kernels are built
and timed with the same inputs and code, so two trees compare in one call on
one card (run them in turns: parent, change, change, parent). Prints the
card line and one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fused-windows", type=int, default=48)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.farm_serve import farm_serve
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    if not Path(ref.__file__).resolve().is_relative_to(src):
        print(f"FAIL: repro_torch came from {ref.__file__}, not {src}")
        return 1
    rng = np.random.default_rng(15)
    out = {"src": str(src)}
    times = {}
    for m in (cs.SIMNET_FUSED_MEMBERS, cs.SIMNET_HOST_MEMBERS):
        fargs, counts = cs.farm_inputs(torch, np, rng, m)
        want = ref.farm_serve_ref(*fargs)
        name = f"farm_serve_{m}_members"
        times[name] = []
        for _ in range(args.reps):
            ms, last = cs.time_warm(torch, lambda: farm_serve(*fargs))
            cs.check_equal(torch, name, last, want)
            times[name].append(ms)
        out[f"{name}_longest_rows"] = int(counts.max())
    x = cs.scan_input(torch, np, rng)
    want = ref.seq_cumsum_ref(x)
    times["seq_cumsum"], times["torch.cumsum"] = [], []
    for _ in range(args.reps):
        ms, last = cs.time_warm(torch, lambda: seq_cumsum(x))
        cs.check_equal(torch, "seq_cumsum", (last,), (want,))
        times["seq_cumsum"].append(ms)
        times["torch.cumsum"].append(cs.time_warm(torch, lambda: torch.cumsum(x, 0))[0])
    out["ms"] = times
    out["ms_median"] = {k: statistics.median(v) for k, v in times.items()}
    if importlib.util.find_spec("repro_torch.kernels.chain_probe") is not None:
        chains = cs.measured_chains()
        med = out["ms_median"]
        out["chain_probe"] = chains
        out["over_chain_bound"] = {
            f"farm_serve_{m}_members": med[f"farm_serve_{m}_members"]
            / (out[f"farm_serve_{m}_members_longest_rows"] * chains["row_ns"] * 1e-6)
            for m in (cs.SIMNET_FUSED_MEMBERS, cs.SIMNET_HOST_MEMBERS)}
        out["over_chain_bound"]["seq_cumsum"] = med["seq_cumsum"] / (
            cs.SIMNET_KERNEL_ROWS * chains["add_ns"] * 1e-6)
    if args.fused_windows:
        out["fused"] = fused_replays(torch, cs, args.fused_windows)
    print(cs.card_line())
    print(json.dumps(out, sort_keys=True))
    return 0


def fused_replays(torch, cs, windows) -> dict:
    """The fused engine twice at one shape; the second run's replay median
    and windows/s."""
    import time

    from repro_torch.simnet import Simulator, fused

    for _ in range(2):
        cfg, scn = cs.simnet_config(cs.SIMNET_FUSED_MEMBERS, windows, "fused", "cuda")
        eng = fused.FusedEngine(Simulator(cfg, scn), superblock=cs.SIMNET_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if report.engine != "fused":
        raise RuntimeError(f"the fused config ran the {report.engine} engine")
    return dict(windows=windows, replays=len(eng.replay_ms),
                replay_ms_median=statistics.median(eng.replay_ms),
                windows_per_s=windows / wall, bundles_completed=report.bundles_completed)


if __name__ == "__main__":
    sys.exit(main())
