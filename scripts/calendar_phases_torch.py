#!/usr/bin/env python3
"""Where one call of the port's ``build_calendar`` kernel spends its time, by
phase, on one CUDA card.

    python scripts/calendar_phases_torch.py [--calls N]

Compiles an instrumented copy of ``csrc/simnet_kernels.cu`` into
``build/phases/`` (git-ignored) in which thread 0 reads ``clock64`` at each
phase boundary of ``build_calendar_kernel``: after the do_sw test, after
the weights' sum, after the ideal counts, after their block sum, after the
surplus or deficit, after the round-robin, and after the quota check (before
the calendar's store). Then
calls that copy ``--calls`` times on each case (16 members in tied
triples, as ``chip_smoke.py`` times it; 32, 256 and 512 random members;
512 members with one dominant weight, the long surplus loop), 512 slots,
checks each result against the plain version, and prints one JSON line per
case with the median cycles of each phase, then the card line. The copy is
built with the kernels' own flags; only the clock reads differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
OUT = ROOT / "build" / "phases"
PHASES = ("sum", "ideal", "count_sum", "surplus_or_deficit", "round_robin", "quota_check")
STAMP = "if (threadIdx.x == 0) g_stamps[{}] = clock64();\n"
# anchors in the kernel source, each occurring once; a stamp goes before each
ANCHORS = (
    "  __shared__ double w_s[kMaxCalMembers];",
    "  // -- largest-remainder quotas",
    "  const int warp_sum = __reduce_add_sync(kFull, cnt);",
    "  if (sum > n_slots) {  // surplus",
    "  // -- smooth weighted round-robin, one warp",
    "  // -- the quota check, one thread per slot",
    "  if (slot) out[tid] = c;",
)


def build() -> Path:
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _lib

    text = (SRC / "repro_torch/kernels/csrc/simnet_kernels.cu").read_text()
    text = text.replace("namespace {\n", "namespace {\n__device__ long long g_stamps[8];\n", 1)
    for k, anchor in enumerate(ANCHORS):
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {anchor!r}")
        indent = anchor[: len(anchor) - len(anchor.lstrip())]
        text = text.replace(anchor, indent + STAMP.format(k) + anchor)
    text += ('\nextern "C" int read_stamps(long long* h) {\n'
             '  return static_cast<int>(cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps)));\n}\n')
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "simnet_kernels_phases.cu").write_text(text)
    so = OUT / "libcalendar_phases.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(OUT / "simnet_kernels_phases.cu")], check=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=15)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ejfat_build_calendar.argtypes = [p, i, p, i, p, p]
    lib.read_stamps.argtypes = [p]
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref

    rng = np.random.default_rng(15)
    cases = {"16 members, tied triples": np.repeat(rng.uniform(0.3, 2.0, 6), 3)[:16],
             "32 members, random": rng.uniform(0.05, 8.0, 32),
             "256 members, random": rng.uniform(0.05, 8.0, 256),
             "512 members, random": rng.uniform(0.05, 8.0, 512),
             "512 members, one dominant": np.r_[40.0 * 512, np.full(511, 0.05)]}
    flag = torch.tensor([True], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, w_np in cases.items():
        w = torch.from_numpy(w_np).cuda()
        out = torch.full((512,), -1, dtype=torch.int32, device="cuda")
        rows = []
        for _ in range(args.calls):
            err = lib.ejfat_build_calendar(w.data_ptr(), len(w_np), flag.data_ptr(), 512,
                                           out.data_ptr(), stream)
            torch.cuda.synchronize()
            stamps = (ctypes.c_longlong * 8)()
            if err or lib.read_stamps(ctypes.addressof(stamps)):
                raise RuntimeError(f"{name}: CUDA error")
            rows.append([stamps[k + 1] - stamps[k] for k in range(len(PHASES))])
        cs.check_equal(torch, f"instrumented build_calendar, {name}", (out,),
                       (ref.build_calendar_ref(w, flag, torch.full_like(out, -1)),))
        med = {ph: statistics.median(r[k] for r in rows) for k, ph in enumerate(PHASES)}
        print(json.dumps(dict(case=name, cycles=med, total_cycles=sum(med.values()))))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
