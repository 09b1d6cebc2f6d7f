#!/usr/bin/env python3
"""Where one call of the port's ``dispatch_plan`` kernel spends its time, by
phase and tile, on one CUDA card.

    python scripts/dispatch_plan_phases_torch.py [--window N]

Copies ``src/repro_torch`` into ``build/phases/`` (git-ignored) with the
kernel's thread 0 of every block reading ``%globaltimer`` at each phase
boundary of ``csrc/ejfat_kernels.cu::dispatch_plan_kernel`` into a tail of
the scratch buffer: entry, tile id drawn, histogram done, aggregate
published and the group's earlier tiles summed, ballots done, look-back
done, ranks stored. Then calls that copy
once at 2^20 packets (L2 evicted first) and once at ``--window`` packets
(the closed loop's median window), each on ``chip_smoke.py``'s routed
members over 512 member slots, checks the result against the plain version,
and prints, per boundary, the 0/50/90/100th percentiles over tiles of the
time since the earliest block's entry, and of each phase's length, in us.
The timer ticks in steps of ~0.26 us on the H100. The copy is built and run
with the same code as the kernel of ``src/``; only the timer reads differ.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "phases" / "src"
PHASES = ("entry", "tile_id", "histogram", "in_group", "ballots", "look_back", "ranks")

# (anchor in the kernel source, text put in its place); each anchor occurs once
PATCHES = (
    ("  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(tile_counter, 1u));",
     "  const uint64_t t_entry = global_ns();\n"
     "  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(tile_counter, 1u));"),
    ("  const int tile = tile_s;\n",
     "  const int tile = tile_s;\n"
     "  unsigned long long* stamp = tile_words + (static_cast<long long>(n_tiles) +"
     " (n_tiles + kDpGroup - 1) / kDpGroup) * n_members + tile * 8;\n"
     "  if (threadIdx.x == 0) { stamp[0] = t_entry; stamp[1] = global_ns(); }\n"),
    ("    if (in_chunk(raw[c])) atomicAdd(&run[raw[c] - m0], 1);\n"
     "  __syncthreads();\n",
     "    if (in_chunk(raw[c])) atomicAdd(&run[raw[c] - m0], 1);\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) stamp[2] = global_ns();\n"),
    ("  // The lanes of each chunk holding the same member",
     "  if (threadIdx.x == 0) stamp[3] = global_ns();\n"
     "  // The lanes of each chunk holding the same member"),
    ("  // 3b. The group's exclusive prefix",
     "  if (threadIdx.x == 0) stamp[4] = global_ns();\n  // 3b. The group's exclusive prefix"),
    ("  // 4. Ranks, in packet order",
     "  if (threadIdx.x == 0) stamp[5] = global_ns();\n  // 4. Ranks, in packet order"),
    ("    if (i < n && mine) pos[i] = p;\n  }\n}",
     "    if (i < n && mine) pos[i] = p;\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) stamp[6] = global_ns();\n}"),
    # (one chunk of members: the stamps follow its words)
    ("(1 + (dp_tiles(n) + dp_groups(dp_tiles(n))) * dp_chunk_members(n_members));",
     "(1 + (dp_tiles(n) + dp_groups(dp_tiles(n))) * dp_chunk_members(n_members))"
     " + dp_tiles(n) * 8;"),
)


def instrumented_copy() -> None:
    if COPY.parent.exists():
        shutil.rmtree(COPY.parent)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "repro_torch" / "kernels" / "csrc" / "ejfat_kernels.cu"
    text = cu.read_text()
    for anchor, repl in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {cu.name}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    cu.write_text(text)
    wrapper = COPY / "repro_torch" / "kernels" / "dispatch.py"
    anchor = "    err = lib.ejfat_dispatch_plan("
    w = wrapper.read_text()
    if w.count(anchor) != 1:
        raise RuntimeError("dispatch.py: launch not found")
    wrapper.write_text(w.replace(anchor, "    global LAST_SCRATCH\n    LAST_SCRATCH = scratch\n"
                                 + anchor))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--window", type=int, default=15657)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    instrumented_copy()
    sys.path.insert(0, str(COPY))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.dataplane import DataPlane
    from repro_torch.core.protocol import words_to_tensor
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.lb_route import lb_route

    rng = np.random.default_rng(11)
    vlb, base, span = cs.full_width_tables(np, rng)
    words, _ = cs.full_width_headers(np, rng, base, span)
    iid = torch.from_numpy(rng.integers(0, cs.N_INST, cs.N_FULL).astype(np.int32)).cuda()
    stacked = DataPlane.from_instances(vlb.instances, device="cuda").tables
    member = lb_route(words_to_tensor(words, "cuda"), stacked, iid)[0]
    flush = torch.ones(32 << 20, dtype=torch.int32, device="cuda")
    print(cs.card_line())
    for n in (cs.N_FULL, args.window):
        m = member[:n].contiguous()
        for _ in range(3):  # the last call is the one read
            flush.sum()
            torch.cuda.synchronize()
            pos, counts = dispatch.dispatch_plan(m, n_members=cs.MAX_MEMBERS)
            torch.cuda.synchronize()
        want = ref.dispatch_plan_ref(m, n_members=cs.MAX_MEMBERS)
        cs.check_equal(torch, f"instrumented dispatch_plan N={n}", (pos, counts), want)
        n_tiles = -(-n // 4096)
        t = dispatch.LAST_SCRATCH[-n_tiles * 8:].view(n_tiles, 8)[:, :len(PHASES)]
        t = t.cpu().numpy().astype(np.float64)
        rel = (t - t[:, 0].min()) / 1e3
        pct = lambda x: [round(float(np.percentile(x, q)), 3) for q in (0, 50, 90, 100)]
        line = dict(n=n, tiles=n_tiles,
                    at_us={p: pct(rel[:, k]) for k, p in enumerate(PHASES)},
                    phase_us={PHASES[k + 1]: pct(rel[:, k + 1] - rel[:, k])
                              for k in range(len(PHASES) - 1)})
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
