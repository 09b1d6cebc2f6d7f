#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Drives the port's main path — the load balancer's closed loop — through the
entry points a user calls, builds every CUDA kernel of that path from the
sources in this checkout, and holds each kernel against its plain PyTorch
version at full width. Phases, one line (or more) each; any failure exits
non-zero and prints no result:

  1. card       nvidia-smi name + power limit, torch and CUDA versions
  2. build      nvcc of src/repro_torch/kernels/csrc into build/kernels/
  3. kernels    lb_route (4 stacked x 512-member instances and one
                instance), dispatch_plan and seg_masks at 2^20 packets,
                exactly equal to their plain versions; kernel time (CUDA
                graph replay, L2 evicted, CUDA events, median), plain time and
                the bytes bound at 3.35 TB/s
  4. loop       the closed loop at a small size on the card and on the CPU
                (summaries must be equal), then the full-width 25-step,
                64-member straggler loop with its invariants, and every
                kernel launched at least once per step
  5. result     the `kernels` JSON line, the card line, and the last line
                {"ok": true, "device": {...}}

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT_OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
N_FULL = 1 << 20               # packets per window at full width
MAX_MEMBERS = 512
LIVE_MEMBERS = 256
N_INST = 4
CORRUPT_EVERY = 61

REPLACES = {
    "lb_route": "src/repro/kernels/lb_route.py:188",
    "dispatch_plan": "src/repro/kernels/dispatch.py:63",
    "seg_masks": "src/repro/kernels/reassembly.py:76",
}
SOURCE = "src/repro_torch/kernels/csrc/ejfat_kernels.cu"


class SmokeFailure(RuntimeError):
    pass


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_on_card(torch, fn, reps=20, rounds=7):
    """Device time of one ``fn()`` call, in ms: ``reps`` calls captured in a
    CUDA graph, each behind a read of 128 MB that evicts the 50 MB L2 (so
    every call finds its inputs in device memory; a read leaves no dirty
    lines for the call to write back), minus the same graph with the
    evictions alone; median over ``rounds`` replays. The graph takes the
    host's launch cost out of the measurement. Fails when the difference
    is not above the spread of the eviction-only replays: the call's time
    is then lost in the noise and there is no measurement to report."""
    flush = torch.ones(32 << 20, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def capture(with_fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.sum()
                if with_fn:
                    fn()
        return g

    graphs = {True: capture(True), False: capture(False)}
    per = {True: [], False: []}
    for _ in range(rounds):
        for k, g in graphs.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            per[k].append(a.elapsed_time(b) / reps)
    ms = statistics.median(per[True]) - statistics.median(per[False])
    noise = max(per[False]) - min(per[False])
    check(ms > noise, f"call time {ms:.6f} ms is not above the eviction noise "
                      f"{noise:.6f} ms: not measured")
    return ms


def max_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (integers: 0 when equal)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at full width
# ---------------------------------------------------------------------------

def full_width_tables(np, rng):
    from repro_torch.core.instance import VirtualLoadBalancer
    from repro_torch.core.tables import MemberSpec

    vlb = VirtualLoadBalancer(max_members=MAX_MEMBERS)
    base, span = 1 << 40, 1 << 24
    for inst, em in enumerate(vlb.instances):
        members = {m: MemberSpec(node_id=m, base_lane=4 * m,
                                 lane_bits=int(rng.integers(0, 5)))
                   for m in range(LIVE_MEMBERS)}
        em.initialize(members, {m: float(rng.uniform(0.5, 2.0)) for m in members})
        for k in range(1, 4):  # three switches: four epochs per instance
            members = {m: MemberSpec(node_id=m, base_lane=4 * m, lane_bits=2)
                       for m in range(32 * k, 32 * k + LIVE_MEMBERS)}
            em.reconfigure(members, {m: float(rng.uniform(0.5, 2.0)) for m in members},
                           base + (k + inst) * span // 5)
    return vlb, base, span


def full_width_headers(np, rng, base, span):
    from repro_torch.core.protocol import encode_headers

    ev = (base + rng.integers(-span // 8, span + span // 8, N_FULL)).astype(np.uint64)
    ev[:64] = np.uint64(2**64 - 1) - np.arange(64, dtype=np.uint64)  # top of the space
    words = encode_headers(ev, rng.integers(0, 1 << 16, N_FULL).astype(np.uint32))
    bad = np.arange(0, N_FULL, CORRUPT_EVERY)
    words[bad[0::2], 0] ^= np.uint32(1 << 16)   # wrong magic
    words[bad[1::2], 0] ^= np.uint32(1 << 9)    # wrong version
    return words, len(bad)


def kernel_phase(torch, np):
    from repro_torch.core.dataplane import DataPlane
    from repro_torch.core.protocol import words_to_tensor
    from repro_torch.data.reassembly import _sort_perm, reassembly_plan
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import dispatch_plan
    from repro_torch.kernels.lb_route import lb_route
    from repro_torch.kernels.reassembly import seg_masks

    rng = np.random.default_rng(11)
    vlb, base, span = full_width_tables(np, rng)
    words, n_bad = full_width_headers(np, rng, base, span)
    hdr = words_to_tensor(words, "cuda")
    iid = torch.from_numpy(rng.integers(0, N_INST, N_FULL).astype(np.int32)).cuda()
    stacked = DataPlane.from_instances(vlb.instances, device="cuda").tables
    single = DataPlane.from_manager(vlb.instances[0], device="cuda").tables
    results = {}

    # -- lb_route -------------------------------------------------------------
    got = lb_route(hdr, stacked, iid)
    want = ref.lb_route_ref(hdr, stacked, iid)
    for name, g, w in zip(("member", "node", "lane", "valid"), got, want):
        check(torch.equal(g, w), f"lb_route (4 instances) {name} differs from plain")
    err = max_err(got, want)
    n_valid = int(got[3].sum())
    check(n_valid <= N_FULL - n_bad, "corrupt headers were routed")
    got1 = lb_route(hdr, single)
    want1 = ref.lb_route_ref(hdr, single)
    for name, g, w in zip(("member", "node", "lane", "valid"), got1, want1):
        check(torch.equal(g, w), f"lb_route (1 instance) {name} differs from plain")
    table_bytes = sum(t.numel() * t.element_size() for t in stacked.fields().values())
    t_k = time_on_card(torch, lambda: lb_route(hdr, stacked, iid))
    t_p = time_on_card(torch, lambda: ref.lb_route_ref(hdr, stacked, iid))
    t_k1 = time_on_card(torch, lambda: lb_route(hdr, single))
    b_ms, b_by = bound(N_FULL * (16 + 4 + 16) + table_bytes, N_FULL * 120)
    results["lb_route"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=err, shape=f"N=2^20, {N_INST}x{MAX_MEMBERS} stacked")
    say(f"[kernels] lb_route 4x{MAX_MEMBERS} stacked, N=2^20, {n_bad} corrupt, "
        f"{n_valid} routed: equal to plain; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); single instance kernel {t_k1:.4f} ms, equal")

    # -- dispatch_plan on the routed members --------------------------------------
    member = got[0]
    pos, counts = dispatch_plan(member, n_members=MAX_MEMBERS)
    pos_r, counts_r = ref.dispatch_plan_ref(member, n_members=MAX_MEMBERS)
    check(torch.equal(pos, pos_r), "dispatch_plan pos differs from plain")
    check(torch.equal(counts, counts_r), "dispatch_plan counts differ from plain")
    err = max_err((pos, counts), (pos_r, counts_r))
    check(int(counts.sum()) == n_valid, "dispatch_plan counts do not sum to routed")
    edge = torch.tensor([3, -1, 600, 3, 511, -5, 3, 512], dtype=torch.int32, device="cuda")
    ep, ec = dispatch_plan(edge, n_members=MAX_MEMBERS)
    epr, ecr = ref.dispatch_plan_ref(edge, n_members=MAX_MEMBERS)
    check(torch.equal(ep, epr) and torch.equal(ec, ecr), "dispatch_plan edge cases differ")
    t_k = time_on_card(torch, lambda: dispatch_plan(member, n_members=MAX_MEMBERS))
    t_p = time_on_card(torch, lambda: ref.dispatch_plan_ref(member, n_members=MAX_MEMBERS))
    b_ms, b_by = bound(N_FULL * 8 + MAX_MEMBERS * 4, N_FULL * 20)
    results["dispatch_plan"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=err, shape=f"N=2^20, n_members={MAX_MEMBERS}")
    say(f"[kernels] dispatch_plan N=2^20 n_members={MAX_MEMBERS}: equal to plain; "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # -- seg_masks on a key-sorted 2^20-row window -------------------------------
    pool = (base + rng.integers(0, span, 1 << 16)).astype(np.uint64)
    ev = pool[rng.integers(0, len(pool), N_FULL)]
    cols = np.stack([(ev >> np.uint64(32)).astype(np.int64),
                     (ev & np.uint64(0xFFFFFFFF)).astype(np.int64),
                     rng.integers(0, 16, N_FULL), rng.integers(0, 8, N_FULL),
                     rng.integers(1, 9, N_FULL)])
    t = torch.from_numpy(cols).cuda()
    valid = torch.ones(N_FULL, dtype=torch.bool, device="cuda")
    valid[-(N_FULL // 16):] = False  # a padded tail, as a pow2 window has
    perm = _sort_perm([(~valid).long(), t[0], t[1], t[2], t[3]])
    sv = valid[perm].int()
    s_hi, s_lo, s_daq, s_seg = (t[k][perm].int().contiguous() for k in range(4))
    ng, dup = seg_masks(sv, s_hi, s_lo, s_daq, s_seg)
    ng_r, dup_r = ref.seg_masks_ref(sv, s_hi, s_lo, s_daq, s_seg)
    check(torch.equal(ng, ng_r) and torch.equal(dup, dup_r), "seg_masks differs from plain")
    err = max_err((ng, dup), (ng_r, dup_r))
    plan_gpu = reassembly_plan(t[0], t[1], t[2], t[3], t[4], valid)
    plan_cpu = reassembly_plan(*(t[k].cpu() for k in range(5)), valid.cpu())
    for k in plan_gpu:
        check(torch.equal(plan_gpu[k].cpu(), plan_cpu[k]),
              f"reassembly_plan[{k}] on the card differs from the CPU")
    t_k = time_on_card(torch, lambda: seg_masks(sv, s_hi, s_lo, s_daq, s_seg))
    t_p = time_on_card(torch, lambda: ref.seg_masks_ref(sv, s_hi, s_lo, s_daq, s_seg))
    b_ms, b_by = bound(N_FULL * 28, N_FULL * 12)
    results["seg_masks"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=err, shape="N=2^20 sorted rows")
    say(f"[kernels] seg_masks N=2^20 ({int(ng.sum())} groups, {int(dup.sum())} dups): "
        f"equal to plain, reassembly_plan card == CPU; kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    say("[kernels] library call: none — no single PyTorch call computes lb_route, "
        "dispatch_plan or seg_masks")
    return results


# ---------------------------------------------------------------------------
# phase 4: the closed loop
# ---------------------------------------------------------------------------

SMALL_LOOP = ["--steps", "12", "--scenario", "straggler", "--n-members", "4",
              "--n-daqs", "2", "--mtu-payload", "2048", "--seed", "3"]


def loop_phase(torch):
    from repro_torch import closed_loop
    from repro_torch.kernels import _lib

    on_card = closed_loop.run(closed_loop.parse_args(SMALL_LOOP + ["--device", "cuda"]))
    on_cpu = closed_loop.run(closed_loop.parse_args(SMALL_LOOP + ["--device", "cpu"]))
    a = {k: v for k, v in on_card.summary.items() if k != "wall_s"}
    b = {k: v for k, v in on_cpu.summary.items() if k != "wall_s"}
    check(a == b, f"small closed loop differs card vs CPU:\n{a}\n{b}")
    say(f"[loop] small straggler loop (4 members, 12 steps): card == CPU plain path "
        f"({a['bundles_completed']} bundles completed)")

    args = closed_loop.parse_args(closed_loop.FULL_WIDTH + ["--steps", "25",
                                                            "--device", "cuda"])
    check(args.max_members == MAX_MEMBERS, "the loop's member table is not full width")
    _lib.reset_launches()
    res = closed_loop.run(args)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    s = res.summary
    check(not s["violations"], f"closed loop violations: {s['violations']}")
    check(s["split_events"] == 0 and s["corrupt_bundles"] == 0, "split or corrupt bundles")
    check(s["bundles_completed"] + s["bundles_pending"] + s["bundles_timed_out"]
          <= s["bundles_sent"], "bundles counted twice")
    check(s["bundles_completed"] > 0, "no bundle completed")
    check(float(s["final_weights"]["0"]) < 1.0, "straggler weight not shed")
    check(len(res.step_launches) == args.steps, "a step left no launch record")
    for step, per_step in enumerate(res.step_launches):
        for name, n in per_step.items():
            check(n >= 1, f"{name} not launched in step {step}: {per_step}")
    steps = res.step_s
    per_step_min = {k: min(st[k] for st in res.step_launches) for k in launches}
    line = dict(s, launches=launches, launches_per_step_min=per_step_min,
                packets_routed=res.packets_routed,
                packets_packed=res.packets_packed,
                step_s_median=statistics.median(steps), step_s_max=max(steps),
                phase_s={k: round(v, 4) for k, v in res.phase_s.items()})
    say("[loop] " + json.dumps(line, sort_keys=True))
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke needs a GPU", flush=True)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"FAIL: {SRC / 'repro_torch'} not found: run from a checkout of the repo",
              flush=True)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    try:
        card = card_line()
        say(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

        from repro_torch.kernels import _lib
        t0 = time.perf_counter()
        _lib.lib()
        say(f"[build] nvcc sm_90a -> {_lib.build().relative_to(ROOT)} in "
            f"{time.perf_counter() - t0:.2f} s")
        log = (_lib.build().parent / "nvcc.log").read_text().splitlines()
        for ln in log:
            if "registers" in ln or "Compiling entry" in ln:
                say("[build] " + ln.strip())

        results = kernel_phase(torch, np)
        launches = loop_phase(torch)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                    launches=launches[name], library_ms=None, **results[name])
               for name in ("lb_route", "dispatch_plan", "seg_masks")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
