#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Drives the port's two main paths — the load balancer's closed loop, and
LB-front-door serving of Yi-6B — through the entry points a user calls,
builds every CUDA kernel of those paths from the sources in this checkout,
and holds each kernel against its plain PyTorch version at full width.
Phases, one line (or more) each; any failure exits non-zero and prints no
result:

  1. card       nvidia-smi name + power limit, torch and CUDA versions
  2. build      nvcc of src/repro_torch/kernels/csrc into build/kernels/
  3. kernels    lb_route (4 stacked x 512-member instances and one
                instance), dispatch_plan and seg_masks at 2^20 packets,
                exactly equal to their plain versions, and again after the
                timing's graph replays (a flag or counter a kernel fails to
                reset between calls shows there); flash_attention at the
                Yi-6B prefill shape (T=4096, 32/4 heads, d=128, bf16,
                causal), at T=3000 causal and not, at B=2 with T=1000 causal
                and not (a tensor map not bounded per batch would read the
                next batch's rows), with Granite-20B's 48/1 heads at T=3000,
                and at T=65 and T=100 non-causal (a ragged last tile, where a
                kernel that lets padded keys into the softmax must fail),
                within atol 5e-3, rtol 2e-2 of its plain version; in fp32
                within 1e-4. Each check names the design that ran it: wgmma
                (csrc/flash_attention_wgmma.cu, bf16 at d = 64 or 128) or
                mma (csrc/flash_attention.cu, the rest). Kernel time (CUDA
                graph replay, L2 evicted, CUDA events, median), plain time,
                the library call's time where one exists (SDPA for
                flash_attention) and the bound (bytes at 3.35 TB/s, or
                operations at the type's peak)
  4. loop       the closed loop at a small size on the card and on the CPU
                (summaries must be equal), then the full-width 25-step,
                64-member straggler loop with its invariants, and every
                kernel launched at least once per step; then lb_route and
                dispatch_plan at that loop's median window and lb_route at a
                serving tick, inputs in L2 (graphs of 200 calls), each equal
                to plain after the replays
  5. serve      the Yi-6B smoke config served on the card and on the CPU
                (routing, tokens and stats must be equal), then Yi-6B at
                full depth and width (bf16, random weights): 2 replicas x 4
                decode slots, 4096-token caches, 12 requests of 256-4000
                prompt tokens, a drain of replica 1 (arrivals moved past
                the events a rebalance already committed), 4 more
                requests; every prefill launches flash_attention once per
                layer, every one of those launches through the wgmma
                design, every routing tick launches lb_route; then the
                kernel's share of the longest prefill (CUDA events) and the
                device's busy share of decode steps (torch.profiler)
  6. simnet     the virtual-time simulator (repro_torch.simnet): the
                hook-free, non-controld scenarios at their small presets,
                host engine on the card == on the CPU (whole report);
                farm_serve, seq_cumsum and build_calendar exactly equal to
                their plain versions at full width; then the full-width straggler
                traffic (16 DAQs, 128 triggers of 64 kB bundles per window,
                ~16k jumbo frames, 1.024 GB/s offered, the farm at ~0.7 of
                capacity): the fused engine at 16 members, 96 windows, K=8
                (one capture, 12 replays, lb_route / farm_serve /
                seq_cumsum / build_calendar in every window) against the
                host engine on
                the card (counters exact, latencies rel 1e-9), the same
                config fused on the CPU at 8 windows against the host
                engine, and the host engine at 64 members for 12 windows
  7. result     the `kernels` JSON line, the card line, and the last line
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
FP64_OPS_PER_S = 34e12         # H100 SXM float64 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
N_FULL = 1 << 20               # packets per window at full width
MAX_MEMBERS = 512
LIVE_MEMBERS = 256
N_INST = 4
CORRUPT_EVERY = 61

REPLACES = {
    "lb_route": "src/repro/kernels/lb_route.py:188",
    "dispatch_plan": "src/repro/kernels/dispatch.py:63",
    "seg_masks": "src/repro/kernels/reassembly.py:76",
    "flash_attention": "src/repro/kernels/flash_attention.py:85",
    # the simulator's device helpers replace lax.scan loops, not Pallas kernels
    "farm_serve": "src/repro/simnet/queues.py:99 (_serve_jnp)",
    "seq_cumsum": "src/repro/simnet/fused.py:242 (jnp.cumsum of the downlink FIFO)",
    "build_calendar": "src/repro/simnet/fused.py:144 (_device_calendar)",
}
SOURCES = {
    "lb_route": "src/repro_torch/kernels/csrc/ejfat_kernels.cu",
    "dispatch_plan": "src/repro_torch/kernels/csrc/ejfat_kernels.cu",
    "seg_masks": "src/repro_torch/kernels/csrc/ejfat_kernels.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
    "farm_serve": "src/repro_torch/kernels/csrc/simnet_kernels.cu",
    "seq_cumsum": "src/repro_torch/kernels/csrc/simnet_kernels.cu",
    "build_calendar": "src/repro_torch/kernels/csrc/simnet_kernels.cu",
}
DESIGNS = {
    "lb_route": "persistent grid (1024-thread blocks, one per SM, from a full wave of "
                "them; 256-thread blocks below), every instance's tables staged in "
                "shared memory, 4 packets per thread",
    "dispatch_plan": "one launch (+ a same-stream clear of its flags), single pass over "
                     "4096-packet tiles, two-level decoupled look-back across tiles",
    "seg_masks": "one thread per row, row i-1 read directly",
    "farm_serve": "one thread per member walks its rows in order, the next row's loads "
                  "issued before the current row's float64 chain",
    "seq_cumsum": "one block: its threads stage 4096-row tiles in shared memory, thread 0 "
                  "adds each tile in row order",
    "build_calendar": "one warp, lane i owns member i: quotas, 512 SWRR steps and the "
                      "quota walk as shuffle reductions; returns at once when do_sw is false",
}
# flash_attention has two designs, chosen by (dtype, head dim): the main path
# (bf16, d=128) runs the wgmma one
DESIGN_SOURCES = {
    "wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
    "mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
}

# the Yi-6B prefill shape of the serving phase (max_len = Yi-6B's context)
FLASH_T, FLASH_HQ, FLASH_HKV, FLASH_D = 4096, 32, 4, 128


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
    is then lost in the noise and there is no measurement to report.
    Returns ``(ms, out)``: ``out`` is what the graph's last ``fn()`` call
    returned, which every replay rewrites, so it holds the last replayed
    call's outputs."""
    flush = torch.ones(32 << 20, dtype=torch.int32, device="cuda")
    _warm_up(torch, fn)

    def capture(with_fn):
        g, out = torch.cuda.CUDAGraph(), None
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.sum()
                if with_fn:
                    out = fn()
        return g, out

    (g_fn, out), (g_flush, _) = capture(True), capture(False)
    graphs = {True: g_fn, False: g_flush}
    per = {True: [], False: []}
    for _ in range(rounds):
        for k, g in graphs.items():
            per[k].append(_replay_ms(torch, g) / reps)
    ms = statistics.median(per[True]) - statistics.median(per[False])
    noise = max(per[False]) - min(per[False])
    check(ms > noise, f"call time {ms:.6f} ms is not above the eviction noise "
                      f"{noise:.6f} ms: not measured")
    return ms, out


def time_warm(torch, fn, reps=200, rounds=7):
    """Device time of one ``fn()`` call with its inputs in L2, as the main
    path finds them, in ms: ``reps`` calls back to back in one CUDA graph
    (no eviction, so a call of a few us is not lost behind a ~40 us one),
    median over ``rounds`` replays. Returns ``(ms, out)`` as
    ``time_on_card`` does."""
    _warm_up(torch, fn)
    g, out = torch.cuda.CUDAGraph(), None
    with torch.cuda.graph(g):
        for _ in range(reps):
            out = fn()
    return statistics.median(_replay_ms(torch, g) / reps for _ in range(rounds)), out


def _warm_up(torch, fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def _replay_ms(torch, g):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def check_equal(torch, what, got, want):
    """Every output tensor of a kernel call exactly equal to the plain one."""
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.equal(g, w), f"{what}: output {i} differs from plain")


def max_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (integers: 0 when equal)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def bound(bytes_moved, ops, ops_per_s=INT_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def full_width_headers(np, rng, base, span, n=N_FULL):
    from repro_torch.core.protocol import encode_headers

    ev = (base + rng.integers(-span // 8, span + span // 8, n)).astype(np.uint64)
    ev[:64] = np.uint64(2**64 - 1) - np.arange(64, dtype=np.uint64)  # top of the space
    words = encode_headers(ev, rng.integers(0, 1 << 16, n).astype(np.uint32))
    bad = np.arange(0, n, CORRUPT_EVERY)
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
    check_equal(torch, "lb_route (4 instances)", got, want)
    err = max_err(got, want)
    n_valid = int(got[3].sum())
    check(n_valid <= N_FULL - n_bad, "corrupt headers were routed")
    want1 = ref.lb_route_ref(hdr, single)
    check_equal(torch, "lb_route (1 instance)", lb_route(hdr, single), want1)
    table_bytes = sum(t.numel() * t.element_size() for t in stacked.fields().values())
    t_k, last = time_on_card(torch, lambda: lb_route(hdr, stacked, iid))
    check_equal(torch, "lb_route (4 instances) after graph replays", last, want)
    t_p, _ = time_on_card(torch, lambda: ref.lb_route_ref(hdr, stacked, iid))
    t_k1, last = time_on_card(torch, lambda: lb_route(hdr, single))
    check_equal(torch, "lb_route (1 instance) after graph replays", last, want1)
    single_bytes = sum(t.numel() * t.element_size() for t in single.fields().values())
    b_ms, b_by = bound(N_FULL * (16 + 4 + 16) + table_bytes, N_FULL * 120)
    b1_ms, _ = bound(N_FULL * (16 + 16) + single_bytes, N_FULL * 120)
    results["lb_route"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=err, library_ms=None, design=DESIGNS["lb_route"],
                               shape=f"N=2^20, {N_INST}x{MAX_MEMBERS} stacked",
                               single_instance_ms=t_k1, single_instance_bound_ms=b1_ms)
    say(f"[kernels] lb_route 4x{MAX_MEMBERS} stacked, N=2^20, {n_bad} corrupt, "
        f"{n_valid} routed: equal to plain, also after graph replays; kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / t_k:.1%} reached); "
        f"single instance kernel {t_k1:.4f} ms, bound {b1_ms:.4f} ms "
        f"({b1_ms / t_k1:.1%} reached), equal")

    # -- dispatch_plan on the routed members --------------------------------------
    member = got[0]
    pos, counts = dispatch_plan(member, n_members=MAX_MEMBERS)
    pos_r, counts_r = ref.dispatch_plan_ref(member, n_members=MAX_MEMBERS)
    check_equal(torch, "dispatch_plan", (pos, counts), (pos_r, counts_r))
    err = max_err((pos, counts), (pos_r, counts_r))
    check(int(counts.sum()) == n_valid, "dispatch_plan counts do not sum to routed")
    edge = torch.tensor([3, -1, 600, 3, 511, -5, 3, 512], dtype=torch.int32, device="cuda")
    ep, ec = dispatch_plan(edge, n_members=MAX_MEMBERS)
    epr, ecr = ref.dispatch_plan_ref(edge, n_members=MAX_MEMBERS)
    check(torch.equal(ep, epr) and torch.equal(ec, ecr), "dispatch_plan edge cases differ")
    t_k, last = time_on_card(torch, lambda: dispatch_plan(member, n_members=MAX_MEMBERS))
    check_equal(torch, "dispatch_plan after graph replays", last, (pos_r, counts_r))
    t_p, _ = time_on_card(torch, lambda: ref.dispatch_plan_ref(member, n_members=MAX_MEMBERS))
    b_ms, b_by = bound(N_FULL * 8 + MAX_MEMBERS * 4, N_FULL * 20)
    results["dispatch_plan"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=err, library_ms=None,
                                    design=DESIGNS["dispatch_plan"],
                                    shape=f"N=2^20, n_members={MAX_MEMBERS}")
    say(f"[kernels] dispatch_plan N=2^20 n_members={MAX_MEMBERS}: equal to plain, also "
        f"after graph replays; kernel {t_k:.4f} ms (its scratch clear included), plain "
        f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / t_k:.1%} reached)")

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
    t_k, last = time_on_card(torch, lambda: seg_masks(sv, s_hi, s_lo, s_daq, s_seg))
    check_equal(torch, "seg_masks after graph replays", last, (ng_r, dup_r))
    t_p, _ = time_on_card(torch, lambda: ref.seg_masks_ref(sv, s_hi, s_lo, s_daq, s_seg))
    b_ms, b_by = bound(N_FULL * 28, N_FULL * 12)
    results["seg_masks"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=err, library_ms=None, design=DESIGNS["seg_masks"],
                                shape="N=2^20 sorted rows")
    say(f"[kernels] seg_masks N=2^20 ({int(ng.sum())} groups, {int(dup.sum())} dups): "
        f"equal to plain, reassembly_plan card == CPU; kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    say("[kernels] library call: none — no single PyTorch call computes lb_route, "
        "dispatch_plan or seg_masks")
    return results


def flash_phase(torch, np):
    """flash_attention against its plain version on the card (bf16 at the
    Yi-6B prefill shape, at a ragged T causal and not, at B=2 with a ragged
    T and with Granite-20B's 48/1 heads; fp32 at a small shape), each check
    naming the design that ran it; then the kernel's (wgmma design), the
    plain version's and SDPA's times at the prefill shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import _design, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    rng = np.random.default_rng(12)

    def qkv(b, t, hq, hkv, d, dtype):
        mk = lambda h: torch.from_numpy(
            rng.standard_normal((b, t, h, d), dtype=np.float32)).to("cuda", dtype)
        return mk(hq), mk(hkv), mk(hkv)

    def compare(q, k, v, causal, atol, rtol, what):
        before = _lib.LAUNCHES["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        design = "wgmma" if _lib.LAUNCHES["flash_attention_wgmma"] > before else "mma"
        check(design == _design(q.dtype, q.shape[-1]),
              f"flash_attention {what}: the {design} design ran, not the one chosen")
        what = f"[{design}] {what}"
        check(bool(torch.isfinite(got).all()), f"flash_attention {what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"flash_attention {what} differs from plain: max |err| {err}")
        note = ""
        if not causal and q.dtype == torch.bfloat16:
            # what a kernel that lets zero-padded keys into a non-causal
            # softmax (the Pallas kernel's padding fault, 128-key blocks)
            # would read here; at a small T the check must tell it apart
            pad = -k.shape[1] % 128
            z = lambda x: torch.cat([x, x.new_zeros(x.shape[0], pad, *x.shape[2:])], 1)
            fault = flash_attention_ref(q, z(k), z(v), causal=False).float()
            f_err = float((fault - want.float()).abs().max())
            caught = not torch.allclose(fault, want.float(), rtol=rtol, atol=atol)
            check(caught or k.shape[1] > 128,
                  f"flash_attention {what}: the check cannot tell a padded-key fault "
                  f"apart (its max |err| {f_err})")
            note = (f"; a padded-key fault would read {f_err:.3g}, "
                    f"{'caught' if caught else 'NOT caught at this T'}")
        say(f"[kernels] flash_attention {what}: within atol {atol:g} rtol {rtol:g} "
            f"of plain (max |err| {err:.3g}){note}")
        return err

    # bf16: the kernel rounds P to bf16 before the PV product, so a row's
    # error is ~2^-9 |v| sqrt(sum p^2): up to ~4e-3 in the first causal rows
    # (few keys, |o| up to ~3, hence rtol), ~1e-4 in rows over thousands of
    # keys. atol 5e-3 sits above that and far under a padded-key fault at
    # T=65 and 100 (|o| ~ sqrt(e/T) ~ 0.2 there)
    # B=2 at a ragged T: a tensor map not bounded per batch would read
    # batch 1's rows into batch 0's last tile; 48/1 heads: Granite-20B's MQA
    errs = []
    for b, t, hq, hkv, causal in ((1, FLASH_T, FLASH_HQ, FLASH_HKV, True),
                                  (1, 3000, FLASH_HQ, FLASH_HKV, True),
                                  (1, 3000, FLASH_HQ, FLASH_HKV, False),
                                  (2, 1000, FLASH_HQ, FLASH_HKV, True),
                                  (2, 1000, FLASH_HQ, FLASH_HKV, False),
                                  (1, 3000, 48, 1, True),
                                  (1, 65, FLASH_HQ, FLASH_HKV, False),
                                  (1, 100, FLASH_HQ, FLASH_HKV, False)):
        q, k, v = qkv(b, t, hq, hkv, FLASH_D, torch.bfloat16)
        errs.append(compare(q, k, v, causal, 5e-3, 2e-2,
                            f"bf16 B={b} T={t} {hq}/{hkv} heads d={FLASH_D} "
                            f"{'causal' if causal else 'non-causal'}"))
    # fp32 against a full-fp32 plain version (no TF32 in its einsums); it
    # stays off for the rest of the run (the fp32 card == CPU serve needs it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for causal in (True, False):
        q, k, v = qkv(2, 200, 8, 2, 80, torch.float32)
        compare(q, k, v, causal, 1e-4, 1e-4,
                f"fp32 B=2 T=200 8/2 heads d=80 causal={causal}")

    q, k, v = qkv(1, FLASH_T, FLASH_HQ, FLASH_HKV, FLASH_D, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, T, d]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - flash_attention_ref(q, k, v).float()).abs().max())
    design = _design(q.dtype, FLASH_D)
    check(design == "wgmma", f"the Yi-6B prefill shape chose the {design} design")
    t_k, _ = time_on_card(torch, lambda: flash_attention(q, k, v, causal=True))
    t_p, _ = time_on_card(torch, lambda: flash_attention_ref(q, k, v, causal=True), reps=5)
    t_l, _ = time_on_card(torch, sdpa)
    bytes_moved = 2 * FLASH_T * FLASH_D * (2 * FLASH_HQ + 2 * FLASH_HKV)  # bf16 q, o, k, v
    ops = 4 * FLASH_HQ * FLASH_D * FLASH_T * (FLASH_T + 1) // 2
    b_ms, b_by = bound(bytes_moved, ops, BF16_FLOPS_PER_S)
    say(f"[kernels] flash_attention bf16 B=1 T={FLASH_T} {FLASH_HQ}/{FLASH_HKV} heads "
        f"d={FLASH_D} causal: kernel ({design}) {t_k:.4f} ms ({ops / t_k / 1e9:.1f} "
        f"TFLOP/s, {t_k / t_l:.3f}x SDPA), plain {t_p:.4f} ms, "
        f"SDPA {t_l:.4f} ms (max |SDPA - plain| {lib_err:.3g}), bound {b_ms:.4f} ms "
        f"({b_by}: {ops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB)")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs),
                library_ms=t_l, design=design, design_sources=DESIGN_SOURCES,
                shape=f"B=1 T={FLASH_T} Hq={FLASH_HQ} Hkv={FLASH_HKV} d={FLASH_D} bf16 causal")


# ---------------------------------------------------------------------------
# phase 4: the closed loop
# ---------------------------------------------------------------------------

LOOP_KERNELS = ("lb_route", "dispatch_plan", "seg_masks")
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
        for name in LOOP_KERNELS:
            check(per_step[name] >= 1, f"{name} not launched in step {step}: {per_step}")
    steps = res.step_s
    per_step_min = {k: min(st[k] for st in res.step_launches) for k in launches}
    line = dict(s, launches=launches, launches_per_step_min=per_step_min,
                packets_routed=res.packets_routed,
                packets_packed=res.packets_packed,
                step_s_median=statistics.median(steps), step_s_max=max(steps),
                phase_s={k: round(v, 4) for k, v in res.phase_s.items()})
    say("[loop] " + json.dumps(line, sort_keys=True))
    return launches, int(statistics.median(res.windows))


def main_path_sizes(torch, np, window_n, tick_n):
    """``lb_route`` and ``dispatch_plan`` at the main path's own sizes, with
    their inputs in L2 as the main path leaves them (``time_warm``): the
    loop's median window (routed padded to a power of two against one
    512-member instance, as ``DataPlane.route_window`` does, then planned
    unpadded over 512 members) and a serving tick (``tick_n`` requests
    against the engine's one 64-member instance). Each against its plain
    version after the replays."""
    from repro_torch.core import EpochManager, MemberSpec
    from repro_torch.core.dataplane import DataPlane
    from repro_torch.core.protocol import encode_headers, words_to_tensor
    from repro_torch.data.segmentation import next_pow2
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import dispatch_plan
    from repro_torch.kernels.lb_route import lb_route

    rng = np.random.default_rng(13)
    vlb, base, span = full_width_tables(np, rng)
    single = DataPlane.from_manager(vlb.instances[0], device="cuda").tables
    n_route = next_pow2(window_n)
    words, _ = full_width_headers(np, rng, base, span, n_route)
    hdr = words_to_tensor(words, "cuda")
    t_route, last = time_warm(torch, lambda: lb_route(hdr, single))
    check_equal(torch, f"lb_route N={n_route} after graph replays", last,
                ref.lb_route_ref(hdr, single))
    member = last[0][:window_n].contiguous()
    t_plan, last = time_warm(torch, lambda: dispatch_plan(member, n_members=MAX_MEMBERS))
    check_equal(torch, f"dispatch_plan N={window_n} after graph replays", last,
                ref.dispatch_plan_ref(member, n_members=MAX_MEMBERS))

    em = EpochManager(max_members=64)  # the serving engine's table
    em.initialize({m: MemberSpec(node_id=m, lane_bits=FULL_SERVE["lane_bits"])
                   for m in range(FULL_SERVE["n_replicas"])},
                  {m: 1.0 for m in range(FULL_SERVE["n_replicas"])})
    tick_tables = DataPlane.from_manager(em, device="cuda").tables
    tick = words_to_tensor(encode_headers(
        np.cumsum(rng.integers(1, 5, tick_n)).astype(np.uint64),
        rng.integers(0, 1 << 16, tick_n).astype(np.uint32)), "cuda")
    t_tick, last = time_warm(torch, lambda: lb_route(tick, tick_tables))
    check_equal(torch, f"lb_route N={tick_n} after graph replays", last,
                ref.lb_route_ref(tick, tick_tables))
    say(f"[kernels] main-path sizes, inputs in L2 (graphs of 200 calls): lb_route "
        f"N={n_route} (the loop's median window {window_n}, padded; one instance) "
        f"{t_route * 1e3:.3f} us, dispatch_plan N={window_n} n_members={MAX_MEMBERS} "
        f"{t_plan * 1e3:.3f} us, lb_route N={tick_n} (a serving tick, one 64-member "
        f"instance) {t_tick * 1e3:.3f} us; each equal to plain after the replays")
    return {"lb_route": dict(loop_window_n=n_route, loop_window_ms=t_route,
                             serving_tick_n=tick_n, serving_tick_ms=t_tick),
            "dispatch_plan": dict(loop_window_n=window_n, loop_window_ms=t_plan)}


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

FULL_SERVE = dict(n_replicas=2, lane_bits=2, max_len=4096, rebalance_every=4)
N_REQUESTS, N_AFTER_DRAIN, MAX_NEW = 12, 4, 16


def small_serve(torch, np):
    """The Yi-6B smoke config (fp32) served on the card and on the CPU from
    one set of weights: the same routing, tokens and stats."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_smoke_config("yi_6b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, ServeConfig(n_replicas=2, lane_bits=1, max_len=64,
                                             device=dev), M.to_device(params, dev))
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 10))),
                           max_new_tokens=6) for _ in range(9)]
        eng.run_until_done(300)
        seen[dev] = ([(r.event_number, r.entropy, r.member, r.node, r.lane, r.output,
                       r.done) for r in reqs], eng.stats)
    check(seen["cuda"] == seen["cpu"], f"small serve differs card vs CPU:\n"
                                       f"{seen['cuda']}\n{seen['cpu']}")
    check(all(r[-1] and len(r[-2]) == 6 for r in seen["cuda"][0]), "small serve unfinished")
    say(f"[serve] yi-6b smoke (fp32), 2 replicas, 9 requests: card == CPU "
        f"(routing, lanes, tokens, stats {seen['cuda'][1]})")


def _observed_engine(torch):
    """ServingEngine that records, around the engine's own calls, each
    prefill's flash_attention launches and time, each routing tick's
    lb_route launches, and each replica's decode step times."""
    from repro_torch.kernels import _lib
    from repro_torch.serve.engine import ServingEngine

    class ObservedEngine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefills, self.routes, self.decode_s = [], [], {}
            report = self.hub.report_step

            def observed(m, step_time, **kw):
                self.decode_s.setdefault(m, []).append(step_time)
                return report(m, step_time=step_time, **kw)
            self.hub.report_step = observed

        def _route_pending(self):
            n, before = len(self.unrouted), _lib.LAUNCHES["lb_route"]
            super()._route_pending()
            if n:
                self.routes.append((n, _lib.LAUNCHES["lb_route"] - before))

        def _prefill_into_slot(self, req):
            torch.cuda.synchronize()
            before, t0 = _lib.LAUNCHES["flash_attention"], time.perf_counter()
            super()._prefill_into_slot(req)
            torch.cuda.synchronize()
            self.prefills.append((len(req.prompt), _lib.LAUNCHES["flash_attention"] - before,
                                  time.perf_counter() - t0))

    return ObservedEngine


def kernel_share_of_prefill(torch, M, cfg, params, prompt):
    """Share of one prefill's device time spent in flash_attention: CUDA
    events around each launch and around the whole prefill."""
    from repro_torch.kernels import flash_attention as fa

    orig, spans = fa.flash_attention, []

    def timed(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*a, **kw)
        e.record()
        spans.append((s, e))
        return out

    state = M.init_decode_state(cfg, 1, FULL_SERVE["max_len"], "cuda")
    tokens = torch.as_tensor(prompt[None], dtype=torch.int32, device="cuda")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    fa.flash_attention = timed
    try:
        a.record()
        M.prefill(params, {"tokens": tokens}, state, cfg)
        b.record()
        b.synchronize()
    finally:
        fa.flash_attention = orig
    kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
    return kernel_ms, a.elapsed_time(b), len(spans)


def decode_profile(torch, M, cfg, params, state, steps=3):
    """Where a decode step's time goes: ``steps`` steps of one replica's
    state (every lane fed) under ``torch.profiler``; the device's busy time
    is the sum of kernel and copy intervals on the card (one stream, so they
    do not overlap). The profiler's own host cost lengthens the wall time,
    so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.zeros(state["pos"].shape[0], dtype=torch.int32, device="cuda")
    M.decode_step(params, toks, state, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, state = M.decode_step(params, toks, state, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n_ops = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            n_ops += 1
    return dict(decode_profiled_step_ms=wall / steps * 1e3,
                decode_device_busy_ms_per_step=busy_us / steps / 1e3,
                decode_device_busy_share=busy_us / 1e6 / wall,
                decode_device_ops_per_step=n_ops / steps)


def full_serve(torch, np):
    """Yi-6B at full depth and width on the card behind the LB front door."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = []
    M.tree_map(lambda w: sizes.append(w.numel()), params)
    eng = _observed_engine(torch)(cfg, ServeConfig(device="cuda", **FULL_SERVE), params)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 4001, N_REQUESTS)
    check(bool((lens >= 3072).any() and (lens % 64).any()),
          f"prompt lengths {lens.tolist()} miss a long or a ragged prompt")

    _lib.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=MAX_NEW)
            for n in lens]
    eng.run_until_done()
    first_wave = dict(eng.stats["routed"])
    # drain replica 1 hit-lessly, as examples/serve_lb.py does: weight 0 in
    # an epoch that starts at the next event. A rebalance has already
    # committed the next epoch_horizon (1024) events to its own epoch, and
    # an epoch cannot start inside that window, so the drain starts right
    # after it; the post-drain requests arrive after that gap (the front
    # door's event numbers stand for arrival order).
    eng.cp.weights[1] = 0.0
    eid = eng.cp.schedule_epoch(eng.next_event, boundary=eng.next_event)
    drain_start = eng.manager.records[eid].start_event
    committed = drain_start - eng.next_event
    eng.next_event = max(eng.next_event, drain_start)
    drained = [eng.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=MAX_NEW)
               for n in rng.integers(256, 4001, N_AFTER_DRAIN)]
    reqs += drained
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)

    check(all(r.event_number >= drain_start and r.node == 0 for r in drained),
          f"post-drain requests reached replica 1: {[(r.event_number, r.node) for r in drained]}")
    say(f"[serve] drain of replica 1 scheduled at event {drain_start - committed}, starts at "
        f"event {drain_start}: the last rebalance had committed the {committed} events "
        f"before it to its own epoch, so this run moves the engine's next event number "
        f"past them (arrivals there would still reach replica 1); then "
        f"{N_AFTER_DRAIN} requests, nodes {[r.node for r in drained]}")

    st = eng.stats
    after = {m: st["routed"].get(m, 0) - first_wave.get(m, 0) for m in (0, 1)}
    check(all(r.done and len(r.output) == MAX_NEW for r in reqs), "a request did not finish")
    check(st["rejected"] == 0 and st["completed"] == len(reqs), f"stats {st}")
    check(set(first_wave) == {0, 1}, f"first wave did not reach both replicas: {first_wave}")
    check(after == {0: N_AFTER_DRAIN, 1: 0}, f"drained replica 1 got work: {after}")
    check(st["rebalances"] >= 1, "the control loop never rebalanced")
    check(len(eng.prefills) == len(reqs), "a request was not prefilled once")
    for n, fl, _ in eng.prefills:
        check(fl == cfg.n_layers * (n > 1),
              f"prefill of {n} tokens launched flash_attention {fl} times")
    check(launches["flash_attention"] == cfg.n_layers * sum(n > 1 for n, _, _ in eng.prefills),
          f"flash_attention launches {launches['flash_attention']} in the serving run")
    check(launches["flash_attention_wgmma"] == launches["flash_attention"],
          f"{launches['flash_attention_wgmma']} of the {launches['flash_attention']} "
          "flash_attention launches of the serving run went through the wgmma design")
    for n, lb in eng.routes:
        check(lb >= 1, f"a routing tick of {n} requests launched lb_route {lb} times")

    for r in reqs:
        check(all(0 <= t < cfg.vocab for t in r.output), "token out of the vocabulary")
    longest = max(reqs, key=lambda r: len(r.prompt)).prompt
    k_ms, p_ms, n_spans = kernel_share_of_prefill(torch, M, cfg, params, longest)
    check(n_spans == cfg.n_layers, "the profiled prefill missed flash_attention")
    decode = decode_profile(torch, M, cfg, params, eng.states[0])
    pre_s = [s for _, _, s in eng.prefills]
    n_prompt = sum(n for n, _, _ in eng.prefills)
    n_out = sum(len(r.output) for r in reqs)
    line = dict(
        model=cfg.name, n_params=sum(sizes), dtype=cfg.dtype, init_s=t_init, **FULL_SERVE,
        lanes_per_replica=eng.n_lanes, requests=len(reqs), prompt_tokens=n_prompt,
        prompt_lens=[n for n, _, _ in eng.prefills], max_new_tokens=MAX_NEW,
        served_tokens=n_out, wall_s=wall, served_tokens_per_s=n_out / wall,
        prefill_ms_median=statistics.median(pre_s) * 1e3, prefill_ms_max=max(pre_s) * 1e3,
        prefill_tokens_per_s=n_prompt / sum(pre_s),
        decode_step_ms_median={m: statistics.median(v) * 1e3
                               for m, v in sorted(eng.decode_s.items())},
        decode_steps={m: len(v) for m, v in sorted(eng.decode_s.items())},
        flash_launches=launches["flash_attention"],
        flash_wgmma_launches=launches["flash_attention_wgmma"],
        lb_route_launches=launches["lb_route"],
        route_calls=st["route_calls"], rebalances=st["rebalances"],
        routed_first_wave=first_wave, routed_after_drain=after,
        drain_start_event=drain_start, events_committed_before_drain=committed,
        flash_share_of_prefill=k_ms / p_ms, share_prefill_tokens=len(longest),
        share_method="CUDA events around each flash_attention launch and the whole prefill",
        share_kernel_ms=k_ms, share_prefill_ms=p_ms, **decode,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[serve] " + json.dumps(line, sort_keys=True))
    return launches


# ---------------------------------------------------------------------------
# phase 6: the virtual-time simulator
# ---------------------------------------------------------------------------

SIMNET_KERNELS = ("lb_route", "farm_serve", "seq_cumsum", "build_calendar")
SIMNET_SMALL = ("baseline", "straggler", "hetero_farm", "correlated_loss", "multi_instance")
SIMNET_SMALL_STEPS = 30
# the closed loop's full-width traffic (closed_loop.FULL_WIDTH) on the
# straggler: 16 DAQs x 128 triggers of 64 kB mean bundles per 128 ms window
# (1.024 GB/s offered, ~16k jumbo frames), 10 GbE member links, and a farm
# whose byte cost puts it at ~0.7 of capacity with the per-packet cost
SIMNET_OFFERED_BPS = 16 * 128 * 64_000 / 0.128
SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, SIMNET_K = 16, 96, 8
SIMNET_CPU_WINDOWS = 8
SIMNET_HOST_MEMBERS, SIMNET_HOST_WINDOWS = 64, 12
# chain bounds (reasoned, not measured): a farm row's carried chain is 5
# dependent float64 operations (max, sub, max, add, select) of at least 4
# cycles each; a running sum one add per row; a calendar is 512 round-robin
# steps of 5 dependent shuffle rounds and 512 walk steps of 2, each at least
# ~23 cycles; at the H100 SXM boost clock
FARM_CHAIN_OPS, CHAIN_CYCLES_PER_OP = 5, 4
CAL_CHAIN_SHUFFLES, SHUFFLE_CYCLES = 512 * 5 + 512 * 2, 23
SM_CLOCK_HZ = 1.98e9


def simnet_config(n_members, steps, engine, device, **extra):
    from repro_torch.data.segmentation import DEFAULT_MTU_PAYLOAD
    from repro_torch.simnet import get_scenario
    from repro_torch.simnet.links import LinkConfig

    scn = get_scenario("straggler")
    cfg = scn.build_config(
        steps=steps, n_members=n_members, n_daqs=16, triggers_per_step=128,
        mean_bundle_bytes=64_000, mtu_payload=DEFAULT_MTU_PAYLOAD,
        member_link=LinkConfig(rate_Bps=1.25e9, prop_delay_s=5e-5, jitter_s=2e-5),
        service_per_byte_s=0.55 * n_members / 1.024e9, engine=engine, device=device,
        **extra)
    return cfg, scn


def farm_utilisation(cfg) -> float:
    """Offered work over the farm's capacity (the straggler's member 0 at 4x
    its service cost), from the mean frame of the run's traffic."""
    from repro_torch.data.segmentation import DEFAULT_MTU_PAYLOAD

    pkts_per_s = SIMNET_OFFERED_BPS / DEFAULT_MTU_PAYLOAD
    per_member = (cfg.service_per_packet_s * pkts_per_s
                  + cfg.service_per_byte_s * SIMNET_OFFERED_BPS) / cfg.n_members
    scale = cfg.service_scale if cfg.service_scale is not None else [1.0] * cfg.n_members
    return float(sum(per_member * x for x in scale) / cfg.n_members)


def time_eager(torch, fn, reps=3):
    """Device time of one eager ``fn()`` call (host launches included), in
    ms: CUDA events around ``reps`` calls after one warm-up call. For the
    plain versions, which read device values on the host and so cannot be
    captured in a graph."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _comparable(report) -> dict:
    d = report.to_dict(with_traces=True)
    d.pop("wall_s")
    d.pop("packets_per_sec")
    return d


def simnet_small(torch):
    """Every hook-free, non-controld preset: host engine on the card == on
    the CPU, the whole report."""
    import dataclasses

    from repro_torch.simnet import Simulator, get_scenario

    done = {}
    for name in SIMNET_SMALL:
        scn = get_scenario(name)
        runs = [Simulator(scn.build_config(steps=SIMNET_SMALL_STEPS, engine="host",
                                           device=dev), dataclasses.replace(scn)).run()
                for dev in ("cuda", "cpu")]
        a, b = (_comparable(r) for r in runs)
        check(a == b, f"simnet {name}: the host engine on the card differs from the CPU:"
                      f"\n{a}\n{b}")
        check(not runs[0].violations and runs[0].bundles_completed > 0,
              f"simnet {name}: {runs[0].violations}")
        done[name] = runs[0].bundles_completed
    say(f"[simnet] small presets ({SIMNET_SMALL_STEPS} windows each), host engine card == "
        f"CPU, whole report: bundles completed {done}")


def simnet_kernels(torch, np):
    """farm_serve, seq_cumsum and build_calendar against their plain
    versions at the full-width window's size, exact; kernel times in graphs
    of 200 calls (inputs in L2, as the fused step leaves them), plain times
    eager."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.calendar import build_calendar
    from repro_torch.kernels.farm_serve import farm_serve
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    rng = np.random.default_rng(15)
    n = 16_384
    results, lines = {}, []
    for m in (SIMNET_FUSED_MEMBERS, SIMNET_HOST_MEMBERS):
        member = np.sort(rng.integers(0, m, n))
        counts = np.bincount(member, minlength=m)
        t = np.concatenate([np.sort(rng.uniform(0.0, 0.128, c)) for c in counts])
        nbytes = rng.uniform(1_000, 9_000, n)
        svc = 2e-5 + nbytes * (0.55 * m / 1.024e9)
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            t, svc, np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            rng.uniform(0, 0.01, m), np.zeros(m), np.full(m, 0.05))]
        got = farm_serve(*args)
        want = ref.farm_serve_ref(*args)
        check_equal(torch, f"farm_serve {n} rows over {m} members", got, want)
        t_k, last = time_warm(torch, lambda: farm_serve(*args))
        check_equal(torch, f"farm_serve {m} members after graph replays", last, want)
        t_p = time_eager(torch, lambda: ref.farm_serve_ref(*args), reps=2)
        b_ms, b_by = bound(n * (8 + 8 + 8 + 1) + (m + 1) * 4 + 6 * m * 8, n * 10,
                           FP64_OPS_PER_S)
        chain_ms = int(counts.max()) * FARM_CHAIN_OPS * CHAIN_CYCLES_PER_OP / SM_CLOCK_HZ * 1e3
        results[m] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                          chain_bound_ms=chain_ms, rows_longest_member=int(counts.max()),
                          dropped=int(got[1].sum()))
        lines.append(f"{m} members (longest {int(counts.max())} rows, {int(got[1].sum())} "
                     f"dropped): kernel {t_k * 1e3:.2f} us, plain {t_p:.2f} ms, bound "
                     f"{b_ms * 1e3:.3f} us ({b_by}), chain bound {chain_ms * 1e3:.2f} us")
    say(f"[simnet] farm_serve N={n}, exactly equal to plain, also after graph replays: "
        + "; ".join(lines))
    farm = dict(results[SIMNET_FUSED_MEMBERS], max_abs_err=0, library_ms=None,
                design=DESIGNS["farm_serve"], shape=f"N={n} sorted rows, 16 members",
                members_64=results[SIMNET_HOST_MEMBERS])

    x = torch.from_numpy(rng.uniform(0.0, 7e-6, n) * rng.choice([1.0, 1e-3, 1e3], n)).cuda()
    got = seq_cumsum(x)
    want = ref.seq_cumsum_ref(x)
    check_equal(torch, f"seq_cumsum N={n}", (got,), (want,))
    tree_ulps = int((torch.cumsum(x, 0) != want).sum())
    t_k, last = time_warm(torch, lambda: seq_cumsum(x))
    check_equal(torch, "seq_cumsum after graph replays", (last,), (want,))
    t_p = time_eager(torch, lambda: ref.seq_cumsum_ref(x))
    t_l, _ = time_warm(torch, lambda: torch.cumsum(x, 0))
    b_ms, b_by = bound(n * 16, n, FP64_OPS_PER_S)
    chain_ms = n * CHAIN_CYCLES_PER_OP / SM_CLOCK_HZ * 1e3
    say(f"[simnet] seq_cumsum N={n}: exactly equal to plain (numpy's order), also after "
        f"graph replays; torch.cumsum on the card differs from it in {tree_ulps} of {n} "
        f"sums; kernel {t_k * 1e3:.2f} us, plain {t_p:.3f} ms, torch.cumsum {t_l * 1e3:.2f} "
        f"us, bound {b_ms * 1e3:.4f} us ({b_by}), chain bound {chain_ms * 1e3:.2f} us")
    scan = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
                max_abs_err=0, library_ms=t_l, library_call="torch.cumsum (tree order)",
                library_sums_differing=tree_ulps, design=DESIGNS["seq_cumsum"],
                shape=f"N={n} float64")

    w = torch.from_numpy(np.repeat(rng.uniform(0.3, 2.0, 6), 3)[:SIMNET_FUSED_MEMBERS]).cuda()
    flag = torch.tensor([True], device="cuda")
    out = torch.full((512,), -1, dtype=torch.int32, device="cuda")
    want = ref.build_calendar_ref(w, flag, torch.full_like(out, -1)).clone()
    check_equal(torch, "build_calendar (16 members, weights in tied triples)",
                (build_calendar(w, flag, out),), (want,))
    for m in (1, 5, 16, 32):
        wm = torch.from_numpy(rng.uniform(0.05, 8.0, m)).cuda()
        check_equal(torch, f"build_calendar M={m}", (build_calendar(wm, flag, out.clone()),),
                    (ref.build_calendar_ref(wm, flag, out.clone()),))
    off = torch.tensor([False], device="cuda")
    kept = torch.full_like(out, -7)
    build_calendar(w, off, kept)
    check(bool((kept == -7).all()), "build_calendar wrote its output with do_sw false")
    t_k, last = time_warm(torch, lambda: build_calendar(w, flag, out))
    check_equal(torch, "build_calendar after graph replays", (last,), (want,))
    t_off, _ = time_warm(torch, lambda: build_calendar(w, off, kept))
    t_p = time_eager(torch, lambda: ref.build_calendar_ref(w, flag, out), reps=2)
    b_ms, b_by = bound(16 * 8 + 1 + 512 * 4, 2 * 512 * 16, FP64_OPS_PER_S)
    chain_ms = CAL_CHAIN_SHUFFLES * SHUFFLE_CYCLES / SM_CLOCK_HZ * 1e3
    say(f"[simnet] build_calendar 16 members (tied triples), M=1/5/16/32, do_sw false "
        f"untouched: exactly equal to plain, also after graph replays; kernel "
        f"{t_k * 1e3:.2f} us ({t_off * 1e3:.2f} us with do_sw false), plain {t_p:.2f} ms, "
        f"bound {b_ms * 1e3:.4f} us ({b_by}), chain bound {chain_ms * 1e3:.1f} us")
    cal = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
               ms_without_switch=t_off, max_abs_err=0, library_ms=None,
               design=DESIGNS["build_calendar"], shape="16 members, 512 slots")
    return {"farm_serve": farm, "seq_cumsum": scan, "build_calendar": cal}


def _profiled(torch, fn):
    """``fn()`` under torch.profiler: (its result, wall s, device busy s as
    the sum of the card's kernel, copy and set intervals; one stream)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, wall, busy_us / 1e6


def _simnet_line(what, report, wall, busy_s, launches, busy_how, **extra):
    line = dict(run=what, engine=report.engine, windows=report.steps, wall_s=wall,
                windows_per_s=report.steps / wall, packets_per_s=report.packets_sent / wall,
                packets_sent=report.packets_sent, bundles_completed=report.bundles_completed,
                packets_dropped_queue=report.packets_dropped_queue,
                latency_p50_s=report.latency_p50_s, latency_p99_s=report.latency_p99_s,
                epoch_switches=report.epoch_switches, device_busy_s=busy_s,
                device_busy_share=busy_s / wall, busy_measured_by=busy_how,
                launches=launches, **extra)
    say("[simnet] " + json.dumps(line, sort_keys=True))


def _hold_fused_to_host(what, rf, rh):
    """The JAX package's host-vs-fused contract: counters exact, latencies
    rel 1e-9, the same segments per member, weights close."""
    counters = ("packets_sent", "packets_delivered", "packets_lost_wan",
                "packets_lost_downlink", "packets_dropped_queue",
                "packets_discarded_invalid", "duplicates_absorbed", "bundles_sent",
                "bundles_completed", "bundles_pending", "bundles_timed_out",
                "bundles_vanished", "epoch_switches")
    for f in counters:
        check(getattr(rf, f) == getattr(rh, f),
              f"{what}: {f} fused {getattr(rf, f)} != host {getattr(rh, f)}")
    worst = 0.0
    for f in ("latency_p50_s", "latency_p99_s", "latency_max_s", "latency_mean_s"):
        a, b = getattr(rf, f), getattr(rh, f)
        rel = abs(a - b) / max(abs(b), 1e-30)
        check(rel <= 1e-9 or abs(a - b) <= 1e-12, f"{what}: {f} fused {a} vs host {b}")
        worst = max(worst, rel)
    check(rf.per_member_segments == rh.per_member_segments, f"{what}: segments per member")
    for m, w in rh.final_weights.items():
        check(abs(rf.final_weights[m] - w) <= 1e-6, f"{what}: final weight of {m}")
    check(not rf.violations and not rh.violations, f"{what}: {rf.violations} {rh.violations}")
    return worst


def simnet_phase(torch, np):
    """The simulator's main path on the card; returns (kernel results,
    launches of each simnet kernel on the path)."""
    from repro_torch.kernels import _lib
    from repro_torch.simnet import Simulator, fused

    simnet_small(torch)
    results = simnet_kernels(torch, np)

    cfg, scn = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, "fused", "cuda")
    say(f"[simnet] full-width traffic: {SIMNET_OFFERED_BPS / 1e9:.3f} GB/s offered, farm "
        f"utilisation {farm_utilisation(cfg):.3f} at {SIMNET_FUSED_MEMBERS} members and "
        f"{farm_utilisation(simnet_config(SIMNET_HOST_MEMBERS, 1, 'host', 'cuda')[0]):.3f} "
        f"at {SIMNET_HOST_MEMBERS} (the straggler's member 0 at 4x)")
    traces0, calls0 = fused.FUSED_TRACES, fused.FUSED_STEP_CALLS
    _lib.reset_launches()
    sim = Simulator(cfg, scn)
    eng = fused.FusedEngine(sim, superblock=SIMNET_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captured = dict(_lib.LAUNCHES)
    check(rf.engine == "fused", f"the fused config ran the {rf.engine} engine")
    n_cap, n_rep = fused.FUSED_TRACES - traces0, fused.FUSED_STEP_CALLS - calls0
    check((n_cap, n_rep) == (1, SIMNET_FUSED_WINDOWS // SIMNET_K),
          f"fused engine: {n_cap} captures and {n_rep} replays")
    per_run = eng.program.launches_per_run
    for name in SIMNET_KERNELS:
        check(per_run.get(name, 0) == SIMNET_K,
              f"{name} launched {per_run.get(name, 0)} times per {SIMNET_K}-window replay")
    fused_launches = {k: v * n_rep for k, v in per_run.items()}
    _simnet_line(
        f"fused, {SIMNET_FUSED_MEMBERS} members", rf, wall, sum(eng.replay_ms) / 1e3,
        fused_launches, "CUDA events around each graph replay", captures=n_cap,
        replays=n_rep, launches_per_replay=per_run, launches_at_capture=captured,
        replay_ms_median=statistics.median(eng.replay_ms))

    cfg_h, _ = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, "host", "cuda")
    _lib.reset_launches()
    rh, wall_h, busy_h = _profiled(torch, lambda: Simulator(cfg_h, scn).run())
    host_launches = dict(_lib.LAUNCHES)
    check(host_launches["lb_route"] == SIMNET_FUSED_WINDOWS,
          f"the host engine launched lb_route {host_launches['lb_route']} times")
    worst = _hold_fused_to_host("fused vs host on the card", rf, rh)
    _simnet_line(f"host, {SIMNET_FUSED_MEMBERS} members", rh, wall_h, busy_h, host_launches,
                 "torch.profiler (its own cost in the wall)",
                 fused_vs_host_worst_latency_rel=worst)

    cfg_c, _ = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_CPU_WINDOWS, "fused", "cpu")
    rc = Simulator(cfg_c, scn).run()
    cfg_hc, _ = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_CPU_WINDOWS, "host", "cuda")
    worst_cpu = _hold_fused_to_host("fused on the CPU vs host on the card", rc,
                                    Simulator(cfg_hc, scn).run())
    say(f"[simnet] fused engine on the CPU plain path, {SIMNET_CPU_WINDOWS} windows: "
        f"counters equal to the host engine on the card, latencies within rel "
        f"{worst_cpu:.3g}")

    cfg_64, _ = simnet_config(SIMNET_HOST_MEMBERS, SIMNET_HOST_WINDOWS, "fused", "cuda",
                              queue_engine="torch")
    _lib.reset_launches()
    r64, wall_64, busy_64 = _profiled(torch, lambda: Simulator(cfg_64, scn).run())
    launches_64 = dict(_lib.LAUNCHES)
    check(r64.engine == "host", "64 members ran the fused engine, outside its scope")
    check(not r64.violations and r64.bundles_completed > 0, f"64 members: {r64.violations}")
    for name in ("lb_route", "farm_serve"):
        check(launches_64[name] == SIMNET_HOST_WINDOWS,
              f"{name} launched {launches_64[name]} times in {SIMNET_HOST_WINDOWS} windows")
    _simnet_line(f"host, {SIMNET_HOST_MEMBERS} members, torch queue engine", r64, wall_64,
                 busy_64, launches_64, "torch.profiler (its own cost in the wall)")
    launches = {k: fused_launches.get(k, 0) + host_launches.get(k, 0) + launches_64.get(k, 0)
                for k in SIMNET_KERNELS}
    return results, launches


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
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln or "C7508" in ln:
                say("[build] " + ln.strip())

        results = kernel_phase(torch, np)
        results["flash_attention"] = flash_phase(torch, np)
        loop_launches, window_n = loop_phase(torch)
        for name, sizes in main_path_sizes(torch, np, window_n, N_REQUESTS).items():
            results[name]["main_path"] = sizes
        small_serve(torch, np)
        serve_launches = full_serve(torch, np)
        simnet_results, simnet_launches = simnet_phase(torch, np)
        results.update(simnet_results)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1

    # launches: the sum over the main-path runs (each checked on its own)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                    launches=(loop_launches[name] + serve_launches[name]
                              + simnet_launches.get(name, 0)), **results[name])
               for name in REPLACES]
    for row in kernels:
        if row["name"] == "flash_attention":  # of which through the wgmma design
            row["launches_wgmma"] = (loop_launches["flash_attention_wgmma"]
                                     + serve_launches["flash_attention_wgmma"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
