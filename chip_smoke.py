#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Drives the port's main paths — the load balancer's closed loop, the
simulator, the control plane as a service, the two-tier fabric, and
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
                reset between calls shows there); lb_route's "global"
                design over tables above a block's shared memory (farm_1k's
                4 x 4096 member slots, the fabric's K = 8: 16 x 64) and
                dispatch_plan past one chunk of 1024 members (M = 1024,
                2048, 4096, 16,384), each exactly equal to plain and timed
                in the same run as the shared-memory design; flash_attention at the
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
                kernel launched at least once per step, then 5 steps of it
                at the paper's 512-member instance (2048 member slots:
                dispatch_plan over two chunks of members); then lb_route and
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
                device's busy share of decode steps (torch.profiler); then
                the controld mode at Yi-6B's width (2 layers): the engine a
                traced, metered tenant of a ControlDaemon, two waves of 4
                requests, card == CPU on routes, stats, the daemon's spans,
                the registry's rows and the daemon's state digest (the
                daemon's clock and the reported decode times pinned)
  6. simnet     the virtual-time simulator (repro_torch.simnet): the
                hook-free, non-controld scenarios at their small presets,
                host engine on the card == on the CPU (whole report);
                the chain probe (ns per dependent float64 add and per farm
                row and per round-robin step, the chain bounds of
                farm_serve, seq_cumsum and build_calendar);
                farm_serve, seq_cumsum exactly equal to their plain
                versions at full width; build_calendar exactly equal to
                plain at 1-512 members and 1-512 slots, its time at 16 and
                512 members over its chain bound (the probe's round-robin
                step); then the full-width straggler
                traffic (16 DAQs, 128 triggers of 64 kB bundles per window,
                ~16k jumbo frames, 1.024 GB/s offered, the farm at ~0.7 of
                capacity): the fused engine at 16 members, 96 windows, K=8
                (one capture, 12 replays, lb_route / farm_serve /
                seq_cumsum / build_calendar in every window), then again
                traced with live metrics (no capture, the same 12 replays,
                the per-row outputs copied back once per replay and timed),
                against the host engine, traced and metered, on
                the card (counters exact, latencies rel 1e-9; spans ids
                exact, times and registry rows rel 1e-9), the same
                config fused on the CPU at 8 windows against the host
                engine, and the host engine at 64 members for 12 windows
  7. controld   the control plane as a service (repro_torch.controld) on
                the simulator's host engine: farm_1k at full width (1024
                CN clients over 4 instances of 4096 member slots, 20
                windows), whose tables take lb_route's "global" design in
                every window, card == CPU (whole report and the daemon's
                state_digest), its windows/s, heartbeats/s, median daemon
                tick and the card's busy share; lease_churn, cp_restart,
                multi_tenant and leader_failover at their preset sizes,
                card == CPU, with their gates (a lease lapse, a restart
                that recovers the same digest, a failover that loses no
                bundle); the card run's journal replayed into a fresh
                daemon to the same digest
  8. fabric     the two-tier LB fabric (repro_torch.fabric) through its
                driver: vlb_spray, elephant_mice and lb_node_failure with
                every leg of their gates, card == CPU (the whole summary),
                the gates passing, one lb_route launch per window;
                elephant_mice as a ReserveFabric tenant, card == CPU with
                the daemon's digest; the tier sweep K = 2, 4, 8 on
                vlb_spray (20 windows; K = 8 stacks 16 x 64 member slots
                through lb_route's "global" design), card == CPU, its
                windows/s, packets/s and the card's busy share
  9. result     the `kernels` JSON line, the card line, and the last line
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
    # lb_route's second design (tables above shared memory): the same Pallas kernel
    "lb_route_global": "src/repro/kernels/lb_route.py:188",
}
SOURCES = {
    "lb_route": "src/repro_torch/kernels/csrc/ejfat_kernels.cu",
    "lb_route_global": "src/repro_torch/kernels/csrc/ejfat_kernels.cu",
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
    "lb_route_global": "the same grid and walk; blocks stage only the epoch segments, "
                       "calendars and member fields read from device memory through "
                       "the read-only path (tables above a block's shared memory)",
    "dispatch_plan": "one launch (+ a same-stream clear of its flags), single pass over "
                     "4096-packet tiles, two-level decoupled look-back across tiles; "
                     "past 1024 members one grid row per chunk of 1024",
    "seg_masks": "one thread per row, row i-1 read directly",
    "farm_serve": "one block per member: a copy warp streams the member's rows through a "
                  "4-stage ring of 256-row shared-memory tiles (cp.async in, mbarrier "
                  "hand-over), computes each row's t and dt (a prefix max) before the walk "
                  "and dep, drop and the peak backlog after it (coalesced stores out); one "
                  "thread walks the backlog chain alone (sub, integer relu, select, add; "
                  "both candidate backlogs carried), the next 8 rows' operands in registers",
    "seq_cumsum": "one block: a copy warp streams 1024-row tiles through a 4-stage ring in "
                  "shared memory (cp.async in, coalesced stores out, mbarrier hand-over); "
                  "one thread adds in row order, each 16-value batch loaded into registers "
                  "before the previous batch's adds",
    "build_calendar": "one block, one thread per slot (up to 512 members): quotas in "
                      "parallel (deficit in closed form, the surplus loop one redux.sync a "
                      "step over integer keys, ending at n_slots); the round-robin in one "
                      "warp, one redux.sync max of integer keys a slot; a parallel quota "
                      "check in place of the walk (the round-robin meets every quota, so the "
                      "walk moves no slot: a histogram of the winners, a member above its "
                      "quota traps); returns at once when do_sw is false",
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
    evictions alone; median over ``rounds`` replays after one untimed replay
    of each graph (its upload to the card). The graph takes the
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
    for g in graphs.values():  # a graph's first replay uploads it: not timed
        g.replay()
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
    g.replay()  # the first replay uploads the graph: not timed
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


# lb_route's "global" design: farm_1k's stacked tables (4 x 4096 member
# slots, 256 live members per instance) and the fabric's at K = 8 LBs
# (2K = 16 instances of 64 slots, 48 live); dispatch_plan past one chunk of
# 1024 members (the closed loop asks 4 slots per member: 2048 at the
# paper's 512-member instance)
WIDE_TABLES = {"farm_1k": (4, 4096, 256), "fabric_k8": (16, 64, 48)}
PLAN_MEMBERS = (1024, 2048, 4096, 16_384)


def wide_tables(np, rng, n_inst, max_members, n_live, base, span):
    """``n_inst`` LB instances of ``max_members`` slots, each with
    ``n_live`` members on slots spread over the table and four epochs whose
    boundaries lie in [base, base + span), as ``full_width_tables``."""
    from repro_torch.core import EpochManager
    from repro_torch.core.tables import MemberSpec

    ems = []
    for inst in range(n_inst):
        em = EpochManager(max_members=max_members)
        for k in range(4):
            ids = np.sort(rng.choice(max_members, n_live, replace=False)).tolist()
            members = {m: MemberSpec(node_id=m, base_lane=4 * (m % 1024),
                                     lane_bits=int(rng.integers(0, 5))) for m in ids}
            weights = {m: float(rng.uniform(0.5, 2.0)) for m in members}
            if k == 0:
                em.initialize(members, weights)
            else:
                em.reconfigure(members, weights, base + (k + inst % 4) * span // 5)
        ems.append(em)
    return ems


def wide_kernel_phase(torch, np):
    """lb_route over tables above a block's shared memory (the "global"
    design) and dispatch_plan past one chunk of members, at 2^20 packets:
    each exactly equal to plain, also after the timing's graph replays,
    timed in this run beside the shared-memory design's time."""
    from repro_torch.core.dataplane import DataPlane
    from repro_torch.core.protocol import CALENDAR_SLOTS, words_to_tensor
    from repro_torch.core.tables import MAX_EPOCH_ROWS
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.dispatch import dispatch_plan
    from repro_torch.kernels.lb_route import _design, lb_route, smem_bytes

    rng = np.random.default_rng(17)
    base, span = 1 << 40, 1 << 24
    words, n_bad = full_width_headers(np, rng, base, span)
    hdr = words_to_tensor(words, "cuda")
    per_shape = {}
    for name, (n_inst, max_members, n_live) in WIDE_TABLES.items():
        ems = wide_tables(np, rng, n_inst, max_members, n_live, base, span)
        tables = DataPlane.from_instances(ems, device="cuda").tables
        design = _design(n_inst, MAX_EPOCH_ROWS, max_members)
        need = smem_bytes("shared", n_inst, MAX_EPOCH_ROWS, max_members)
        check(design == "global" and need == _lib.lib().ejfat_lb_route_smem_bytes(
            0, n_inst, MAX_EPOCH_ROWS, CALENDAR_SLOTS, max_members),
            f"{name}: {need} B of tables picked the {design} design")
        iid = torch.from_numpy(rng.integers(0, n_inst, N_FULL).astype(np.int32)).cuda()
        before = _lib.LAUNCHES["lb_route_global"]
        got = lb_route(hdr, tables, iid)
        check(_lib.LAUNCHES["lb_route_global"] == before + 1,
              f"{name}: lb_route did not launch its global design")
        want = ref.lb_route_ref(hdr, tables, iid)
        check_equal(torch, f"lb_route ({name}: {n_inst} x {max_members})", got, want)
        n_valid = int(got[3].sum())
        check(0 < n_valid <= N_FULL - n_bad, f"{name}: {n_valid} packets routed")
        t_k, last = time_on_card(torch, lambda: lb_route(hdr, tables, iid))
        check_equal(torch, f"lb_route ({name}) after graph replays", last, want)
        t_p, _ = time_on_card(torch, lambda: ref.lb_route_ref(hdr, tables, iid))
        table_bytes = sum(t.numel() * t.element_size() for t in tables.fields().values())
        b_ms, b_by = bound(N_FULL * (16 + 4 + 16) + table_bytes, N_FULL * 120)
        per_shape[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=max_err(got, want), routed=n_valid,
                               shape=f"N=2^20, {n_inst}x{max_members} stacked",
                               table_bytes=need)
        say(f"[kernels] lb_route global design, {name} {n_inst}x{max_members} stacked "
            f"({need} B of tables, above the 232448 B a block holds), N=2^20, {n_bad} "
            f"corrupt, {n_valid} routed: equal to plain, also after graph replays; kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / t_k:.1%} reached)")
    farm = per_shape["farm_1k"]
    glob = dict(farm, library_ms=None, design=DESIGNS["lb_route_global"],
                fabric_k8=per_shape["fabric_k8"])

    chunks = {}
    lib = _lib.lib()
    for m in PLAN_MEMBERS:
        member = torch.from_numpy(np.where(rng.random(N_FULL) < 0.03, -1,
                                           rng.integers(0, m, N_FULL)).astype(np.int32)).cuda()
        got = dispatch_plan(member, n_members=m)
        want = ref.dispatch_plan_ref(member, n_members=m)
        check_equal(torch, f"dispatch_plan N=2^20 n_members={m}", got, want)
        t_k, last = time_on_card(torch, lambda: dispatch_plan(member, n_members=m))
        check_equal(torch, f"dispatch_plan n_members={m} after graph replays", last, want)
        t_p, _ = time_on_card(torch, lambda: ref.dispatch_plan_ref(member, n_members=m))
        b_ms, b_by = bound(N_FULL * 8 + m * 4, N_FULL * 20)
        scratch = 8 * lib.ejfat_dispatch_scratch_words(N_FULL, m)
        chunks[m] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=max_err(got, want), scratch_bytes=scratch,
                         chunks=-(-m // 1024))
        say(f"[kernels] dispatch_plan N=2^20 n_members={m} ({-(-m // 1024)} chunks of "
            f"members, scratch {scratch / 1e6:.2f} MB cleared per call): equal to plain, "
            f"also after graph replays; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {b_ms / t_k:.1%} reached)")
    return glob, chunks


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
LOOP_WIDE_MEMBERS, LOOP_WIDE_STEPS = 512, 5
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
    window_n = int(statistics.median(res.windows))

    # the paper's 512-member instance: 4 slots per member, so dispatch_plan
    # packs over 2048 member slots (two chunks of the kernel's members)
    args = closed_loop.parse_args(closed_loop.FULL_WIDTH + [
        "--n-members", str(LOOP_WIDE_MEMBERS), "--max-members", str(4 * LOOP_WIDE_MEMBERS),
        "--steps", str(LOOP_WIDE_STEPS), "--device", "cuda"])
    _lib.reset_launches()
    res = closed_loop.run(args)
    torch.cuda.synchronize()
    wide = dict(_lib.LAUNCHES)
    s = res.summary
    check(not s["violations"], f"512-member loop violations: {s['violations']}")
    check(s["split_events"] == 0 and s["corrupt_bundles"] == 0 and s["bundles_completed"] > 0,
          "512-member loop: split, corrupt or no bundles")
    for step, per_step in enumerate(res.step_launches):
        for name in LOOP_KERNELS:
            check(per_step[name] >= 1, f"512-member loop: {name} not launched in step {step}")
    say(f"[loop] 512 members, {4 * LOOP_WIDE_MEMBERS} member slots, {LOOP_WIDE_STEPS} "
        f"steps: step median {statistics.median(res.step_s):.4f} s, max "
        f"{max(res.step_s):.4f} s; {res.packets_routed} packets routed and all packed; "
        f"{s['bundles_completed']} of {s['bundles_sent']} bundles completed; launches "
        + json.dumps({k: v for k, v in wide.items() if v}, sort_keys=True))
    return {k: launches[k] + wide[k] for k in launches}, window_n


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
    lb_route launches, and each replica's decode step times (with
    ``pin_step_s``, the hub is told a fixed time per replica instead)."""
    from repro_torch.kernels import _lib
    from repro_torch.serve.engine import ServingEngine

    class ObservedEngine(ServingEngine):
        def __init__(self, *a, pin_step_s=None, **kw):
            super().__init__(*a, **kw)
            self.prefills, self.routes, self.decode_s = [], [], {}
            report = self.hub.report_step

            def observed(m, step_time, **kw):
                self.decode_s.setdefault(m, []).append(step_time)
                if pin_step_s is not None:  # a fixed time per replica
                    step_time = pin_step_s * (m + 1)
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


CONTROLD_SERVE = dict(n_replicas=2, lane_bits=1, max_len=256, rebalance_every=2,
                      use_controld=True, trace=True)
CONTROLD_SERVE_LAYERS, CONTROLD_SERVE_REQUESTS, CONTROLD_SERVE_NEW = 2, 8, 4
PINNED_NOW = 1_000.0


def controld_serve(torch, np):
    """Serving's controld mode at Yi-6B's width (depth cut to 2 layers, the
    rest as published): the engine as a tenant of a ControlDaemon, traced,
    with a metrics registry, on the card and on the CPU from one set of
    weights. The daemon's clock and the replicas' reported decode step times
    are pinned (both are wall time), so the routes, the rebalances and the
    daemon's state digest must be equal; tokens are not compared (bf16
    arithmetic differs between the two devices). Returns the card run's
    launches."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import model as M
    from repro_torch.serve import engine as serve_engine
    from repro_torch.telemetry.registry import MetricsRegistry

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=CONTROLD_SERVE_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    daemon_cls = serve_engine.ControlDaemon
    serve_engine.ControlDaemon = functools.partial(daemon_cls, clock=lambda: PINNED_NOW)
    seen, launches = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            reg = MetricsRegistry()
            eng = _observed_engine(torch)(
                cfg, serve_engine.ServeConfig(device=dev, **CONTROLD_SERVE),
                M.to_device(params, dev), metrics=reg, pin_step_s=0.01)
            rng = np.random.default_rng(0)
            _lib.reset_launches()
            t0 = time.perf_counter()
            reqs = []
            for _wave in range(2):  # the second wave routes after a rebalance
                reqs += [eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(16, 64))),
                                    max_new_tokens=CONTROLD_SERVE_NEW)
                         for _ in range(CONTROLD_SERVE_REQUESTS // 2)]
                eng.run_until_done(300)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(_lib.LAUNCHES)
            wall = time.perf_counter() - t0
            spans = eng.trace.spans()
            rows = {k: v for k, v in reg.sample().items()
                    if not k.startswith("serve_decode_step_seconds_sum")}
            seen[dev] = dict(
                routes=[(r.event_number, r.entropy, r.member, r.node, r.lane, r.done,
                         len(r.output)) for r in reqs],
                stats=eng.stats, digest=eng.daemon.state_digest(),
                spans={k: spans[k].tolist() for k in ("stage", "key", "pid", "aux", "t0")},
                rows=rows, wall_s=wall, prefills=list(eng.prefills))
    finally:
        serve_engine.ControlDaemon = daemon_cls
    card, cpu = seen["cuda"], seen["cpu"]
    for k in ("routes", "stats", "digest", "spans", "rows"):
        check(card[k] == cpu[k], f"controld serve: {k} differs card vs CPU:\n{card[k]}\n"
                                 f"{cpu[k]}")
    check(all(r[5] and r[6] == CONTROLD_SERVE_NEW for r in card["routes"]),
          "controld serve: a request did not finish")
    check(card["stats"]["rebalances"] >= 1 and card["stats"]["route_calls"] == 2,
          f"controld serve: stats {card['stats']}")
    check(len(card["spans"]["key"]) > 0, "controld serve recorded no daemon span")
    for n, fl, _ in card["prefills"]:
        check(fl == cfg.n_layers, f"controld serve: a prefill of {n} tokens launched "
                                  f"flash_attention {fl} times")
    check(launches["lb_route"] >= 1 and launches["flash_attention"] == cfg.n_layers * len(
        card["prefills"]), f"controld serve launches {launches}")
    say("[serve] " + json.dumps(dict(
        run=f"controld mode, yi-6b width, {cfg.n_layers} layers", **CONTROLD_SERVE,
        requests=CONTROLD_SERVE_REQUESTS, card_equals_cpu=["routes", "stats", "digest",
                                                           "spans", "rows"],
        digest=card["digest"][:16], stats=card["stats"], daemon_spans=len(card["spans"]["key"]),
        rows=card["rows"], wall_s_card=card["wall_s"], wall_s_cpu=cpu["wall_s"],
        launches={k: v for k, v in launches.items() if v}), sort_keys=True))
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
# chain bounds: farm_serve's and seq_cumsum's come from the chain probe
# (ejfat_chain_probe: ns per dependent float64 add and per farm row, one
# thread, operands in registers), median of PROBE_RUNS launches. Printed
# beside them once, the reasoned values they replace: a farm row 5
# dependent float64 operations (max, sub, max, add, select) of at least 4
# cycles, an add 4 cycles, at the H100 SXM boost clock. build_calendar's
# comes from the probe's round-robin step at 1 key a lane (one warp: a
# redux.sync, an add-min, a multiply-add; the least a step takes at any M),
# times the slots plus the surplus loop's steps, and the pairwise sum's
# dependent adds; printed beside it once, the reasoned chain it replaces
# (512 round-robin steps of 5 shuffle rounds and 512 walk steps of 2, each
# at least ~23 cycles), and the design's own loop at 16 keys a lane (its
# step above 32 members, which the lane-local max of 16 keys lengthens)
PROBE_RUNS = 5
REASONED_FARM_CHAIN_OPS, REASONED_CYCLES_PER_OP = 5, 4
REASONED_CAL_SHUFFLES, SHUFFLE_CYCLES = 512 * 5 + 512 * 2, 23
# build_calendar against plain: one warp's edges, numpy's 128-lane block, 512
CAL_MEMBERS = (1, 5, 16, 31, 32, 33, 64, 128, 129, 256, 511, 512)
CAL_SLOTS = (1, 100, 511, 512)
CAL_KINDS = ("equal", "dominant", "random", "ties")
SM_CLOCK_HZ = 1.98e9
SIMNET_KERNEL_ROWS = 16_384  # a full-width window's rows


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


def _strip_wall(d):
    """``d`` without its wall-clock keys, at every depth."""
    if isinstance(d, dict):
        return {k: _strip_wall(v) for k, v in d.items()
                if k not in ("wall_s", "packets_per_sec")}
    if isinstance(d, list):
        return [_strip_wall(x) for x in d]
    return d


def _comparable(report) -> dict:
    return _strip_wall(report.to_dict(with_traces=True))


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


def farm_inputs(torch, np, rng, m, n=SIMNET_KERNEL_ROWS):
    """A full-width window's farm rows on the card: n rows over m members
    in (member, arrival) order, the straggler's service costs, a carried
    backlog; (args of farm_serve, rows of each member)."""
    member = np.sort(rng.integers(0, m, n))
    counts = np.bincount(member, minlength=m)
    t = np.concatenate([np.sort(rng.uniform(0.0, 0.128, c)) for c in counts])
    nbytes = rng.uniform(1_000, 9_000, n)
    svc = 2e-5 + nbytes * (0.55 * m / 1.024e9)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        t, svc, np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        rng.uniform(0, 0.01, m), np.zeros(m), np.full(m, 0.05))]
    return args, counts


def scan_input(torch, np, rng, n=SIMNET_KERNEL_ROWS):
    """A window's downlink transmit times on the card (float64, spread over
    six decades, as the FIFO's running sum gets them)."""
    return torch.from_numpy(rng.uniform(0.0, 7e-6, n) * rng.choice([1.0, 1e-3, 1e3], n)).cuda()


def measured_chains() -> dict:
    """The chain probe's median ns (and cycles) per dependent float64 add,
    per farm row and per round-robin step (where the tree's probe has it)
    over PROBE_RUNS launches of 2^16 each."""
    from repro_torch.kernels.chain_probe import chain_probe

    runs = [chain_probe() for _ in range(PROBE_RUNS)]
    return {k: statistics.median(r[k] for r in runs) for k in runs[0] if k != "n"}


def calendar_weights(np, m, kind, seed):
    """The card tests' weight kinds (tests/torch_helpers.calendar_weights)."""
    rng = np.random.default_rng(seed)
    return {"equal": np.ones(m), "dominant": np.r_[40.0, np.full(m - 1, 0.05)][:m],
            "random": rng.uniform(0.05, 8.0, m),
            "ties": np.repeat(rng.uniform(0.3, 2.0, (m + 2) // 3), 3)[:m]}[kind]


def _np_sum_chain(m: int) -> int:
    """Dependent adds of numpy's pairwise sum of m lanes (kernels/ref.np_sum)."""
    if m <= 128:
        return m - 1 if m < 8 else (m // 8 - 1) + 3 + m % 8
    h = m // 2 - (m // 2) % 8
    return max(_np_sum_chain(h), _np_sum_chain(m - h)) + 1


def calendar_chain_bound(np, w, n_slots, chains) -> tuple:
    """build_calendar's measured chain bound on these weights, in ms: the
    slots' round-robin steps and the surplus loop's steps, each at the
    probe's 1-key step (a dependent redux.sync and its integer operations,
    the least a step takes at any M), and the pairwise sum's adds. Returns
    (ms, surplus steps)."""
    m = len(w)
    ideal = w / w.sum() * n_slots
    surplus = max(int(np.maximum(np.floor(ideal), 1).sum()) - n_slots, 0)
    ns = (n_slots + surplus) * chains["rr_step_ns"] + _np_sum_chain(m) * chains["add_ns"]
    return ns * 1e-6, surplus


def time_calendar(torch, np, build_calendar, ref, w_np, chains):
    """build_calendar on the card at one weight vector: its time on a switch
    and without one (graphs of 200 calls), the plain version's time, the
    bounds; the output after the replays equal to plain."""
    w = torch.from_numpy(w_np).cuda()
    flag = torch.tensor([True], device="cuda")
    off = torch.tensor([False], device="cuda")
    out = torch.full((512,), -1, dtype=torch.int32, device="cuda")
    kept = torch.full_like(out, -7)
    want = ref.build_calendar_ref(w, flag, torch.full_like(out, -1)).clone()
    t_k, last = time_warm(torch, lambda: build_calendar(w, flag, out))
    check_equal(torch, f"build_calendar {len(w_np)} members after graph replays", (last,),
                (want,))
    t_off, _ = time_warm(torch, lambda: build_calendar(w, off, kept))
    check(bool((kept == -7).all()), "build_calendar wrote its output with do_sw false")
    t_p = time_eager(torch, lambda: ref.build_calendar_ref(w, flag, out), reps=2)
    m = len(w_np)  # the round-robin's 3 integer operations per member and slot
    b_ms, b_by = bound(m * 8 + 1 + 512 * 4, 3 * 512 * m)
    got = dict(ms=t_k, ms_without_switch=t_off, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               members=m)
    if "rr_step_ns" in chains:  # a tree whose probe has the round-robin step
        chain_ms, surplus = calendar_chain_bound(np, w_np, 512, chains)
        got.update(chain_bound_ms=chain_ms, over_chain_bound=t_k / chain_ms,
                   surplus_steps=surplus)
    return got


def simnet_kernels(torch, np):
    """farm_serve, seq_cumsum and build_calendar against their plain
    versions at the full-width window's size, exact; kernel times in graphs
    of 200 calls (inputs in L2, as the fused step leaves them), plain times
    eager; farm_serve's and seq_cumsum's chain bounds from the chain probe."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.calendar import build_calendar
    from repro_torch.kernels.farm_serve import farm_serve
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    chains = measured_chains()
    reasoned_add_ns = REASONED_CYCLES_PER_OP / SM_CLOCK_HZ * 1e9
    say(f"[simnet] chain probe (one thread, 2^16 links, median of {PROBE_RUNS}): dependent "
        f"float64 add {chains['add_ns']:.4f} ns ({chains['add_cycles']:.3f} cycles), farm row "
        f"{chains['row_ns']:.4f} ns ({chains['row_cycles']:.3f} cycles; in the reference's "
        f"order {chains['straight_row_ns']:.4f} ns, {chains['straight_row_cycles']:.3f} "
        f"cycles); reasoned before: add "
        f"{reasoned_add_ns:.4f} ns, row {reasoned_add_ns * REASONED_FARM_CHAIN_OPS:.4f} ns "
        f"({REASONED_CYCLES_PER_OP} cycles per op at {SM_CLOCK_HZ / 1e9:.2f} GHz)")
    rng = np.random.default_rng(15)
    n = SIMNET_KERNEL_ROWS
    results, lines = {}, []
    for m in (SIMNET_FUSED_MEMBERS, SIMNET_HOST_MEMBERS):
        args, counts = farm_inputs(torch, np, rng, m)
        got = farm_serve(*args)
        want = ref.farm_serve_ref(*args)
        check_equal(torch, f"farm_serve {n} rows over {m} members", got, want)
        t_k, last = time_warm(torch, lambda: farm_serve(*args))
        check_equal(torch, f"farm_serve {m} members after graph replays", last, want)
        t_p = time_eager(torch, lambda: ref.farm_serve_ref(*args), reps=2)
        b_ms, b_by = bound(n * (8 + 8 + 8 + 1) + (m + 1) * 4 + 6 * m * 8, n * 10,
                           FP64_OPS_PER_S)
        longest = int(counts.max())
        chain_ms = longest * chains["row_ns"] * 1e-6
        results[m] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                          chain_bound_ms=chain_ms, chain_bound_how="longest member's rows x "
                          "the probe's ns per farm row", rows_longest_member=longest,
                          over_chain_bound=t_k / chain_ms, dropped=int(got[1].sum()))
        lines.append(f"{m} members (longest {longest} rows, {int(got[1].sum())} dropped): "
                     f"kernel {t_k * 1e3:.3f} us, plain {t_p:.2f} ms, bound {b_ms * 1e3:.3f} "
                     f"us ({b_by}), chain bound {chain_ms * 1e3:.3f} us (measured; kernel at "
                     f"{t_k / chain_ms:.3f}x)")
    say(f"[simnet] farm_serve N={n}, exactly equal to plain, also after graph replays: "
        + "; ".join(lines))
    farm = dict(results[SIMNET_FUSED_MEMBERS], max_abs_err=0, library_ms=None,
                design=DESIGNS["farm_serve"], shape=f"N={n} sorted rows, 16 members",
                members_64=results[SIMNET_HOST_MEMBERS], chain_probe=chains)

    x = scan_input(torch, np, rng)
    got = seq_cumsum(x)
    want = ref.seq_cumsum_ref(x)
    check_equal(torch, f"seq_cumsum N={n}", (got,), (want,))
    tree_ulps = int((torch.cumsum(x, 0) != want).sum())
    t_k, last = time_warm(torch, lambda: seq_cumsum(x))
    check_equal(torch, "seq_cumsum after graph replays", (last,), (want,))
    t_p = time_eager(torch, lambda: ref.seq_cumsum_ref(x))
    t_l, _ = time_warm(torch, lambda: torch.cumsum(x, 0))
    b_ms, b_by = bound(n * 16, n, FP64_OPS_PER_S)
    chain_ms = n * chains["add_ns"] * 1e-6
    say(f"[simnet] seq_cumsum N={n}: exactly equal to plain (numpy's order), also after "
        f"graph replays; torch.cumsum on the card differs from it in {tree_ulps} of {n} "
        f"sums; kernel {t_k * 1e3:.3f} us, plain {t_p:.3f} ms, torch.cumsum {t_l * 1e3:.3f} "
        f"us, bound {b_ms * 1e3:.4f} us ({b_by}), chain bound {chain_ms * 1e3:.3f} us "
        f"(measured; kernel at {t_k / chain_ms:.3f}x, the chain floor "
        f"{chain_ms / t_l:.2f}x torch.cumsum's time)")
    scan = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
                chain_bound_how="n x the probe's ns per dependent add",
                over_chain_bound=t_k / chain_ms, max_abs_err=0, library_ms=t_l,
                library_call="torch.cumsum (tree order)", library_sums_differing=tree_ulps,
                design=DESIGNS["seq_cumsum"], shape=f"N={n} float64", chain_probe=chains)

    say(f"[simnet] chain probe, round-robin step (one warp, 2^16 steps, median of "
        f"{PROBE_RUNS}): {chains['rr_step_ns']:.4f} ns ({chains['rr_step_cycles']:.3f} cycles) "
        f"at 1 key a lane, {chains['rr16_step_ns']:.4f} ns ({chains['rr16_step_cycles']:.3f} "
        f"cycles) at 16; build_calendar's chain bound takes the 1-key step at every M; this "
        f"design's own loop at 16 keys a lane (M > 32) over 512 slots: "
        f"{512 * chains['rr16_step_ns'] * 1e-3:.5f} us; the reasoned build_calendar chain "
        f"this replaces: {REASONED_CAL_SHUFFLES * SHUFFLE_CYCLES / SM_CLOCK_HZ * 1e3:.5f} ms "
        f"({REASONED_CAL_SHUFFLES} shuffle rounds of {SHUFFLE_CYCLES} cycles)")
    flag = torch.tensor([True], device="cuda")
    held = 0
    for m in CAL_MEMBERS:
        cases = [(kind, calendar_weights(np, m, kind, m)) for kind in CAL_KINDS]
        if m == 512:  # one member above 511 raised to one slot: the long surplus loop
            cases.append(("dominant x512", np.r_[40.0 * m, np.full(m - 1, 0.05)]))
        for n_slots in CAL_SLOTS:
            if m > n_slots:
                continue
            for kind, wm in (cases if n_slots == 512 else cases[2:4]):
                wt = torch.from_numpy(wm).cuda()
                out = torch.full((n_slots,), -1, dtype=torch.int32, device="cuda")
                check_equal(torch, f"build_calendar M={m} n_slots={n_slots} {kind}",
                            (build_calendar(wt, flag, out),),
                            (ref.build_calendar_ref(wt, flag, out.clone()),))
                held += 1
    w16 = np.repeat(rng.uniform(0.3, 2.0, 6), 3)[:SIMNET_FUSED_MEMBERS]
    cal = time_calendar(torch, np, build_calendar, ref, w16, chains)
    cal512 = time_calendar(torch, np, build_calendar, ref, rng.uniform(0.05, 8.0, 512),
                           chains)
    say(f"[simnet] build_calendar exactly equal to plain in {held} cases (M in "
        f"{list(CAL_MEMBERS)} x {list(CAL_KINDS)} at 512 slots, 512 dominant; random and "
        f"ties at n_slots {list(CAL_SLOTS[:3])} where M <= n_slots), after graph replays, "
        f"do_sw false untouched; " + "; ".join(
            f"{c['members']} members: kernel {c['ms'] * 1e3:.3f} us "
            f"({c['ms_without_switch'] * 1e3:.3f} us with do_sw false), plain "
            f"{c['plain_ms']:.2f} ms, bound {c['bound_ms'] * 1e3:.4f} us ({c['bound_by']}), "
            f"chain bound {c['chain_bound_ms'] * 1e3:.3f} us (measured; {c['surplus_steps']} "
            f"surplus steps; kernel at {c['over_chain_bound']:.3f}x)" for c in (cal, cal512)))
    cal = dict(cal, max_abs_err=0, library_ms=None, design=DESIGNS["build_calendar"],
               shape="16 members (tied triples), 512 slots", members_512=cal512,
               chain_bound_how="(slots + surplus steps) x the probe's 1-key round-robin "
                               "step + the pairwise sum's adds x its add",
               cases_equal=held)
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


def _hold_fused_observation_to_host(sim_f, sim_h):
    """The fused engine's replayed spans and registry rows against the host
    engine's: ids exact, times and rows within rel 1e-9 (abs 1e-12), the
    process's resident memory aside. Returns (spans, rows) compared."""
    import numpy as np

    a, b = sim_h.trace.spans(), sim_f.trace.spans()
    check(len(a["key"]) == len(b["key"]) > 0,
          f"spans: host {len(a['key'])}, fused {len(b['key'])}")
    for f in ("stage", "key", "pid", "aux"):
        check(bool(np.array_equal(a[f], b[f])), f"spans: {f} differs fused vs host")
    for f in ("t0", "t1"):
        check(bool(np.allclose(b[f], a[f], rtol=1e-9, atol=1e-12)),
              f"spans: {f} beyond rel 1e-9 fused vs host")
    check(sim_f._lat_keys == sim_h._lat_keys, "latency keys differ fused vs host")
    want, got = sim_h.metrics.sample(), sim_f.metrics.sample()
    check(set(got) == set(want), f"registry rows: {sorted(set(got) ^ set(want))}")
    for k in sorted(set(want) - {"process_rss_bytes"}):
        check(abs(got[k] - want[k]) <= max(1e-9 * abs(want[k]), 1e-12),
              f"registry row {k}: fused {got[k]} host {want[k]}")
    return len(a["key"]), len(want) - 1


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
    # the fused engine three times at one shape: untraced, capturing the
    # program; untraced again, timed with no capture in its wall; then
    # traced with live metrics, which must reuse the program (the same
    # replays, no capture; its per-row outputs come back once per replay and
    # are timed). The two uncaptured runs give the cost of tracing.
    fused_runs, fused_launches = {}, {}
    for run, traced in (("capturing", False), ("untraced", False), ("traced", True)):
        obs = dict(trace=True, metrics_every=1) if traced else {}
        cfg, scn = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, "fused",
                                 "cuda", **obs)
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
        want = (int(run == "capturing"), SIMNET_FUSED_WINDOWS // SIMNET_K)
        check((n_cap, n_rep) == want, f"fused engine ({run}): {n_cap} captures "
                                      f"and {n_rep} replays, want {want}")
        per_run = eng.program.launches_per_run
        for name in SIMNET_KERNELS:
            check(per_run.get(name, 0) == SIMNET_K,
                  f"{name} launched {per_run.get(name, 0)} times per {SIMNET_K}-window replay")
        check(len(eng.row_copy_s) == (n_rep if traced else 0),
              f"per-row copies {len(eng.row_copy_s)} in {n_rep} replays (traced {traced})")
        for k, v in per_run.items():
            fused_launches[k] = fused_launches.get(k, 0) + v * n_rep
        extra = {}
        if traced:
            extra = dict(row_copies=len(eng.row_copy_s),
                         row_copy_ms_median=statistics.median(eng.row_copy_s) * 1e3,
                         row_copy_bytes=eng.row_copy_bytes,
                         row_copy_how="host clock around the per-row outputs' copy, "
                                      "after the replay's other outputs came back",
                         spans=len(sim.trace.spans()["key"]))
        _simnet_line(
            f"fused, {SIMNET_FUSED_MEMBERS} members, {run}", rf, wall,
            sum(eng.replay_ms) / 1e3, {k: v * n_rep for k, v in per_run.items()},
            "CUDA events around each graph replay", captures=n_cap, replays=n_rep,
            launches_per_replay=per_run, launches_at_capture=captured,
            replay_ms_median=statistics.median(eng.replay_ms), **extra)
        fused_runs[run] = (rf, sim, n_rep, wall)
    check(fused_runs["untraced"][2] == fused_runs["traced"][2],
          "tracing changed the replay count")
    check(_comparable(fused_runs["untraced"][0]) == _comparable(fused_runs["traced"][0])
          == _comparable(fused_runs["capturing"][0]),
          "tracing or capturing changed the fused engine's report")
    say(f"[simnet] cost of tracing, both runs without capture: traced "
        f"{fused_runs['traced'][3]:.6f} s / untraced {fused_runs['untraced'][3]:.6f} s = "
        f"{fused_runs['traced'][3] / fused_runs['untraced'][3]:.6f}")
    switched = sum(r[0].epoch_switches for r in fused_runs.values())
    results["build_calendar"].update(switch_launches=switched,
                                     fused_launches=fused_launches["build_calendar"])
    say(f"[simnet] build_calendar did a switch in {switched} of its "
        f"{fused_launches['build_calendar']} launches in the three fused runs (their "
        f"epoch_switches); the rest returned at do_sw false")
    rf, sim_f, _, _ = fused_runs["traced"]

    cfg_h, _ = simnet_config(SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, "host", "cuda",
                             trace=True, metrics_every=1)
    _lib.reset_launches()
    sim_h = Simulator(cfg_h, scn)
    rh, wall_h, busy_h = _profiled(torch, sim_h.run)
    host_launches = dict(_lib.LAUNCHES)
    check(host_launches["lb_route"] == SIMNET_FUSED_WINDOWS,
          f"the host engine launched lb_route {host_launches['lb_route']} times")
    worst = _hold_fused_to_host("fused vs host on the card", rf, rh)
    n_spans, n_rows = _hold_fused_observation_to_host(sim_f, sim_h)
    _simnet_line(f"host, {SIMNET_FUSED_MEMBERS} members, traced", rh, wall_h, busy_h,
                 host_launches, "torch.profiler (its own cost in the wall)",
                 fused_vs_host_worst_latency_rel=worst, spans_equal=n_spans,
                 metrics_rows_equal=n_rows)

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


# ---------------------------------------------------------------------------
# phase 7: the control plane as a service
# ---------------------------------------------------------------------------

CONTROLD_PRESETS = ("lease_churn", "cp_restart", "multi_tenant", "leader_failover")
FARM_1K_WINDOWS = 20


def _controld_sim(name, device, steps=None):
    import dataclasses

    from repro_torch.simnet import Simulator, get_scenario

    scn = get_scenario(name)
    extra = {} if steps is None else dict(steps=steps)
    return Simulator(scn.build_config(engine="host", device=device, **extra),
                     dataclasses.replace(scn))


def controld_phase(torch, np):
    """farm_1k at full width on the card against the CPU, with its rates
    and the card's busy share; the other controld presets card == CPU with
    their gates; the card run's journal replayed into a fresh daemon.
    Returns the launches of the farm_1k run (the main path)."""
    import tempfile

    from repro_torch.controld import ControlDaemon, Journal
    from repro_torch.kernels import _lib

    sim = _controld_sim("farm_1k", "cuda", FARM_1K_WINDOWS)
    cfg = sim.cfg
    ticks = []
    tick = sim.client.tick

    def timed_tick(*a, **kw):
        t0 = time.perf_counter()
        out = tick(*a, **kw)
        ticks.append(time.perf_counter() - t0)
        return out

    sim.client.tick = timed_tick
    tables = sim.dataplane().tables
    check(tuple(tables.member_node.shape) == (4, 4096),
          f"farm_1k tables are {tuple(tables.member_node.shape)}, not 4 x 4096")
    _lib.reset_launches()
    report, wall, busy = _profiled(torch, sim.run)
    launches = dict(_lib.LAUNCHES)
    # every farm_1k window delivers packets: one route per window
    check(launches["lb_route_global"] == launches["lb_route"] == cfg.steps,
          f"farm_1k: lb_route launched {launches['lb_route']} times, its global design "
          f"{launches['lb_route_global']}, in {cfg.steps} windows")
    heartbeats = sum(s.counters["heartbeats"] for s in sim.daemon.sessions.values())
    cpu_sim = _controld_sim("farm_1k", "cpu", FARM_1K_WINDOWS)
    cpu = cpu_sim.run()
    check(_comparable(report) == _comparable(cpu),
          f"farm_1k: the card's report differs from the CPU's:\n{_comparable(report)}\n"
          f"{_comparable(cpu)}")
    digest = sim.daemon.state_digest()
    check(digest == cpu_sim.daemon.state_digest(), "farm_1k: daemon digests differ")
    check(not report.violations and report.bundles_completed > 0,
          f"farm_1k: {report.violations}")
    line = dict(run="farm_1k", members=cfg.n_members, instances=cfg.n_instances,
                member_slots=int(tables.member_node.shape[1]), windows=cfg.steps,
                wall_s=wall, windows_per_s=cfg.steps / wall, heartbeats=heartbeats,
                heartbeats_per_s=heartbeats / wall, ticks=len(ticks),
                tick_ms_median=statistics.median(ticks) * 1e3, device_busy_s=busy,
                device_busy_share=busy / wall,
                busy_measured_by="torch.profiler (its own cost in the wall)",
                bundles_completed=report.bundles_completed,
                bundles_sent=report.bundles_sent, epoch_switches=report.epoch_switches,
                latency_p50_s=report.latency_p50_s, latency_p99_s=report.latency_p99_s,
                launches={k: v for k, v in launches.items() if v}, digest=digest[:16])
    say("[controld] " + json.dumps(line, sort_keys=True) + " — card == CPU (whole report, "
        "daemon digest)")

    # the card run's journal, written to a file, into a fresh daemon
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "farm_1k.jsonl"
        with open(path, "w", encoding="utf-8") as f:
            for e in sim.daemon.journal.entries:
                f.write(e.to_line() + "\n")
        journal = Journal.load(str(path))
        fresh = ControlDaemon.recover(
            journal, n_instances=cfg.n_instances, clock=sim.clock.now,
            lease_s=sim._lease_s(), epoch_horizon=max(16, 8 * cfg.triggers_per_step),
            max_members=max(64, 4 * cfg.n_members))
        journal.close()
        check(fresh.state_digest() == digest,
              "farm_1k: the card run's journal replays to another digest")
    say(f"[controld] farm_1k journal ({len(sim.daemon.journal.entries)} entries) replayed "
        f"into a fresh daemon: the same digest")

    gates = {}
    for name in CONTROLD_PRESETS:
        card_sim, cpu_sim = _controld_sim(name, "cuda"), _controld_sim(name, "cpu")
        r, rc = card_sim.run(), cpu_sim.run()
        check(_comparable(r) == _comparable(rc), f"{name}: the card's report differs "
                                                 f"from the CPU's")
        check(card_sim.daemon.state_digest() == cpu_sim.daemon.state_digest(),
              f"{name}: daemon digests differ card vs CPU")
        check(not r.violations, f"{name}: {r.violations}")
        if name == "lease_churn":
            check(r.leases_expired >= 1, "lease_churn: no lease lapsed")
        if name == "cp_restart":
            check(r.daemon_restarts >= 1 and card_sim.restart_digest_mismatches == 0,
                  "cp_restart: no restart, or a recovered digest differs")
        if name == "leader_failover":
            check(r.ha_failovers >= 1 and card_sim.ha_digest_mismatches == 0,
                  "leader_failover: no failover, or a resumed digest differs")
            check(r.bundles_completed == r.bundles_sent and r.bundles_timed_out == 0,
                  f"leader_failover lost bundles: {r.bundles_completed} of "
                  f"{r.bundles_sent} completed, {r.bundles_timed_out} timed out")
        gates[name] = dict(windows=r.steps, bundles_completed=r.bundles_completed,
                           bundles_sent=r.bundles_sent, leases_expired=r.leases_expired,
                           daemon_restarts=r.daemon_restarts, ha_failovers=r.ha_failovers,
                           ha_failover_durations=r.ha_failover_durations)
    say("[controld] presets, host engine card == CPU (whole report, daemon digest): "
        + json.dumps(gates, sort_keys=True))
    return launches


# ---------------------------------------------------------------------------
# phase 8: the two-tier LB fabric
# ---------------------------------------------------------------------------

FABRIC_PRESETS = ("vlb_spray", "elephant_mice", "lb_node_failure")
FABRIC_TIERS, FABRIC_SWEEP_STEPS = (2, 4, 8), 20


def _fabric_args(device):
    from repro_torch.fabric import run as fabric_run
    return fabric_run.parse_args(["--device", device])


def _timed(torch, fn):
    """``fn()`` on the host clock, the card synchronised before and after:
    (its result, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fabric_phase(torch, np):
    """The fabric (repro_torch.fabric) through its driver: each preset with
    every leg of its gate on the card == on the CPU (the driver's whole
    summary), every gate passing, one lb_route launch per window of every
    leg, each on the card twice (under the profiler for the busy share, then
    without it for the rates); elephant_mice as a ReserveFabric tenant of the daemon, card == CPU
    (report and state digest); then bench_fabric's tier sweep (vlb_spray,
    20 windows, K = 2, 4, 8: 4 to 16 stacked calendars of 64 member slots,
    K = 8 through lb_route's "global" design), card == CPU, its windows/s,
    packets/s and the card's busy share. Returns the launches of the card
    runs."""
    from repro_torch.fabric import FabricSim, get_fabric_scenario
    from repro_torch.fabric import run as fabric_run
    from repro_torch.kernels import _lib

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    legs = {"vlb_spray": 2, "elephant_mice": 2, "lb_node_failure": 1}
    for name in FABRIC_PRESETS:
        # under the profiler for the card's busy share only, then timed
        # without it for the rates
        _lib.reset_launches()
        card_p, wall_p, busy = _profiled(torch, lambda: fabric_run.run_scenario(
            name, _fabric_args("cuda")))
        card, wall = _timed(torch, lambda: fabric_run.run_scenario(name, _fabric_args("cuda")))
        launches = dict(_lib.LAUNCHES)
        cpu, wall_cpu = _timed(torch, lambda: fabric_run.run_scenario(
            name, _fabric_args("cpu")))
        check(_strip_wall(card) == _strip_wall(cpu) == _strip_wall(card_p),
              f"fabric {name}: the card's summary differs from the CPU's:\n{card}\n{cpu}")
        check(not card["violations"] and card["gates"] and all(card["gates"].values()),
              f"fabric {name}: gates {card['gates']} violations {card['violations']}")
        steps = get_fabric_scenario(name).build_config().steps
        check(launches["lb_route"] == 2 * legs[name] * steps
              and launches["lb_route_global"] == 0,
              f"fabric {name}: lb_route launches {launches} in two runs of "
              f"{legs[name]} x {steps} windows")
        add(launches)
        primary = card.get("vlb") or card.get("isolated") or card["report"]
        say("[fabric] " + json.dumps(dict(
            scenario=name, gates=card["gates"], legs=legs[name], windows=legs[name] * steps,
            wall_s=wall, windows_per_s=legs[name] * steps / wall, wall_s_cpu=wall_cpu,
            primary_wall_s=primary["wall_s"],
            primary_packets_per_s=primary["segments_sent"] / primary["wall_s"],
            rates_measured_by="host clock without the profiler (whole driver run; the "
                              "primary leg by its own FabricReport.wall_s)",
            wall_s_profiled=wall_p, device_busy_s=busy, device_busy_share=busy / wall_p,
            busy_measured_by="torch.profiler, the card run before the timed one",
            segments_sent_primary=primary["segments_sent"],
            max_lb_load_frac=primary["max_lb_load_frac"],
            mice_p99_s=primary["mice_p99_s"], elephant_p99_s=primary["elephant_p99_s"],
            bundles_lost=primary["bundles_lost"], lbs_killed=primary["lbs_killed"],
            card_equals_cpu="the driver's whole summary", launches=launches), sort_keys=True))

    sc = get_fabric_scenario("elephant_mice")
    seen = {}
    for dev in ("cuda", "cpu"):
        _lib.reset_launches()
        sim = FabricSim(sc.build_config(controld=True, device=dev), scenario=sc)
        r = sim.run()
        if dev == "cuda":
            add(dict(_lib.LAUNCHES))
        seen[dev] = (_strip_wall(r.to_dict()), sim.daemon.state_digest())
    report, digest = seen["cuda"]
    check(seen["cuda"] == seen["cpu"], f"controld fabric: card != CPU\n{seen}")
    check(not report["violations"], f"controld fabric: {report}")
    say(f"[fabric] elephant_mice as a ReserveFabric tenant ({2 * sc.overrides['k_lbs']} "
        f"sessions): card == CPU, report and digest {digest[:16]}")

    sweep = {}
    sc = get_fabric_scenario("vlb_spray")
    for k in FABRIC_TIERS:
        def sim(dev):
            return FabricSim(sc.build_config(steps=FABRIC_SWEEP_STEPS, k_lbs=k, device=dev),
                             scenario=sc).run()

        _lib.reset_launches()
        card_p, wall_p, busy = _profiled(torch, lambda: sim("cuda"))
        card, wall = _timed(torch, lambda: sim("cuda"))
        launches = dict(_lib.LAUNCHES)
        check(launches["lb_route"] == 2 * FABRIC_SWEEP_STEPS
              and launches["lb_route_global"] == 2 * FABRIC_SWEEP_STEPS * (k >= 7),
              f"fabric K = {k}: launches {launches} in two runs")
        add(launches)
        cpu, wall_cpu = _timed(torch, lambda: sim("cpu"))
        check(_strip_wall(card.to_dict()) == _strip_wall(cpu.to_dict())
              == _strip_wall(card_p.to_dict()), f"fabric K = {k}: card != CPU")
        check(not card.violations, f"fabric K = {k}: {card.violations}")
        sweep[k] = dict(
            stacked_calendars=2 * k, design="global" if k >= 7 else "shared",
            wall_s=wall, windows_per_s=FABRIC_SWEEP_STEPS / wall,
            packets_per_s=card.segments_sent / wall, segments_sent=card.segments_sent,
            wall_s_cpu=wall_cpu, windows_per_s_cpu=FABRIC_SWEEP_STEPS / wall_cpu,
            wall_s_profiled=wall_p, device_busy_s=busy, device_busy_share=busy / wall_p,
            max_lb_load_frac=card.max_lb_load_frac, latency_p99_s=card.latency_p99_s)
    per_window = {k: 1 / v["windows_per_s"] for k, v in sweep.items()}
    say("[fabric] tier sweep, vlb_spray, " + str(FABRIC_SWEEP_STEPS) + " windows, card == "
        "CPU (whole report); the card's rates on the host clock without the profiler, "
        "busy share under torch.profiler (the card run before), the CPU's wall beside: "
        + json.dumps(sweep, sort_keys=True))
    say(f"[fabric] card's time per window, K = 8 (global) / K = 2 (shared): "
        f"{per_window[8] / per_window[2]:.6f}")
    return total


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
        results["lb_route_global"], chunks = wide_kernel_phase(torch, np)
        results["dispatch_plan"]["member_chunks"] = chunks
        results["flash_attention"] = flash_phase(torch, np)
        loop_launches, window_n = loop_phase(torch)
        for name, sizes in main_path_sizes(torch, np, window_n, N_REQUESTS).items():
            results[name]["main_path"] = sizes
        small_serve(torch, np)
        serve_launches = full_serve(torch, np)
        for k, v in controld_serve(torch, np).items():
            serve_launches[k] += v
        simnet_results, simnet_launches = simnet_phase(torch, np)
        results.update(simnet_results)
        controld_launches = controld_phase(torch, np)
        fabric_launches = fabric_phase(torch, np)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1

    # launches: the sum over the main-path runs (each checked on its own)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                    launches=(loop_launches[name] + serve_launches[name]
                              + simnet_launches.get(name, 0) + controld_launches[name]
                              + fabric_launches.get(name, 0)),
                    **results[name])
               for name in REPLACES]
    for row in kernels:
        if fabric_launches.get(row["name"]):  # of which in the fabric phase
            row["launches_fabric"] = fabric_launches[row["name"]]
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
