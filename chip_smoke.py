#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Drives the port's main paths — the load balancer's closed loop, the
simulator, the control plane as a service, the two-tier fabric,
LB-front-door serving of Yi-6B, training with LB ingest (Yi-6B and the moe,
vlm, hybrid, ssm and audio families), serving of the MoE
family (Mixtral-8x22B, Arctic) and the vlm, audio, hybrid and ssm families
(Llama-3.2-Vision-90B, HuBERT-XLarge, Zamba2-2.7B, RWKV6-7B) — through the
entry points a user calls,
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
                kernel that lets padded keys into the softmax must fail);
                at d=80 (StableLM-3B's layers, Zamba2's shared block: one
                wide and one narrow box per tile) at T=127, 128, 129 and
                4096 causal and not, at B=2 with T=1000 causal and not and
                at T=65 and T=100 non-causal, each with 32/32 and 32/4
                heads; all within atol 5e-3, rtol 2e-2 of its plain
                version; in fp32 (d=80) within 1e-4. Each check names the
                design that ran it: wgmma (csrc/flash_attention_wgmma.cu,
                bf16 at d = 64, 80 or 128) or mma (csrc/flash_attention.cu,
                fp32 and bf16 at d = 16 or 32). Kernel time (CUDA
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
                capacity): the fused engine at 16 members, 48 windows, K=8
                (one capture, 6 replays, lb_route / farm_serve /
                seq_cumsum / build_calendar in every window), then again
                traced with live metrics (no capture, the same 6 replays,
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
  9. train      training with LB ingest (repro_torch.train): the Yi-6B
                smoke config (float32, TF32 off) through launch.train
                --lb-ingest, 4 steps, card == CPU (loss, grad_norm, lr
                within rtol/atol 2e-4, occupancy exact, lb_route once per
                step); then Yi-6B at full width, 8 of its 32 layers (bf16,
                random weights, remat, batch 4 x 2048 tokens): steps 1-6
                with the embedded control plane and a checkpoint at step 3,
                every leaf's gradient finite and non-zero after step 1, a
                fresh trainer restored from step 3 repeating steps 4-6
                exactly (steps 4-6 of both runs under deterministic
                algorithms, the other steps not), one step under
                torch.profiler (the card's busy share), 2 steps in
                controld mode, 1 step with 8-bit moments and gradient
                compression; lb_route launched once per step, flash_attention
                never; median step ms (steps 1-3, 8-9), trained tokens/s,
                peak memory against the state's reckoning, the checkpoint's
                save and restore seconds
 9a. train_dp   jit_train_step over a one-rank NCCL group: Yi-6B width,
                8 layers, bit for bit the one-process trainer's steps;
                then the Mixtral smoke config with accum_steps 3 and 3
                dispatch groups a microbatch, card == CPU, every
                dispatch_plan call equal to plain
 9b. serve_tp   serving under the placement (launch/serve_step.py) over a
                one-rank NCCL group on make_debug_mesh(1, 1): Yi-6B width,
                8 of 32 layers (bf16, random weights), a prefill of 4 x
                2048 tokens and 8 decode steps; the logits of every step
                and every decode-state leaf bit for bit the one-process
                prefill/decode_step's, flash_attention once a layer in the
                prefill on wgmma; prefill ms, decode step ms, peak memory,
                collectives by kind
 9c. train_families  training of the moe, vlm, hybrid, ssm and audio
                families with LB ingest, after the earlier phases' tensors
                are freed: the smoke configs of Mixtral, Arctic,
                Llama-Vision (fed its vision embeddings), Zamba2, RWKV6
                (rwkv_chunk 1 and 4) and HuBERT through the Trainer, card
                == CPU from one checkpoint drawn on the CPU (loss,
                grad_norm, lr within rtol/atol 2e-4, occupancy exact), a
                checkpoint at step 2 restored into a fresh trainer whose
                steps 3-4 equal the live run's (deterministic algorithms);
                then at published width on the card (bf16, random weights,
                remat): Mixtral-8x22B 2 of 56 layers with 8-bit moments,
                Zamba2-2.7B all 54, RWKV6-7B 16 of 32 at rwkv_chunk 64,
                HuBERT-XLarge all 48 over 4 x 1500 frames: a warm-up step
                with every leaf's gradient finite and non-zero (HuBERT's
                token table zero by design), 3 timed steps, one profiled;
                lb_route once a step, dispatch_plan once for the ingest and
                twice per MoE layer (forward, remat's recompute),
                flash_attention never; step ms, tokens/s, peak memory
                against the state's reckoning, the card's busy share
 10. moe        the MoE family, after the earlier phases' tensors are
                freed: the Mixtral smoke config served card == CPU;
                dispatch_plan at the pack's shapes (a 4000-token prefill's
                8000 k-major packets over 8 experts and over Arctic's 128, a
                4-lane decode step's 8), exactly equal to plain, timed with
                inputs in L2; flash_attention at Mixtral's prefill shape
                (T=4096, 48/8 heads) against plain and SDPA; one Mixtral MoE
                layer at full width (bf16, T=512) with its positions from the
                kernel bit-equal to the same layer with plain positions;
                Mixtral-8x22B at published width, 8 of its 56 layers (40.9
                GB of random bf16 weights), 2 replicas x 4 slots, 8192-token
                contexts (a 4096-slot ring), 12 prompts of 256-4000 tokens and
                one of 4500 (past the window: plain attention, ring
                eviction), a drain of replica 1 and 4 more requests; every
                prefill within the window launches flash_attention once per
                layer (wgmma), the long one never, every forward step
                launches dispatch_plan once per layer, every routing tick
                lb_route; the shares of the longest in-window prefill taken
                by flash_attention, the expert products and dispatch_plan
                (CUDA events) and its drops; then Arctic at published width,
                2 of its 35 layers (55.4 GB; 1 if 2 do not fit), 4 requests
 11. families   the vlm, audio, hybrid and ssm families, after the earlier
                phases' tensors are freed: the four smoke configs card ==
                CPU (fp32, TF32 off, rtol/atol 2e-4: HuBERT's forward,
                Llama-Vision's prefill with vision tokens and 4 decode
                steps, Zamba2 and RWKV6 served at 2 replicas x 4 slots with
                equal routes, tokens and stats); flash_attention at
                Zamba2's prefill shape (T=4096, 32/32 heads, d=80) and
                Llama-Vision's (64/8, d=128), both on the wgmma design,
                causal and not, against plain and timed beside SDPA;
                Llama-3.2-Vision-90B at published width, 20 of its 100
                layers (38.4 GB): a 2048-token prefill of 4 lanes with their
                own 1601 vision tokens (flash_attention once per self layer,
                18, wgmma), 32 decode steps reusing the stored vision, a
                4000-token prefill with the cross layers' share; Zamba2-2.7B
                at full size served with a drain (9 wgmma launches per
                prefill, the Mamba2 blocks' share of the longest prefill);
                RWKV6-7B at full size served with a drain (no attention),
                then a 2048-token prefill at rwkv_chunk 1 and 64;
                HuBERT-XLarge's encoder over 4 x 1500 frames (no kernel)
 12. roofline   every prefill, decode step, forward and training step
                measured above (Yi-6B, Mixtral, Llama-Vision, Zamba2,
                RWKV6, HuBERT; the training steps of Yi-6B's width and of
                phase 9c's four families, 8-bit moments where they ran) against the
                port's analytic model of its work at its own shape and depth
                (repro_torch.analysis.perfmodel, chips = dp = tp = 1) on the
                H100's roofline (analysis.roofline.H100): model FLOPs,
                analytic FLOPs and bytes, the compute and memory terms, the
                measured ms, mfu and roofline_fraction, each in (0, 1.05];
                then one sharded line: the dry run's Yi-6B train_4k cell on
                the reference's one-pod mesh (make_production_mesh(), 16 x
                16, tensor-parallel on "model"), lowered on torch's fake
                process group in a subprocess on the CPU (started at the
                smoke's start, run beside the card's phases): its compute,
                memory and collective terms (the link term: recorded wire
                bytes / 450e9 B/s), which must hold recorded wire bytes
                above 0 with all-gathers, all-reduces and all-to-alls;
                and the same cell under seqpar (the residual stream split
                by sequence over "model", lowered beside it), whose record
                must add reduce-scatters to the baseline's and issue no
                fewer all-gathers, its collective term printed beside the
                baseline's
 13. drivers    the operator entry points as a user runs them: simnet.run's
                --compare-frozen, --compare-policy and --tournament
                proportional,pid,frozen at the straggler preset (a
                subprocess on the card: every gate of the reference holds)
                and, through its functions on a built config, at phase 6's
                full-width traffic (24 windows; controld legs run the host
                engine): every leg card == CPU (whole report, the CPU's legs
                in a process of their own), PID not worse than proportional,
                no leg with a violation, each leg's wall s and windows/s,
                the closed loop's p99 against frozen printed; the
                critical-path analyzer (telemetry.analyze_trace) on traced
                full-width runs (16 windows, head-sampled 1/16): the fused
                engine's tables equal to the host engine's, the fabric's
                vlb_spray card == CPU, stage sums within 1% of the
                end-to-end latency at p50/p99/p99.9, each summary reloaded
                through --summary to the same tables; controld.run with
                --device cuda in subprocesses: --demo and a compacted demo
                at 64 members over 4 instances (every check true), --serve
                --metrics-port 0 driven over its socket (12 rounds of 64
                heartbeats) and /metrics scraped, --ha-demo at 64 members
                (every check true, failover_s); the three examples
                (examples/*_torch.py --device cuda) exit 0 with their
                prints; every driver's launches from its launch line
 14. result     the `kernels` JSON line, the card line, and the last line
                {"ok": true, "device": {...}}

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
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
# flash_attention has two designs, chosen by (dtype, head dim): the main
# paths (bf16, d = 80 and 128) run the wgmma one
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
    T, with Granite-20B's 48/1 heads and Mixtral-8x22B's 48/8; the d=80
    edge set; fp32 at a small shape), each check naming the design that ran
    it; then the
    kernel's (wgmma design), the plain version's and SDPA's times at the
    prefill shape."""
    from repro_torch.kernels.flash_attention import _design

    rng = np.random.default_rng(12)

    def qkv(b, t, hq, hkv, d, dtype):
        mk = lambda h: torch.from_numpy(
            rng.standard_normal((b, t, h, d), dtype=np.float32)).to("cuda", dtype)
        return mk(hq), mk(hkv), mk(hkv)

    # bf16: the kernel rounds P to bf16 before the PV product, so a row's
    # error is ~2^-9 |v| sqrt(sum p^2): up to ~4e-3 in the first causal rows
    # (few keys, |o| up to ~3, hence rtol), ~1e-4 in rows over thousands of
    # keys. atol 5e-3 sits above that and far under a padded-key fault at
    # T=65 and 100 (|o| ~ sqrt(e/T) ~ 0.2 there)
    # B=2 at a ragged T: a tensor map not bounded per batch would read
    # batch 1's rows into batch 0's last tile; 48/1 heads: Granite-20B's MQA;
    # 48/8 heads at T=4096: Mixtral-8x22B's longest in-window prefill
    errs = []
    for b, t, hq, hkv, causal in ((1, FLASH_T, FLASH_HQ, FLASH_HKV, True),
                                  (1, 3000, FLASH_HQ, FLASH_HKV, True),
                                  (1, 3000, FLASH_HQ, FLASH_HKV, False),
                                  (2, 1000, FLASH_HQ, FLASH_HKV, True),
                                  (2, 1000, FLASH_HQ, FLASH_HKV, False),
                                  (1, 3000, 48, 1, True),
                                  (1, 4096, 48, 8, True),
                                  (1, 65, FLASH_HQ, FLASH_HKV, False),
                                  (1, 100, FLASH_HQ, FLASH_HKV, False)):
        q, k, v = qkv(b, t, hq, hkv, FLASH_D, torch.bfloat16)
        errs.append(flash_compare(torch, q, k, v, causal, 5e-3, 2e-2,
                                  f"bf16 B={b} T={t} {hq}/{hkv} heads d={FLASH_D} "
                                  f"{'causal' if causal else 'non-causal'}",
                                  pad_fault=t in (65, 100)))
    # d=80 (a wide and a narrow box per tile): one 128-row tile exactly, one
    # row short and one over, Zamba2's prefill length, B=2 at a ragged T and
    # the ragged non-causal tails; 32/32 heads (StableLM-3B, Zamba2's shared
    # block) and 32/4 (GQA read in place)
    for hq, hkv in ((32, 32), (32, 4)):
        for b, t, causal in [(1, t, c) for t in (127, 128, 129, 4096) for c in (True, False)] + [
                (2, 1000, True), (2, 1000, False), (1, 65, False), (1, 100, False)]:
            q, k, v = qkv(b, t, hq, hkv, 80, torch.bfloat16)
            check(_design(q.dtype, 80) == "wgmma", "bf16 d=80 did not choose wgmma")
            errs.append(flash_compare(torch, q, k, v, causal, 5e-3, 2e-2,
                                      f"bf16 B={b} T={t} {hq}/{hkv} heads d=80 "
                                      f"{'causal' if causal else 'non-causal'}",
                                      pad_fault=t in (65, 100, 129)))
    # fp32 against a full-fp32 plain version (no TF32 in its einsums); it
    # stays off for the rest of the run (the fp32 card == CPU serve needs it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for causal in (True, False):  # fp32 d=80 stays on the mma design
        q, k, v = qkv(2, 200, 8, 2, 80, torch.float32)
        check(_design(q.dtype, 80) == "mma", "fp32 d=80 did not choose mma")
        flash_compare(torch, q, k, v, causal, 1e-4, 1e-4,
                      f"fp32 B=2 T=200 8/2 heads d=80 causal={causal}")

    q, k, v = qkv(1, FLASH_T, FLASH_HQ, FLASH_HKV, FLASH_D, torch.bfloat16)
    design = _design(q.dtype, FLASH_D)
    check(design == "wgmma", f"the Yi-6B prefill shape chose the {design} design")
    row = flash_times(torch, q, k, v, "[kernels]")
    return dict(row, max_abs_err=max(errs), design=design, design_sources=DESIGN_SOURCES)


def flash_compare(torch, q, k, v, causal, atol, rtol, what, tag="[kernels]",
                  pad_fault=False):
    """One flash_attention call against its plain version at q/k/v's shape,
    naming the design that ran (the launch counts tell); for bf16 without
    the causal mask, also what a padded-key fault would read there, which
    must fail the check where ``pad_fault`` (T = 65, 100 and 129: a fifth
    or more of the last 128-key tile is padding; at T = 127 one padded key
    hides inside the tolerance). Returns the max |kernel - plain|."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import _design, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

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
        # would read here; where pad_fault the check must tell it apart
        pad = -k.shape[1] % 128
        z = lambda x: torch.cat([x, x.new_zeros(x.shape[0], pad, *x.shape[2:])], 1)
        fault = flash_attention_ref(q, z(k), z(v), causal=False).float()
        f_err = float((fault - want.float()).abs().max())
        caught = not torch.allclose(fault, want.float(), rtol=rtol, atol=atol)
        check(caught or not pad_fault,
              f"flash_attention {what}: the check cannot tell a padded-key fault "
              f"apart (its max |err| {f_err})")
        note = (f"; a padded-key fault would read {f_err:.3g}, "
                f"{'caught' if caught else 'NOT caught at this T'}")
    say(f"{tag} flash_attention {what}: within atol {atol:g} rtol {rtol:g} "
        f"of plain (max |err| {err:.3g}){note}")
    return err


def flash_times(torch, q, k, v, tag):
    """flash_attention's (causal), its plain version's and SDPA's times at
    q/k/v's shape (bf16), the bound (bf16 q, o, k, v once each; the causal
    half of the products at the tensor cores' rate) and SDPA's distance
    from plain."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import _design, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, T, d]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - flash_attention_ref(q, k, v).float()).abs().max())
    t_k, _ = time_on_card(torch, lambda: flash_attention(q, k, v, causal=True))
    t_p, _ = time_on_card(torch, lambda: flash_attention_ref(q, k, v, causal=True), reps=5)
    t_l, _ = time_on_card(torch, sdpa)
    bytes_moved = 2 * b * t * d * (2 * hq + 2 * hkv)
    ops = 4 * b * hq * d * t * (t + 1) // 2
    b_ms, b_by = bound(bytes_moved, ops, BF16_FLOPS_PER_S)
    shape = f"B={b} T={t} Hq={hq} Hkv={hkv} d={d} bf16 causal"
    say(f"{tag} flash_attention {shape}: kernel ({_design(q.dtype, d)}) {t_k:.4f} ms "
        f"({ops / t_k / 1e9:.1f} TFLOP/s, {t_k / t_l:.3f}x SDPA), plain {t_p:.4f} ms, "
        f"SDPA {t_l:.4f} ms (max |SDPA - plain| {lib_err:.3g}), bound {b_ms:.4f} ms "
        f"({b_by}: {ops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB)")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
                shape=shape)


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


def small_serve(torch, np, arch="yi_6b", tag="[serve]", lane_bits=1):
    """A smoke config (fp32) served on the card and on the CPU from one set
    of weights: the same routing, tokens and stats."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, ServeConfig(n_replicas=2, lane_bits=lane_bits, max_len=64,
                                             device=dev), M.to_device(params, dev))
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 10))),
                           max_new_tokens=6) for _ in range(9)]
        eng.run_until_done(300)
        seen[dev] = ([(r.event_number, r.entropy, r.member, r.node, r.lane, r.output,
                       r.done) for r in reqs], eng.stats)
    check(seen["cuda"] == seen["cpu"], f"small serve of {arch} differs card vs CPU:\n"
                                       f"{seen['cuda']}\n{seen['cpu']}")
    check(all(r[-1] and len(r[-2]) == 6 for r in seen["cuda"][0]), "small serve unfinished")
    say(f"{tag} {cfg.name} (fp32), 2 replicas x {1 << lane_bits} slots, 9 requests: "
        f"card == CPU "
        f"(routing, lanes, tokens, stats {seen['cuda'][1]})")


def _observed_engine(torch):
    """ServingEngine that records, around the engine's own calls, each
    prefill's flash_attention launches and time (and its dispatch_plan
    launches, in ``prefill_plans``), each routing tick's
    lb_route launches, and each replica's decode step times (with
    ``pin_step_s``, the hub is told a fixed time per replica instead)."""
    from repro_torch.kernels import _lib
    from repro_torch.serve.engine import ServingEngine

    class ObservedEngine(ServingEngine):
        def __init__(self, *a, pin_step_s=None, **kw):
            super().__init__(*a, **kw)
            self.prefills, self.routes, self.decode_s = [], [], {}
            self.prefill_plans = []
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
            plans = _lib.LAUNCHES["dispatch_plan"]
            super()._prefill_into_slot(req)
            torch.cuda.synchronize()
            self.prefills.append((len(req.prompt), _lib.LAUNCHES["flash_attention"] - before,
                                  time.perf_counter() - t0))
            self.prefill_plans.append(_lib.LAUNCHES["dispatch_plan"] - plans)

    return ObservedEngine


def prefill_spans(torch, M, cfg, params, prompt, max_len, targets, extra=None):
    """One prefill of ``prompt`` on a fresh batch-1 state (its batch also
    holds ``extra``, such as a vlm's vision tokens), with CUDA events
    around it and around every call it makes to each of ``targets``
    (``{name: (module, attribute)}``, patched for the prefill's time).
    Returns ``({name: (ms, calls)}, prefill ms, {name: [each call's
    result]})``."""
    spans = {name: [] for name in targets}
    results = {name: [] for name in targets}
    origs = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}

    def timed(name):
        def call(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = origs[name](*a, **kw)
            e.record()
            spans[name].append((s, e))
            results[name].append(out)
            return out
        return call

    state = M.init_decode_state(cfg, 1, max_len, "cuda")
    tokens = torch.as_tensor(prompt[None], dtype=torch.int32, device="cuda")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for name, (mod, attr) in targets.items():
        setattr(mod, attr, timed(name))
    try:
        a.record()
        M.prefill(params, {"tokens": tokens, **(extra or {})}, state, cfg)
        b.record()
        b.synchronize()
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, origs[name])
    per = {name: (sum(s.elapsed_time(e) for s, e in v), len(v)) for name, v in spans.items()}
    return per, a.elapsed_time(b), results


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


def measured(cfg, kind, batch, seq_len, ms, ms_of, **extra) -> dict:
    """A path's measured time for the [roofline] phase: ``cfg`` at the depth
    it ran, ``kind`` "prefill", "decode" or "train" over ``batch`` x
    ``seq_len`` tokens (a decode step: one token a lane against a
    ``seq_len``-deep cache)."""
    return dict(cfg=cfg, kind=kind, batch=batch, seq_len=seq_len, ms=ms, ms_of=ms_of, **extra)


def decode_measured(cfg, state, cache_len, decode) -> dict:
    """``decode_profile``'s steps as a measured path: the card's busy ms a
    step (the host's ms beside it)."""
    return measured(cfg, "decode", state["pos"].shape[0], cache_len,
                    decode["decode_device_busy_ms_per_step"],
                    "the card's busy ms per decode step (torch.profiler)",
                    host_ms=decode["decode_profiled_step_ms"])


def attention_layers(cfg) -> int:
    """Self-attention layers a token passes: every layer (dense, moe), the
    vlm's layers but its cross-attention ones, the hybrid's applications of
    its shared block, none in the ssm family."""
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def flash_launches(cfg, n: int) -> int:
    """flash_attention launches of a prefill of ``n`` tokens: one per
    self-attention layer when the sequence is longer than a token and no
    longer than the sliding window (if any), else none
    (``layers.self_attention_block``)."""
    return attention_layers(cfg) * (n > 1 and (cfg.swa_window is None or n <= cfg.swa_window))


def flash_design(cfg) -> str:
    """The flash_attention design the config's prefill takes."""
    import torch

    from repro_torch.kernels.flash_attention import _design

    return _design(getattr(torch, cfg.dtype), cfg.hd)


def serve_with_drain(torch, np, cfg, params, serve_kw, lens, rng, tag,
                     drain_lens=(256, 4001)):
    """Serve prompts of ``lens`` tokens (drawn from ``rng``) on the card
    behind the LB front door, drain replica 1 hit-lessly as
    examples/serve_lb.py does, serve N_AFTER_DRAIN more, and hold the run to
    its gates: every request finishes, the drained replica gets nothing, each
    prefill launches flash_attention as ``flash_launches`` says (through the
    design ``flash_design`` names) and every routing tick launches lb_route.
    The post-drain prompts' lengths are drawn from ``drain_lens``. The launch
    counts are reset just before the run and read just after it. Returns
    (engine, requests, the run's facts)."""
    from repro_torch.kernels import _lib
    from repro_torch.serve.engine import ServeConfig

    eng = _observed_engine(torch)(cfg, ServeConfig(device="cuda", **serve_kw), params)
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
               for n in rng.integers(*drain_lens, N_AFTER_DRAIN)]
    reqs += drained
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)

    check(all(r.event_number >= drain_start and r.node == 0 for r in drained),
          f"post-drain requests reached replica 1: {[(r.event_number, r.node) for r in drained]}")
    say(f"{tag} drain of replica 1 scheduled at event {drain_start - committed}, starts at "
        f"event {drain_start}: the last rebalance had committed the {committed} events "
        f"before it to its own epoch, so this run moves the engine's next event number "
        f"past them (arrivals there would still reach replica 1); then "
        f"{N_AFTER_DRAIN} requests, nodes {[r.node for r in drained]}")

    st = eng.stats
    after = {m: st["routed"].get(m, 0) - first_wave.get(m, 0) for m in (0, 1)}
    check(set(first_wave) == {0, 1}, f"first wave did not reach both replicas: {first_wave}")
    check(after == {0: N_AFTER_DRAIN, 1: 0}, f"drained replica 1 got work: {after}")
    check(st["rebalances"] >= 1, "the control loop never rebalanced")
    serving_gates(cfg, eng, reqs, launches, tag)
    return eng, reqs, dict(wall_s=wall, launches=launches, routed_first_wave=first_wave,
                           routed_after_drain=after, drain_start_event=drain_start,
                           events_committed_before_drain=committed)


def serving_gates(cfg, eng, reqs, launches, tag):
    """Every request finished with its tokens in the vocabulary, prefilled
    once; each prefill launched flash_attention as ``flash_launches`` says,
    all through the design ``flash_design`` names; every routing tick
    launched lb_route."""
    st = eng.stats
    check(all(r.done and len(r.output) == MAX_NEW for r in reqs),
          f"{tag} a request did not finish")
    check(st["rejected"] == 0 and st["completed"] == len(reqs), f"{tag} stats {st}")
    check(len(eng.prefills) == len(reqs), f"{tag} a request was not prefilled once")
    for n, fl, _ in eng.prefills:
        check(fl == flash_launches(cfg, n),
              f"{tag} prefill of {n} tokens launched flash_attention {fl} times")
    check(launches["flash_attention"] == sum(flash_launches(cfg, n) for n, _, _ in eng.prefills),
          f"{tag} flash_attention launches {launches['flash_attention']} in the serving run")
    design = flash_design(cfg)
    want_wgmma = launches["flash_attention"] if design == "wgmma" else 0
    check(launches["flash_attention_wgmma"] == want_wgmma,
          f"{tag} {launches['flash_attention_wgmma']} of the {launches['flash_attention']} "
          f"flash_attention launches of the serving run went through the wgmma design, "
          f"where {cfg.name} takes the {design} one")
    for n, lb in eng.routes:
        check(lb >= 1, f"{tag} a routing tick of {n} requests launched lb_route {lb} times")
    for r in reqs:
        check(all(0 <= t < cfg.vocab for t in r.output), f"{tag} token out of the vocabulary")


def serve_line(cfg, eng, reqs, run, serve_kw, **extra) -> dict:
    """The numbers of a serving run: tokens/s (host clock around work that
    ends on the card), prefill and decode-step medians, launches, routing
    and the rest of ``run`` (a drain's facts)."""
    launches, st = run["launches"], eng.stats
    pre_s = [s for _, _, s in eng.prefills]
    n_prompt = sum(n for n, _, _ in eng.prefills)
    n_out = sum(len(r.output) for r in reqs)
    return dict(
        model=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype, **serve_kw,
        lanes_per_replica=eng.n_lanes, requests=len(reqs), prompt_tokens=n_prompt,
        prompt_lens=[n for n, _, _ in eng.prefills], max_new_tokens=MAX_NEW,
        served_tokens=n_out, wall_s=run["wall_s"], served_tokens_per_s=n_out / run["wall_s"],
        prefill_ms_median=statistics.median(pre_s) * 1e3, prefill_ms_max=max(pre_s) * 1e3,
        prefill_tokens_per_s=n_prompt / sum(pre_s),
        decode_step_ms_median={m: statistics.median(v) * 1e3
                               for m, v in sorted(eng.decode_s.items())},
        decode_steps={m: len(v) for m, v in sorted(eng.decode_s.items())},
        flash_launches=launches["flash_attention"],
        flash_wgmma_launches=launches["flash_attention_wgmma"],
        lb_route_launches=launches["lb_route"],
        route_calls=st["route_calls"], rebalances=st["rebalances"],
        **{k: v for k, v in run.items() if k not in ("wall_s", "launches")}, **extra)


def full_serve(torch, np):
    """Yi-6B at full depth and width on the card behind the LB front door.
    Returns (the serving run's launches, the measured paths)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = []
    M.tree_map(lambda w: sizes.append(w.numel()), params)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 4001, N_REQUESTS)
    check(bool((lens >= 3072).any() and (lens % 64).any()),
          f"prompt lengths {lens.tolist()} miss a long or a ragged prompt")
    eng, reqs, run = serve_with_drain(torch, np, cfg, params, FULL_SERVE, lens, rng, "[serve]")

    longest = max(reqs, key=lambda r: len(r.prompt)).prompt
    per, p_ms, _ = prefill_spans(torch, M, cfg, params, longest, FULL_SERVE["max_len"],
                                 {"flash_attention": (fa, "flash_attention")})
    k_ms, n_spans = per["flash_attention"]
    check(n_spans == cfg.n_layers, "the profiled prefill missed flash_attention")
    decode = decode_profile(torch, M, cfg, params, eng.states[0])
    line = serve_line(
        cfg, eng, reqs, run, FULL_SERVE, n_params=sum(sizes), init_s=t_init,
        flash_share_of_prefill=k_ms / p_ms, share_prefill_tokens=len(longest),
        share_method="CUDA events around each flash_attention launch and the whole prefill",
        share_kernel_ms=k_ms, share_prefill_ms=p_ms, **decode,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[serve] " + json.dumps(line, sort_keys=True))
    return run["launches"], [
        measured(cfg, "prefill", 1, len(longest), p_ms, "CUDA events around one prefill"),
        decode_measured(cfg, eng.states[0], FULL_SERVE["max_len"], decode)]


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
# (48 windows: the host engine's traced run costs ~1.5 s a window of host
# time)
SIMNET_FUSED_MEMBERS, SIMNET_FUSED_WINDOWS, SIMNET_K = 16, 48, 8
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


def _device_us(torch, prof) -> dict:
    """The card's kernel, copy and set intervals that ``prof`` (a finished
    torch.profiler run) recorded, in us by name, read from its raw (kineto)
    events: the function events that ``prof.events()`` builds from them
    take over a minute for a training step's ~10^5 launches."""
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            per[e.name()] = per.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e3
    return per


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
    return out, wall, sum(_device_us(torch, prof).values()) / 1e6


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


# ---------------------------------------------------------------------------
# phase 9: training with LB ingest
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048   # Yi-6B width, depth cut 32 -> 8
TRAIN_SMOKE = dict(steps=4, batch=8, seq=64)
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)  # float32 on both, TF32 off: reassociation only
TRAIN_STATE_BYTES_PER_PARAM = 2 + 2 + 4 + 4  # bf16 params, bf16 grads, f32 m and v


def _train_dir(name):
    import shutil

    d = ROOT / "build" / "train" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def train_smoke(torch, np):
    """The launcher (``repro_torch.launch.train``) on the Yi-6B smoke config
    with --lb-ingest, on the card and on the CPU, both from one checkpoint
    drawn on the CPU: loss, grad_norm and lr within TRAIN_TOL, the ingest
    occupancy exactly equal, lb_route once per step on the card."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as launch_train
    from repro_torch.train import train_step as TS

    cfg = get_smoke_config("yi-6b")
    st = TS.init_train_state(torch.Generator().manual_seed(0), cfg, TS.TrainConfig(), "cpu")
    hist = {}
    for dev in ("cuda", "cpu"):
        d = _train_dir(f"smoke_{dev}")
        ckpt.save(str(d), 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
        before = _lib.LAUNCHES["lb_route"]
        tr = launch_train.main(
            ["--arch", "yi-6b", "--demo", "--lb-ingest", "--steps", str(TRAIN_SMOKE["steps"]),
             "--batch", str(TRAIN_SMOKE["batch"]), "--seq", str(TRAIN_SMOKE["seq"]),
             "--ckpt-dir", str(d), "--device", dev])
        hist[dev] = tr.history
        if dev == "cuda":
            check(_lib.LAUNCHES["lb_route"] - before == TRAIN_SMOKE["steps"],
                  "smoke train: lb_route not launched once per step")
    worst = 0.0
    for a, b in zip(hist["cuda"], hist["cpu"]):
        check(a["ingest_occupancy"] == b["ingest_occupancy"],
              f"smoke train: occupancy differs card vs CPU: {a} {b}")
        for k in ("loss", "grad_norm", "lr"):
            err = abs(a[k] - b[k])
            check(err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(b[k]),
                  f"smoke train: {k} differs card vs CPU: {a[k]} {b[k]}")
            worst = max(worst, err / abs(b[k]))
    say("[train] " + json.dumps(dict(
        run="yi-6b smoke config (float32, TF32 off) through launch.train --lb-ingest",
        **TRAIN_SMOKE, card_equals_cpu=f"loss, grad_norm, lr within {TRAIN_TOL}; occupancy exact",
        worst_rel_diff=worst, occupancy=[h["ingest_occupancy"] for h in hist["cuda"]],
        loss_card=[h["loss"] for h in hist["cuda"]], loss_cpu=[h["loss"] for h in hist["cpu"]]),
        sort_keys=True))


def _profiled_kernels(torch, fn, top=8):
    """``fn()`` under torch.profiler: (wall s, device busy s, the ``top``
    kernels by device time as [name, ms, share of busy])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = _device_us(torch, prof)
    busy_us = sum(per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return wall, busy_us / 1e6, [[k[:90], v / 1e3, v / busy_us] for k, v in ranked]


def _checked_step(torch, tr, run, what, exempt=()):
    """One step of trainer ``tr`` with ``optimizer.update`` patched for the
    call: every leaf's gradient must be finite and non-zero, but those of
    the leaves ``exempt`` (indices), which must be finite and zero. Returns
    the number of leaves."""
    from repro_torch.train import optimizer as O
    from repro_torch.tree import leaves

    orig, seen = O.update, []

    def update(grads, state, params, cfg, **kw):
        flags = [torch.stack([torch.isfinite(g).all(), g.abs().amax() > 0])
                 for g in leaves(grads)]
        seen.append(torch.stack(flags).cpu())
        return orig(grads, state, params, cfg, **kw)

    O.update = update
    try:
        tr.run(1, **run)
    finally:
        O.update = orig
    ok = seen[0]
    bad = [i for i in range(len(ok)) if not bool(ok[i].all()) and i not in exempt]
    check(not bad, f"{what}: {len(bad)} of {len(ok)} leaves have a gradient that is not "
                   "finite or is zero after the step")
    for i in exempt:
        check(bool(ok[i, 0]) and not bool(ok[i, 1]),
              f"{what}: exempt leaf {i}'s gradient is not finite and zero")
    return len(ok)


def _timed_steps(torch, tr, times):
    """Wrap the trainer's step with a host clock that ends after the card;
    each step's seconds go to ``times``."""
    step = tr.step_fn

    def timed(*a):
        t0 = time.perf_counter()
        out = step(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    tr.step_fn = timed
    return tr


def _deterministic(torch, fn):
    """``fn()`` under ``torch.use_deterministic_algorithms(True)``: only the
    resume check runs so; a user's training, and every timed step, does not."""
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def train_full(torch, np):
    """Yi-6B at full width, depth cut to TRAIN_LAYERS (bf16, random weights,
    remat), LB ingest over a one-process mesh: steps 1-3 with the embedded
    control plane and a checkpoint at step 3, steps 4-6 live and then again
    in a fresh trainer restored from step 3 (both under deterministic
    algorithms, and equal), one profiled step, 2 steps in controld mode, 1
    step with 8-bit moments and gradient compression. Returns the launches
    of these runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import _lib
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = get_config("yi-6b").with_(n_layers=TRAIN_LAYERS)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-4, warmup_steps=2, decay_steps=100),
                        remat=True, lb_ingest=True)
    mesh = Mesh(("data",), (1,))
    ck = _train_dir("ckpt")
    run = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)

    # seconds of steps 1-3, 4-6 live and resumed (deterministic), 7 (profiled), 8-9, 10
    times = []

    def trainer(train_cfg=tc, **kw):
        return _timed_steps(torch, Trainer(cfg, train_cfg, TrainerConfig(
            ckpt_dir=str(ck), device="cuda", **kw), mesh=mesh), times)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    tr = trainer(ckpt_every=3)
    tr.init_or_restore(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(tr.state["params"]))
    n_leaves = _checked_step(torch, tr, run, "full train: step 1")
    t0 = time.perf_counter()
    tr.run(2, **run)                          # steps 2-3; run() waits for step 3's save
    t_save = time.perf_counter() - t0 - sum(times[1:3])  # the host copy and the write
    next_event = tr.next_event
    tr.cfg.ckpt_every = 1 << 30
    hist = _deterministic(torch, lambda: tr.run(3, **run))   # steps 4-6
    check(_lib.LAUNCHES["lb_route"] == 6 and _lib.LAUNCHES["flash_attention"] == 0,
          f"full train: launches after 6 steps {dict(_lib.LAUNCHES)}")
    embedded = [dict(h) for h in hist]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr, hist
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tr2 = trainer()
    tr2.cfg.ckpt_every = 1 << 30
    step = tr2.init_or_restore(torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == 3, f"full train: restored step {step}, not 3")
    tr2.next_event = next_event  # event numbers are not checkpointed (nor in the reference)
    resumed = _deterministic(torch, lambda: tr2.run(3, **run))
    for a, b in zip(resumed[-3:], embedded[-3:]):
        check(a == b, f"full train: the resume from step 3 differs:\n{a}\n{b}")
    wall, busy, top_kernels = _profiled_kernels(torch, lambda: tr2.run(1, **run))  # step 7

    tr3 = trainer(use_controld=True)
    tr3.state, tr3.next_event = tr2.state, tr2.next_event
    del tr2
    controld = tr3.run(2, **run)              # steps 8-9
    tc8 = dataclasses.replace(tc, adamw=dataclasses.replace(tc.adamw, eight_bit=True),
                              grad_compress=True)
    params = tr3.state["params"]
    tr3.state["opt"] = None
    torch.cuda.empty_cache()
    tr4 = trainer(tc8)
    tr4.state = dict(tr3.state, opt=O.init(params, tc8.adamw), efb=None)
    tr4.next_event = tr3.next_event
    del tr3
    eight = tr4.run(1, **run)                 # step 10
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    for h in embedded + resumed + controld + eight:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"full train: a step's loss is not finite: {h}")
    check(launches["lb_route"] == 13 and launches["flash_attention"] == 0,
          f"full train: launches {launches} (lb_route once per step of 13, flash_attention never)")
    check(int(tr4.state["step"]) == 10, f"full train: step {int(tr4.state['step'])}")

    step_s = times[0:3] + times[10:12]  # f32 moments, not deterministic, not profiled
    det_s = times[3:9]
    occ = [h["ingest_occupancy"] for h in embedded]
    trained = occ[0] * TRAIN_BATCH * (TRAIN_SEQ - 1)
    state_gb = n_params * TRAIN_STATE_BYTES_PER_PARAM / 1e9
    say("[train] " + json.dumps(dict(
        run=f"yi-6b width, {TRAIN_LAYERS} of 32 layers, bf16, remat, lb_ingest (1-process mesh)",
        n_params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=t_init,
        step_ms_median=statistics.median(step_s) * 1e3, step_ms=[t * 1e3 for t in step_s],
        step_ms_of="steps 1-3 and 8-9 (not deterministic, not profiled)",
        step_ms_deterministic=[t * 1e3 for t in det_s],
        occupancy=occ, trained_tokens_per_step=trained,
        trained_tokens_per_s=trained / statistics.median(step_s),
        processed_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(step_s),
        busy_share_of_a_step=busy / wall, profiled_step_ms=wall * 1e3, busy_ms=busy * 1e3,
        busy_measured_by="torch.profiler: the card's kernel, copy and set intervals of step 7",
        top_kernels_of_step7=top_kernels,
        ckpt_save_wait_s=t_save, ckpt_restore_s=t_restore,
        resume_equal="steps 4-6 restored from step 3 equal the live run's (both deterministic)",
        peak_mem_gb=peak_gb, state_gb_reckoned=state_gb,
        state_reckoning=f"{n_params} params x {TRAIN_STATE_BYTES_PER_PARAM} B (bf16 params "
                        "and grads, f32 m and v)",
        loss=[h["loss"] for h in embedded + resumed[-1:] + controld + eight],
        leaves_with_finite_nonzero_grad_step1=n_leaves,
        step_ms_8bit_compressed=times[12] * 1e3,
        launches={k: v for k, v in launches.items() if v}), sort_keys=True))
    import shutil
    shutil.rmtree(ROOT / "build" / "train", ignore_errors=True)
    return launches, [measured(cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                               statistics.median(step_s) * 1e3,
                               "host clock around a step that ends on the card, median of "
                               "steps 1-3 and 8-9 (LB ingest, fwd+bwd with remat, AdamW)")]


def train_phase(torch, np):
    """Training with LB ingest (repro_torch.train): the smoke config card ==
    CPU, then Yi-6B's width at 8 layers. Returns the full-width launches and
    the step's measured path."""
    t0 = time.perf_counter()
    train_smoke(torch, np)
    launches, paths = train_full(torch, np)
    say(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return launches, paths


# the Mixtral smoke config in [train_dp]: 3 microbatches of 4 rows of 12
# tokens, 3 dispatch groups of 16 tokens in each (a group takes rows in
# part), capacity factor 0.5 so that experts drop
TRAIN_DP_MOE = dict(steps=2, batch=12, seq=12, accum_steps=3, moe_dispatch_groups=3)


def train_dp_moe(torch, np, mesh):
    """The Mixtral smoke config (TRAIN_DP_MOE) through the Trainer: on
    ``jit_train_step`` over ``mesh`` (the one-rank NCCL group) on the card
    and on the one-process step on the CPU, both from one checkpoint drawn
    on the CPU; loss, grad_norm and lr within TRAIN_TOL, the occupancy and
    every MoE layer call's drops exactly equal; every ``dispatch_plan`` call
    of the card's steps held equal to plain, one a step for the ingest and
    one for each layer of each microbatch, in the forward and again in
    remat's recompute. Returns (the card's launches, the line's fields)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import _lib
    from repro_torch.testing.plans import held, recorded_drops, recorded_plans
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig

    p = TRAIN_DP_MOE
    cfg = get_smoke_config("mixtral_8x22b").with_(
        capacity_factor=0.5, moe_dispatch_groups=p["moe_dispatch_groups"])
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=True,
                        accum_steps=p["accum_steps"], q_chunk=8, k_chunk=8)
    st = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    hist, drops = {}, {}
    for dev, m in (("cuda", mesh), ("cpu", Mesh(("data",), (1,)))):
        d = _train_dir(f"dp_moe_{dev}")
        ckpt.save(str(d), 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
        tr = Trainer(cfg, tc, TrainerConfig(n_members=1, ckpt_dir=str(d), device=dev,
                                            ckpt_every=1 << 30), mesh=m)
        check((tr.specs is not None) == (dev == "cuda"),
              f"train_dp moe: the {dev} trainer's step is not the expected one")
        tr.init_or_restore(torch.Generator(device=dev).manual_seed(1))
        _lib.reset_launches()
        with recorded_plans() as calls, recorded_drops() as dr:
            tr.run(p["steps"], batch=p["batch"], seq=p["seq"])
        if dev == "cuda":
            launches, plans = dict(_lib.LAUNCHES), held(calls)
        hist[dev], drops[dev] = tr.history, dr
        del tr
    calls = p["steps"] * (1 + 2 * cfg.n_layers * p["accum_steps"])
    check(len(plans) == calls and all(q["equal"] for q in plans),
          f"train_dp moe: {len(plans)} dispatch_plan calls (want {calls}), against plain: "
          f"{plans}")
    check(launches["dispatch_plan"] == calls and launches["lb_route"] == p["steps"],
          f"train_dp moe: launches {launches}")
    check(drops["cuda"] == drops["cpu"] and sum(drops["cuda"]) > 0,
          f"train_dp moe: drops card {drops['cuda']} CPU {drops['cpu']}")
    worst = 0.0
    for a, b in zip(hist["cuda"], hist["cpu"]):
        check(a["ingest_occupancy"] == b["ingest_occupancy"],
              f"train_dp moe: occupancy differs card vs CPU: {a} {b}")
        for k in ("loss", "grad_norm", "lr"):
            err = abs(a[k] - b[k])
            check(err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(b[k]),
                  f"train_dp moe: {k} differs card vs CPU: {a[k]} {b[k]}")
            worst = max(worst, err / abs(b[k]))
    return launches, dict(
        run="mixtral smoke config (float32, capacity_factor 0.5), accum_steps "
            f"{p['accum_steps']}, moe_dispatch_groups {p['moe_dispatch_groups']}, lb_ingest: "
            "jit_train_step over the one-rank NCCL group against the CPU's one-process step",
        **p, card_equals_cpu=f"loss, grad_norm, lr within {TRAIN_TOL}; occupancy and drops "
                             "exact", worst_rel_diff=worst,
        dispatch_plan_calls_equal_to_plain=len(plans),
        dropped_per_layer_call=drops["cuda"], loss_card=[h["loss"] for h in hist["cuda"]],
        loss_cpu=[h["loss"] for h in hist["cpu"]])


def train_dp(torch, np, full_ms):
    """The data-parallel step (``jit_train_step``) over a one-rank NCCL
    process group (a FileStore under build/, no network) on
    ``make_debug_mesh(1, 1)``: Yi-6B width at TRAIN_LAYERS, from the init
    and the batches of [train]'s steps 4-6, under deterministic algorithms,
    against the one-process step on the same: loss, metrics and params bit
    for bit; lb_route and dispatch_plan launched once a step. Then 2 steps
    timed as [train] times its own (``full_ms``, its median, beside them),
    and the Mixtral smoke config's microbatches and dispatch groups over the
    same group (``train_dp_moe``). Returns the launches of the three
    deterministic steps and of the Mixtral steps."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config("yi-6b").with_(n_layers=TRAIN_LAYERS)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-4, warmup_steps=2, decay_steps=100),
                        remat=True, lb_ingest=True)
    run = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    ck = _train_dir("dp_ckpt")  # holds no checkpoint: nothing is saved

    def trainer(mesh):
        tr = Trainer(cfg, tc, TrainerConfig(ckpt_dir=str(ck), device="cuda",
                                            ckpt_every=1 << 30), mesh=mesh)
        tr.init_or_restore(torch.Generator(device="cuda").manual_seed(0))
        tr.next_event = 3 * TRAIN_BATCH  # the events of [train]'s steps 4-6
        return tr

    torch.cuda.empty_cache()
    tr = trainer(Mesh(("data",), (1,)))
    plain = _deterministic(torch, lambda: tr.run(3, **run))
    plain_params = [p.detach().cpu() for p in leaves(tr.state["params"])]
    del tr
    torch.cuda.empty_cache()

    store_dir = ROOT / "build" / "train_dp"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_dir / "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1)
        check(mesh.group is not None, "train_dp: make_debug_mesh(1, 1) bound no group")
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(mesh)
        check(tr.specs is not None, "train_dp: the trainer's step is not jit_train_step")
        times, collectives = [], []
        step = tr.step_fn

        def counted(*a):
            DP.reset_counts()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            collectives.append(dict(DP.COUNTS))
            return out

        tr.step_fn = counted
        _lib.reset_launches()
        dp_hist = _deterministic(torch, lambda: tr.run(3, **run))
        launches = dict(_lib.LAUNCHES)
        check(launches["lb_route"] == 3 and launches["dispatch_plan"] == 3,
              f"train_dp: launches over 3 steps {launches} (lb_route and dispatch_plan once "
              "a step)")
        check(dp_hist == plain, f"train_dp: the metrics differ from the one-process step's:\n"
                                f"{dp_hist}\n{plain}")
        differ = sum(not torch.equal(p.detach().cpu(), q)
                     for p, q in zip(leaves(tr.state["params"]), plain_params))
        check(differ == 0, f"train_dp: {differ} of {len(plain_params)} param leaves differ "
                           "from the one-process step's")
        dp_hist = [dict(h) for h in dp_hist]
        timed = tr.run(2, **run)[-2:]  # the trainer's history holds every step
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for h in timed:
            check(np.isfinite(h["loss"]), f"train_dp: a step's loss is not finite: {h}")
        del tr
        torch.cuda.empty_cache()
        moe_launches, moe_line = train_dp_moe(torch, np, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    shutil.rmtree(store_dir, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "train", ignore_errors=True)
    say("[train_dp] " + json.dumps(dict(
        run=f"yi-6b width, {TRAIN_LAYERS} of 32 layers, bf16, remat, lb_ingest: jit_train_step "
            "on make_debug_mesh(1, 1) over a one-rank NCCL group",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        equal_to_one_process="loss, grad_norm, lr, ce, z_loss, occupancy and every param "
                             "bit for bit after 3 deterministic steps",
        loss=[h["loss"] for h in dp_hist + timed],
        step_ms_median=statistics.median(times[3:]) * 1e3, step_ms=[t * 1e3 for t in times[3:]],
        step_ms_of="steps 4-5 (not deterministic), host clock around a step that ends on the card",
        step_ms_deterministic=[t * 1e3 for t in times[:3]],
        train_full_step_ms_median=full_ms,
        peak_mem_gb=peak_gb, collectives_per_step=collectives[0],
        launches_per_3_steps={k: v for k, v in launches.items() if v},
        moe=moe_line, phase_s=time.perf_counter() - t_phase), sort_keys=True))
    return {k: launches.get(k, 0) + moe_launches.get(k, 0) for k in {**launches, **moe_launches}}


# ---------------------------------------------------------------------------
# phase 9b: serving under the placement
# ---------------------------------------------------------------------------

# Yi-6B at published width, 8 of its 32 layers (bf16, random weights): a
# prefill of 4 x 2048 tokens, then 8 decode steps
SERVE_TP_LAYERS, SERVE_TP_BATCH, SERVE_TP_SEQ, SERVE_TP_STEPS = 8, 4, 2048, 8


def serve_tp(torch, np):
    """The placed serving step (``launch/serve_step.py``) over a one-rank
    NCCL process group (a FileStore under build/, no network) on
    ``make_debug_mesh(1, 1)``: Yi-6B width at SERVE_TP_LAYERS, params and
    decode state placed by ``serve_step.placement``, against the one-process
    ``prefill``/``decode_step`` on the same weights and tokens: the logits
    of every step and every cache leaf bit for bit; ``flash_attention``
    launched once a layer in the prefill, on ``wgmma``. Prints the prefill
    ms, the median decode step ms (each path after a warm-up run), the peak
    memory and the collectives by kind (``dp.COUNTS``, and the record of
    one more untimed run). Returns the launches of the compared placed
    run."""
    import shutil

    import torch.distributed as dist

    from repro_torch.analysis.collectives import CollectiveRecord
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch import shardspecs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.tree import flat_paths, stack

    t_phase = time.perf_counter()
    cfg = get_config("yi-6b").with_(n_layers=SERVE_TP_LAYERS)
    b, t, steps = SERVE_TP_BATCH, SERVE_TP_SEQ, SERVE_TP_STEPS
    torch.cuda.empty_cache()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (b, t), generator=g, device="cuda", dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (steps, b), generator=g, device="cuda",
                         dtype=torch.int32)
    fresh = lambda: M.init_decode_state(cfg, b, t + steps, "cuda")

    def run(prefill, decode, state):
        """The logits of the prefill and of each decode step, the final
        state, the prefill's ms and each decode step's."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(state)
        torch.cuda.synchronize()
        ms, out = [(time.perf_counter() - t0) * 1e3], [logits]
        for i in range(steps):
            t0 = time.perf_counter()
            logits, state = decode(toks[i], state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
        return out, state, ms

    with torch.no_grad():
        one_process = (lambda st: M.prefill(params, {"tokens": prompt}, st, cfg),
                       lambda tk, st: M.decode_step(params, tk, st, cfg))
        run(*one_process, fresh())  # warm-up
        plain, plain_state, plain_ms = run(*one_process, fresh())
    flat = lambda st: {k: stack(v) for k, v in flat_paths(shardspecs._as_tree(st)).items()}

    store_dir = ROOT / "build" / "serve_tp"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_dir / "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1)
        check(mesh.group is not None, "serve_tp: make_debug_mesh(1, 1) bound no group")
        specs = SS.placement(cfg, mesh, params, fresh())
        mine = shd.shard_tree(params, specs["params"], mesh)
        step = SS.ServeStep(cfg, mesh, specs, global_batch=b)
        placed = (lambda st: step.prefill(mine, {"tokens": prompt}, st),
                  lambda tk, st: step.decode(mine, tk, st))
        placed_state = lambda: shardspecs.shard_state(fresh(), specs["state"], mesh)
        run(*placed, placed_state())  # warm-up
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        DP.reset_counts()
        got, state, ms = run(*placed, placed_state())
        launches = dict(_lib.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        collectives = dict(DP.COUNTS)
        whole = shardspecs.gather_state(state, specs["state"], mesh)
        with CollectiveRecord() as rec:  # one more run, not timed
            run(*placed, placed_state())
        recorded = rec.stats().to_json()
    finally:
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    differ = [i for i, (a, p) in enumerate(zip(got, plain)) if not torch.equal(a, p)]
    check(not differ, f"serve_tp: the logits of steps {differ} differ from the one-process "
                      "step's")
    want = flat(plain_state)
    leaves_differ = [k for k, v in flat(whole).items() if not torch.equal(v, want[k])]
    check(not leaves_differ, f"serve_tp: decode-state leaves {leaves_differ} differ from the "
                             "one-process step's")
    check(launches.get("flash_attention") == cfg.n_layers
          and launches.get("flash_attention_wgmma") == cfg.n_layers,
          f"serve_tp: flash launches {launches} (once a layer in the prefill, on wgmma)")
    check(all(bool(torch.isfinite(x).all()) for x in got), "serve_tp: logits not finite")
    del params, mine, plain_state, state, whole
    torch.cuda.empty_cache()
    say("[serve_tp] " + json.dumps(dict(
        run=f"yi-6b width, {cfg.n_layers} of 32 layers, bf16, random weights: "
            "serve_step on make_debug_mesh(1, 1) over a one-rank NCCL group",
        batch=b, seq=t, decode_steps=steps,
        equal_to_one_process="the logits of the prefill and of every decode step and every "
                             "decode-state leaf bit for bit",
        prefill_ms=ms[0], decode_step_ms_median=statistics.median(ms[1:]),
        decode_step_ms=ms[1:], one_process_prefill_ms=plain_ms[0],
        one_process_decode_step_ms_median=statistics.median(plain_ms[1:]),
        ms_of="host clock around a step that ends on the card, after one warm-up run of "
              "each path",
        peak_mem_gb=peak_gb, collectives_by_kind=collectives,
        collectives_recorded=recorded["ops"],
        launches={k: v for k, v in launches.items() if v},
        phase_s=time.perf_counter() - t_phase), sort_keys=True))
    return launches


# ---------------------------------------------------------------------------
# phase 9c: training of the moe, vlm, hybrid, ssm and audio families
# ---------------------------------------------------------------------------

# the non-dense smoke configs through the Trainer with LB ingest, card
# against CPU (float32, TF32 off), RWKV6 at the reference's rwkv_chunk 1 and
# at 4; steps 1-2, a checkpoint at step 2, steps 3-4
FAMILY_TRAIN_SMOKE = [("mixtral_8x22b", {}), ("arctic_480b", {}),
                      ("llama_3_2_vision_90b", {}), ("zamba2_2_7b", {}),
                      ("rwkv6_7b", {"rwkv_chunk": 1}), ("rwkv6_7b", {"rwkv_chunk": 4}),
                      ("hubert_xlarge", {})]
FAMILY_TRAIN_SMOKE_RUN = dict(batch=8, seq=32)
# published width on one card (bf16, random weights, remat, LB ingest): the
# arch, its layers (None: all), 8-bit moments, rows x tokens a step, the
# TrainConfig's extra keywords. Mixtral's 2 of 56 layers hold 5.41e9 params
# (64.9 GB of state with f32 moments, ~33 GB with 8-bit ones); Zamba2 takes 2
# rows, not 4: its shared attention block, which neither package remats,
# keeps each of its 9 applications' chunked scores and probabilities (f32,
# B x 32 heads x 2048^2) for the backward, ~5 GB an application at 4 rows
# beside 29 GB of state; RWKV6 runs at rwkv_chunk 64 (chunk 1 is ~10x
# slower: PERF.md §5)
FAMILY_TRAIN_FULL = [("mixtral-8x22b", 2, True, 4, 2048, {}),
                     ("zamba2-2.7b", None, False, 2, 2048, {}),
                     ("rwkv6-7b", 16, False, 2, 2048, {"rwkv_chunk": 64}),
                     ("hubert-xlarge", None, False, 4, 1500, {})]
FAMILY_TRAIN_TIMED = 3  # steps after one warm-up step, then one profiled
FAMILY_TRAIN_DIR = ROOT / "build" / "train"


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _train_plans(cfg, steps) -> int:
    """dispatch_plan launches of ``steps`` training steps with LB ingest and
    remat: the ingest's pack, then each MoE layer's in the forward and
    again in remat's recompute (``models/model.py``'s checkpointed blocks)."""
    return steps * (1 + (2 * cfg.n_layers if cfg.family == "moe" else 0))


def _family_trainer(cfg, tc, ckpt_dir, device, **kw):
    """The port's Trainer on a one-process mesh (TrainerConfig ``kw``: 4
    LB members unless named), fed the vlm's vision embeddings or
    (``frames``) an encoder's frames."""
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.testing.batches import with_frames, with_vision
    from repro_torch.train.trainer import Trainer, TrainerConfig

    frames = kw.pop("frames", False)
    tr = Trainer(cfg, tc, TrainerConfig(ckpt_dir=str(ckpt_dir), device=device, **kw),
                 mesh=Mesh(("data",), (1,)))
    if cfg.family == "vlm":
        with_vision(tr)
    if frames:
        with_frames(tr)
    return tr


def family_train_smoke(torch, np):
    """Each FAMILY_TRAIN_SMOKE case through the Trainer on the card and on
    the CPU, both from one checkpoint drawn on the CPU: steps 1-2 with a
    checkpoint at step 2, then steps 3-4 (the card's under deterministic
    algorithms); loss, grad_norm and lr within TRAIN_TOL, occupancy exact;
    on the card lb_route once a step, dispatch_plan as ``_train_plans``,
    flash_attention never. Then a fresh card trainer restored from step 2
    repeats steps 3-4 exactly (metrics and every param)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _lib
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = FAMILY_TRAIN_SMOKE_RUN
    lines = []
    for arch, kw in FAMILY_TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=True,
                            q_chunk=8, k_chunk=8, **kw)
        st = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
        tag = arch + "".join(f" {k}={v}" for k, v in kw.items())
        hist, live = {}, None
        for dev in ("cuda", "cpu"):
            d = _train_dir(f"family_{arch}_{dev}")
            ckpt.save(str(d), 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
            tr = _family_trainer(cfg, tc, d, dev, ckpt_every=2)
            tr.init_or_restore(torch.Generator(device=dev).manual_seed(5))
            _lib.reset_launches()
            tr.run(2, **run)  # steps 1-2, saved at 2
            tr.cfg.ckpt_every = 1 << 30
            if dev == "cuda":
                event = tr.next_event
                _deterministic(torch, lambda: tr.run(2, **run))
                launches = dict(_lib.LAUNCHES)
                live = [p.detach().cpu() for p in leaves(tr.state["params"])]
                want = dict(lb_route=4, dispatch_plan=_train_plans(cfg, 4), flash_attention=0)
                check(all(launches[k] == v for k, v in want.items()),
                      f"[train_families] {tag}: launches over 4 steps {launches}, not {want}")
            else:
                tr.run(2, **run)
            hist[dev] = tr.history
        worst = 0.0
        for a, b in zip(hist["cuda"], hist["cpu"]):
            check(a["ingest_occupancy"] == b["ingest_occupancy"],
                  f"[train_families] {tag}: occupancy differs card vs CPU: {a} {b}")
            for k in ("loss", "grad_norm", "lr"):
                err = abs(a[k] - b[k])
                check(err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(b[k]),
                      f"[train_families] {tag}: {k} differs card vs CPU: {a[k]} {b[k]}")
                worst = max(worst, err / abs(b[k]))
        tr2 = _family_trainer(cfg, tc, FAMILY_TRAIN_DIR / f"family_{arch}_cuda", "cuda",
                              ckpt_every=1 << 30)
        step = tr2.init_or_restore(torch.Generator(device="cuda").manual_seed(9))
        check(step == 2, f"[train_families] {tag}: restored step {step}, not 2")
        tr2.next_event = event  # event numbers are not checkpointed (nor in the reference)
        resumed = _deterministic(torch, lambda: tr2.run(2, **run))
        check(resumed == hist["cuda"][2:],
              f"[train_families] {tag}: the resume from step 2 differs:\n{resumed}\n"
              f"{hist['cuda'][2:]}")
        differ = sum(not torch.equal(p.detach().cpu(), q)
                     for p, q in zip(leaves(tr2.state["params"]), live))
        check(differ == 0, f"[train_families] {tag}: {differ} of {len(live)} param leaves "
                           "differ after the resume")
        lines.append(dict(config=tag, worst_rel_diff=worst,
                          occupancy=[h["ingest_occupancy"] for h in hist["cuda"]],
                          loss_card=[h["loss"] for h in hist["cuda"]],
                          loss_cpu=[h["loss"] for h in hist["cpu"]],
                          launches_card={k: v for k, v in launches.items() if v}))
    say("[train_families] " + json.dumps(dict(
        run="the non-dense smoke configs (float32, TF32 off) through the Trainer with LB "
            f"ingest, {run['batch']} x {run['seq']} tokens a step, card and CPU from one "
            "checkpoint drawn on the CPU",
        card_equals_cpu=f"loss, grad_norm, lr within {TRAIN_TOL}; occupancy exact; 4 steps",
        resume="a fresh card trainer restored from step 2: steps 3-4 metrics and every param "
               "equal the live run's (both deterministic)",
        configs=lines), sort_keys=True))


def _reckoned_state(n_params, leaf_sizes, eight_bit) -> float:
    """Bytes of bf16 params and grads and of the moments: f32, or int8
    with a float32 scale per row (its last dim) when ``eight_bit``."""
    if not eight_bit:
        return n_params * TRAIN_STATE_BYTES_PER_PARAM
    return n_params * (2 + 2 + 2) + sum(2 * 4 * n // last for n, last in leaf_sizes)


def family_train_full(torch, np, arch, layers, eight_bit, rows, seq, kw):
    """One family at published width, ``layers`` of its depth (None: all;
    bf16, random weights, remat, LB ingest on a one-process mesh, one LB
    member): step 1
    (the warm-up) with every leaf's gradient checked finite and non-zero
    (HuBERT's token table exempt: the encoder reads frame embeddings, so
    its gradient is zero by design in both packages), FAMILY_TRAIN_TIMED
    timed steps, one step under torch.profiler; every loss and grad_norm
    finite; lb_route once a step, dispatch_plan as ``_train_plans``,
    flash_attention never. A MoE model's step 1 also holds every
    dispatch_plan call of the step (the ingest's pack, each layer's in the
    forward and in remat's recompute, at the training pack's shape) exactly
    equal to plain (pos, counts), and its first MoE layer at the step's
    rows x tokens goes through ``moe_layer_check``. Returns (its launches,
    its measured path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.testing.plans import held, recorded_plans
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = full.with_(n_layers=layers) if layers else full
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-4, warmup_steps=2, decay_steps=100,
                                            eight_bit=eight_bit), remat=True, lb_ingest=True,
                        **kw)
    frames = cfg.family == "audio"
    times = []
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # one LB member, the card's one data rank: every event is its own
    # (occupancy 1), where [train] keeps the trainer's 4 members' quarter
    tr = _timed_steps(torch, _family_trainer(cfg, tc, _train_dir("family_full"), "cuda",
                                             n_members=1, ckpt_every=1 << 30, frames=frames),
                      times)
    tr.init_or_restore(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    params = leaves(tr.state["params"])
    n_params = sum(p.numel() for p in params)
    exempt = [i for i, p in enumerate(params) if frames and p is tr.state["params"]["embed"]]
    run = dict(batch=rows, seq=seq)
    _lib.reset_launches()
    with recorded_plans() as calls:
        n_leaves = _checked_step(torch, tr, run, f"[train_families] {cfg.name}: step 1", exempt)
    plans = held(calls)
    check(len(plans) == _train_plans(cfg, 1) and all(p["equal"] for p in plans),
          f"[train_families] {cfg.name}: step 1's dispatch_plan calls against plain: {plans}")
    moe_pack = plans[1:]  # after the ingest's: each MoE layer's, forward and recompute
    check(all(p["n"] == cfg.top_k * rows * seq and p["n_members"] == cfg.n_experts
              for p in moe_pack),
          f"[train_families] {cfg.name}: a MoE pack not at the step's shape: {moe_pack}")
    tr.run(FAMILY_TRAIN_TIMED, **run)
    t_prof = time.perf_counter()
    wall, busy, top = _profiled_kernels(torch, lambda: tr.run(1, **run))
    t_prof = time.perf_counter() - t_prof
    hist = tr.history  # every step's
    steps = 2 + FAMILY_TRAIN_TIMED
    launches = dict(_lib.LAUNCHES)
    want = dict(lb_route=steps, dispatch_plan=_train_plans(cfg, steps), flash_attention=0)
    check(all(launches[k] == v for k, v in want.items()),
          f"[train_families] {cfg.name}: launches over {steps} steps {launches}, not {want}")
    for h in hist:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"[train_families] {cfg.name}: a step's loss or grad_norm is not finite: {h}")
    check(int(tr.state["step"]) == steps, f"[train_families] step {int(tr.state['step'])}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sizes = [(p.numel(), p.shape[-1]) for p in params]
    state_gb = _reckoned_state(n_params, sizes, eight_bit) / 1e9
    layer = (moe_layer_check(torch, cfg, tr.state["params"]["layers"][0]["moe"], (rows, seq),
                             "[train_families]") if cfg.family == "moe" else None)
    del tr, params
    _free(torch)
    step_s = times[1:1 + FAMILY_TRAIN_TIMED]
    med = statistics.median(step_s)
    occ = [h["ingest_occupancy"] for h in hist]
    labelled = seq - 1 if cfg.causal else seq  # an encoder's labels are not shifted
    trained = statistics.median(occ[1:1 + FAMILY_TRAIN_TIMED]) * rows * labelled
    cuts = {"layers": f"{cfg.n_layers} of {full.n_layers}" if layers else "all",
            "moments": "8-bit (int8, a float32 scale a row)" if eight_bit else "float32",
            "rows": f"{rows} x {seq} {'frames' if frames else 'tokens'}",
            "lb_members": "1 (the card's one data rank: occupancy 1)"}
    say("[train_families] " + json.dumps(dict(
        model=cfg.name, family=cfg.family, published_width=True, cuts=cuts,
        n_layers=cfg.n_layers, n_params=n_params, batch=rows, seq=seq,
        train_kw=kw, init_s=t_init, state_gb_reckoned=state_gb, peak_mem_gb=peak_gb,
        run_s=time.perf_counter() - t0, profiled_step_with_its_reading_s=t_prof,
        step_ms_median=med * 1e3, step_ms=[t * 1e3 for t in step_s],
        step_ms_warmup=times[0] * 1e3,
        step_ms_of=f"steps 2-{1 + FAMILY_TRAIN_TIMED}, host clock around a step that ends on "
                   "the card",
        occupancy=occ, trained_tokens_per_step=trained, trained_tokens_per_s=trained / med,
        processed_tokens_per_s=rows * seq / med,
        busy_share_of_a_step=busy / wall, profiled_step_ms=wall * 1e3, busy_ms=busy * 1e3,
        busy_measured_by=f"torch.profiler: the card's kernel, copy and set intervals of step "
                         f"{steps}", top_kernels=top,
        loss=[h["loss"] for h in hist],
        leaves_with_finite_nonzero_grad_step1=n_leaves - len(exempt),
        dispatch_plan_step1_equal_to_plain=[(p["n"], p["n_members"]) for p in plans],
        moe_layer_check=layer,
        grad_exempt=("embed (the token table: frames in, zero gradient by design)"
                     if exempt else None),
        launches={k: v for k, v in launches.items() if v}), sort_keys=True))
    return launches, measured(cfg, "train", rows, seq, med * 1e3,
                              f"host clock around a step that ends on the card, median of "
                              f"steps 2-{1 + FAMILY_TRAIN_TIMED} (LB ingest, fwd+bwd with "
                              "remat, AdamW)", eight_bit_opt=eight_bit)


def train_families(torch, np):
    """Training of the moe, vlm, hybrid, ssm and audio families, after the
    earlier phases' tensors are freed: the smoke configs card == CPU with a
    resume each, then FAMILY_TRAIN_FULL at published width. Returns (the
    full-width runs' launches, summed; their measured paths)."""
    t0 = time.perf_counter()
    _free(torch)
    family_train_smoke(torch, np)
    launches, paths = {}, []
    for case in FAMILY_TRAIN_FULL:
        got, path = family_train_full(torch, np, *case)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        paths.append(path)
    import shutil
    shutil.rmtree(FAMILY_TRAIN_DIR, ignore_errors=True)
    say(f"[train_families] phase {time.perf_counter() - t0:.1f} s")
    return launches, paths


# ---------------------------------------------------------------------------
# phase 10: the MoE family
# ---------------------------------------------------------------------------

# Mixtral-8x22B at published width, 8 of its 56 layers (20.4 B params, 40.9
# GB in bf16): 2 replicas x 4 slots, 8192-token contexts (a 4096-slot ring,
# its sliding window); 12 prompts of 256-4000 tokens and one past the window
MIXTRAL_LAYERS = 8
MOE_SERVE = dict(n_replicas=2, lane_bits=2, max_len=8192, rebalance_every=4)
MOE_LONG_PROMPT = 4500
# Arctic at published width, 2 of its 35 layers (55.4 GB; 1 layer when the
# card's free memory cannot hold 2 beside the caches): 4 requests
ARCTIC_LAYERS, ARCTIC_REQUESTS = 2, 4
# its layer check's rows x tokens: the training step's (4 x 2048, top-2:
# 16,384 packets over 128 experts)
ARCTIC_TRAIN_PACK = (TRAIN_BATCH, TRAIN_SEQ)
ARCTIC_SERVE = dict(n_replicas=2, lane_bits=1, max_len=2048, rebalance_every=4)
# the pack's shapes: a prefill of 4000 tokens (8000 k-major packets) over
# Mixtral's 8 experts and over Arctic's 128, a decode step of 4 lanes (8
# packets); the full-width layer check's tokens
MOE_PREFILL_T, MOE_DECODE_T, MOE_LAYER_T = 4000, 4, 512
MIXTRAL_FLASH_T = 4096


def _moe_members(torch, np, rng, n_tokens, n_experts, top_k=2):
    """k-major expert choices of ``n_tokens`` tokens as the pack takes them
    (one group), from a skewed router: a few experts take most tokens."""
    p = rng.dirichlet(np.full(n_experts, 0.3))
    idx = np.stack([rng.choice(n_experts, top_k, replace=False, p=p)
                    for _ in range(n_tokens)])
    return torch.from_numpy(idx.T.reshape(-1).astype(np.int32)).cuda()


def moe_kernels(torch, np):
    """dispatch_plan at the MoE path's shapes, exactly equal to plain (pos,
    counts), also after the timing's graph replays, timed with its inputs in
    L2 as the path leaves them (``time_warm``) beside its bound and the
    plain version; flash_attention timed at Mixtral's longest in-window
    prefill (48/8 heads, T = its 4096-token window; ``flash_phase`` holds
    it against plain) beside SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import dispatch_plan
    from repro_torch.kernels.flash_attention import _design

    rng = np.random.default_rng(23)
    plans = {}
    for name, n_tokens, e in (("mixtral_prefill", MOE_PREFILL_T, 8),
                              ("mixtral_decode", MOE_DECODE_T, 8),
                              ("arctic_prefill", MOE_PREFILL_T, 128)):
        member = _moe_members(torch, np, rng, n_tokens, e)
        n = member.numel()
        got = dispatch_plan(member, n_members=e)
        want = ref.dispatch_plan_ref(member, n_members=e)
        check_equal(torch, f"dispatch_plan {name} N={n} n_members={e}", got, want)
        t_k, last = time_warm(torch, lambda: dispatch_plan(member, n_members=e))
        check_equal(torch, f"dispatch_plan {name} after graph replays", last, want)
        t_p, _ = time_warm(torch, lambda: ref.dispatch_plan_ref(member, n_members=e))
        b_ms, b_by = bound(n * 8 + e * 4, n * 20)
        plans[name] = dict(n=n, n_members=e, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=max_err(got, want),
                           timing="graphs of 200 calls, inputs in L2")
        say(f"[moe] dispatch_plan {name}: N={n} packets over {e} experts, equal to plain "
            f"(pos, counts), also after graph replays; kernel {t_k * 1e3:.3f} us, plain "
            f"{t_p * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by})")

    mk = lambda h: torch.from_numpy(rng.standard_normal(
        (1, MIXTRAL_FLASH_T, h, 128), dtype=np.float32)).to("cuda", torch.bfloat16)
    q, k, v = mk(48), mk(8), mk(8)
    design = _design(q.dtype, q.shape[-1])
    check(design == "wgmma", f"Mixtral's prefill shape chose the {design} design")
    flash = dict(flash_times(torch, q, k, v, "[moe]"), design=design)
    return plans, flash


def moe_layer_check(torch, cfg, moe_params, shape=(1, MOE_LAYER_T), tag="[moe]"):
    """One MoE layer at full width (bf16, ``shape`` rows x tokens, one
    dispatch group): ``moe_ffn`` with its positions from the kernel (one
    launch, its (pos, counts) exactly equal to the plain version's on the
    same k-major members) against the same function with the plain
    version's positions: the output bit for bit, the drop count and the aux
    loss equal."""
    from repro_torch.kernels import _lib, dispatch as disp, ref
    from repro_torch.models import moe as MOE
    from repro_torch.testing.plans import held, recorded_plans

    n_tokens = shape[0] * shape[1]
    x = torch.randn(tuple(shape) + (cfg.d_model,), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)).bfloat16()
    before = _lib.LAUNCHES["dispatch_plan"]
    with torch.no_grad(), recorded_plans() as calls:
        y, aux = MOE.moe_ffn(moe_params, x, cfg)
    check(_lib.LAUNCHES["dispatch_plan"] == before + 1 and len(calls) == 1,
          f"{tag} the full-width MoE layer did not launch dispatch_plan once")
    plan = held(calls)[0]
    check(plan["equal"] and plan["n"] == cfg.top_k * n_tokens
          and plan["n_members"] == cfg.n_experts,
          f"{tag} {cfg.name}'s pack of {cfg.top_k} x {n_tokens} packets over "
          f"{cfg.n_experts} experts differs from plain (pos, counts): {plan}")
    orig = disp.dispatch_plan
    disp.dispatch_plan = ref.dispatch_plan_ref
    try:
        with torch.no_grad():
            y_p, aux_p = MOE.moe_ffn(moe_params, x, cfg)
    finally:
        disp.dispatch_plan = orig
    check(_lib.LAUNCHES["dispatch_plan"] == before + 1,
          f"{tag} the plain positions launched the kernel")
    check(bool(torch.isfinite(y).all()), f"{tag} the full-width MoE layer gave non-finite values")
    check(torch.equal(y, y_p), f"{tag} the full-width MoE layer differs between the kernel's "
                               f"and the plain positions: max |diff| {(y - y_p).abs().max()}")
    check(int(aux["dropped"]) == int(aux_p["dropped"]) and torch.equal(
        aux["aux_loss"], aux_p["aux_loss"]), f"{tag} the MoE layer's drops or aux loss differ")
    line = dict(rows=shape[0], tokens=shape[1], packets=plan["n"], experts=cfg.n_experts,
                dropped=int(aux["dropped"]), aux_loss=float(aux["aux_loss"]),
                pack_equal_to_plain=True, bit_equal=True)
    say(f"{tag} one {cfg.name} MoE layer at full width (bf16, {shape[0]} x {shape[1]} tokens): "
        f"the pack of {plan['n']} packets over {cfg.n_experts} experts == plain (pos, counts); "
        f"output from the kernel's positions == from plain bit for bit, dropped "
        f"{line['dropped']} of {plan['n']} equal, aux loss equal")
    return line


def _moe_forward_checks(cfg, eng, launches, tag):
    """dispatch_plan once per layer in every forward step of the run: each
    prefill (``prefill_plans``) and each replica's decode step."""
    for (n, _, _), plans in zip(eng.prefills, eng.prefill_plans):
        check(plans == cfg.n_layers,
              f"{tag} prefill of {n} tokens launched dispatch_plan {plans} times")
    steps = sum(len(v) for v in eng.decode_s.values())
    check(launches["dispatch_plan"] == cfg.n_layers * (len(eng.prefills) + steps),
          f"{tag} dispatch_plan launched {launches['dispatch_plan']} times over "
          f"{len(eng.prefills)} prefills and {steps} decode steps of {cfg.n_layers} layers")
    return steps


def mixtral_serve(torch, np):
    """Mixtral-8x22B at published width, MIXTRAL_LAYERS of its 56 layers,
    served with a drain; the share of its longest in-window prefill taken by
    flash_attention, the expert products and dispatch_plan. Returns (the
    serving run's launches, the measured paths)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch as disp, flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=MIXTRAL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = []
    M.tree_map(lambda w: sizes.append(w.numel()), params)
    # ModelConfig.param_count leaves out the final norm's d_model scales
    check(sum(sizes) == cfg.param_count()[0] + cfg.d_model,
          f"{sum(sizes)} params drawn, the config counts {cfg.param_count()[0]}")
    layer = moe_layer_check(torch, cfg, params["layers"][0]["moe"])

    rng = np.random.default_rng(1)
    lens = np.append(rng.integers(256, 4001, N_REQUESTS), MOE_LONG_PROMPT)
    eng, reqs, run = serve_with_drain(torch, np, cfg, params, MOE_SERVE, lens, rng, "[moe]")
    launches = run["launches"]
    steps = _moe_forward_checks(cfg, eng, launches, "[moe]")
    check(any(n > cfg.swa_window for n, _, _ in eng.prefills),
          "no prompt went past the sliding window")

    inside = [r for r in reqs if len(r.prompt) <= cfg.swa_window]
    longest = max(inside, key=lambda r: len(r.prompt)).prompt
    per, p_ms, res = prefill_spans(
        torch, M, cfg, params, longest, MOE_SERVE["max_len"],
        {"flash_attention": (fa, "flash_attention"),
         "expert_products": (MOE, "expert_products"),
         "dispatch_plan": (disp, "dispatch_plan"),
         "moe_ffn": (MOE, "moe_ffn")})
    for name in ("flash_attention", "expert_products", "dispatch_plan"):
        check(per[name][1] == cfg.n_layers,
              f"the profiled prefill called {name} {per[name][1]} times")
    dropped = sum(int(aux["dropped"]) for _, aux in res["moe_ffn"])
    decode = decode_profile(torch, M, cfg, params, eng.states[0])
    line = serve_line(
        cfg, eng, reqs, run, MOE_SERVE, n_params=sum(sizes), init_s=t_init,
        dispatch_plan_launches=launches["dispatch_plan"], decode_steps_total=steps,
        long_prompt=MOE_LONG_PROMPT, full_width_layer=layer,
        share_prefill_tokens=len(longest), share_prefill_ms=p_ms,
        share_method="CUDA events around each call and around the whole prefill",
        **{f"{name}_share_of_prefill": per[name][0] / p_ms
           for name in ("flash_attention", "expert_products", "dispatch_plan")},
        **{f"{name}_ms_in_prefill": per[name][0]
           for name in ("flash_attention", "expert_products", "dispatch_plan", "moe_ffn")},
        share_prefill_dropped=dropped,
        share_prefill_assignments=cfg.n_layers * cfg.top_k * len(longest), **decode,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[moe] " + json.dumps(line, sort_keys=True))
    return launches, [
        measured(cfg, "prefill", 1, len(longest), p_ms, "CUDA events around one prefill"),
        decode_measured(cfg, eng.states[0], MOE_SERVE["max_len"], decode)]


def arctic_serve(torch, np):
    """Arctic at published width, ARCTIC_LAYERS of its 35 layers (1 when the
    card's free memory cannot hold 2 beside the caches): 128 experts and the
    dense residual, ARCTIC_REQUESTS requests."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig

    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=ARCTIC_LAYERS)
    free, _total = torch.cuda.mem_get_info()
    need = 2 * cfg.param_count()[0]
    if need + (4 << 30) > free:
        say(f"[moe] arctic at {ARCTIC_LAYERS} layers needs {need / 1e9:.1f} GB of weights, "
            f"the card has {free / 1e9:.1f} GB free: 1 layer")
        cfg = dataclasses.replace(cfg, n_layers=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng = _observed_engine(torch)(cfg, ServeConfig(device="cuda", **ARCTIC_SERVE), params)
    rng = np.random.default_rng(2)
    _lib.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=MAX_NEW)
            for n in rng.integers(256, 2001, ARCTIC_REQUESTS)]
    eng.run_until_done()
    torch.cuda.synchronize()
    run = dict(wall_s=time.perf_counter() - t0, launches=dict(_lib.LAUNCHES))
    serving_gates(cfg, eng, reqs, run["launches"], "[moe] arctic:")
    steps = _moe_forward_checks(cfg, eng, run["launches"], "[moe] arctic:")
    line = serve_line(
        cfg, eng, reqs, run, ARCTIC_SERVE, n_params=cfg.param_count()[0] + cfg.d_model,
        init_s=t_init, dispatch_plan_launches=run["launches"]["dispatch_plan"],
        decode_steps_total=steps, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    # the 128-expert pack at the training step's shape (scripts/train_dp_torch.py
    # trains Arctic on four cards over these rows)
    line["layer_check_training_pack"] = moe_layer_check(
        torch, cfg, params["layers"][0]["moe"], ARCTIC_TRAIN_PACK, "[moe] arctic:")
    say("[moe] " + json.dumps(line, sort_keys=True))
    return run["launches"]


def moe_phase(torch, np):
    """The MoE family: the Mixtral smoke config served card == CPU; the
    pack's kernel at the family's shapes; Mixtral-8x22B (8 layers) and
    Arctic (2 layers) at published width served on the card. Earlier
    phases' tensors are freed first. Returns (the main-path launches of the
    two full-width serving runs, summed; the kernel rows' MoE numbers;
    Mixtral's measured paths)."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    small_serve(torch, np, arch="mixtral_8x22b", tag="[moe]")
    plans, flash = moe_kernels(torch, np)
    launches, paths = mixtral_serve(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in arctic_serve(torch, np).items():
        launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[moe] phase {time.perf_counter() - t0:.1f} s")
    return launches, plans, flash, paths


# ---------------------------------------------------------------------------
# phase 11: the vlm, audio, hybrid and ssm families
# ---------------------------------------------------------------------------

FAMILY_TOL = dict(rtol=2e-4, atol=2e-4)  # float32 on both, TF32 off: reassociation only
# Llama-3.2-Vision-90B at published width, 20 of its 100 layers (2 groups of 9
# self and 1 cross layer; 19.2 B params, 38.4 GB in bf16): a 2048-token
# prefill of 4 lanes, each with its own 1601 vision tokens, and 32 decode
# steps reusing them; a 4000-token prefill of one lane
VISION_LAYERS = 20
VISION_LANES, VISION_PREFILL_T, VISION_LONG_T, VISION_DECODE_STEPS = 4, 2048, 4000, 32
# Zamba2-2.7B and RWKV6-7B at full depth and width behind the LB front door
ZAMBA_SERVE = dict(n_replicas=2, lane_bits=2, max_len=8192, rebalance_every=4)
RWKV_SERVE = dict(n_replicas=2, lane_bits=2, max_len=2048, rebalance_every=4)
RWKV_REQUESTS, RWKV_LENS = 8, (128, 1025)
RWKV_PREFILL_T, RWKV_CHUNKS = 2048, (1, 64)
# HuBERT-XLarge's encoder over 4 clips of 30 s (50 frames/s)
HUBERT_CLIPS, HUBERT_FRAMES = 4, 1500
# the families' prefill shapes of flash_attention: Zamba2's shared block
# (B=1, T=4096, 32/32 heads, d=80), Llama-3.2-Vision's self layers (64/8
# heads, d=128), both on the wgmma design
FAMILY_FLASH = {"zamba2_prefill": (4096, 32, 32, 80, "wgmma"),
                "llama_vision_prefill": (4096, 64, 8, 128, "wgmma")}


def _n_params(M, params) -> int:
    sizes = []
    M.tree_map(lambda w: sizes.append(w.numel()), params)
    return sum(sizes)


def families_small(torch, np):
    """The four smoke configs (fp32, TF32 off) on the card and on the CPU
    from one set of weights: HuBERT's forward logits, Llama-Vision's prefill
    (with vision tokens) and 4 decode steps, within rtol/atol 2e-4; Zamba2
    and RWKV6 served at 2 replicas x 4 slots with the same routes, tokens
    and stats."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(31)
    for arch in ("hubert_xlarge", "llama_3_2_vision_90b"):
        cfg = get_smoke_config(arch)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        out = {}
        if cfg.family == "audio":
            embeds = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model), np.float32))
            for dev in ("cuda", "cpu"):
                logits, _ = M.forward(M.to_device(params, dev), {"embeds": embeds.to(dev)},
                                      cfg, remat=False)
                out[dev] = [logits.cpu()]
            what = "forward logits [2, 24, V]"
        else:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 15)).astype(np.int32))
            vision = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_vision_tokens, cfg.d_model), np.float32))
            for dev in ("cuda", "cpu"):
                p = M.to_device(params, dev)
                st = M.init_decode_state(cfg, 2, 32, device=dev)
                logits, st = M.prefill(p, {"tokens": toks[:, :11].to(dev),
                                           "vision_embeds": vision.to(dev)}, st, cfg)
                got = [logits]
                for i in range(11, 15):
                    logits, st = M.decode_step(p, toks[:, i].to(dev), st, cfg)
                    got.append(logits)
                out[dev] = [g.cpu() for g in got]
            what = "prefill (11 tokens, 16 vision tokens) and 4 decode steps' logits"
        errs = [float((g - w).abs().max()) for g, w in zip(out["cuda"], out["cpu"])]
        check(all(torch.allclose(g, w, **FAMILY_TOL) for g, w in zip(out["cuda"], out["cpu"])),
              f"[families] {cfg.name}: card differs from the CPU (max |diff| {errs})")
        say(f"[families] {cfg.name} (fp32): {what} card == CPU within rtol/atol 2e-4 "
            f"(max |diff| {max(errs):.3g})")
    for arch in ("zamba2_2_7b", "rwkv6_7b"):
        small_serve(torch, np, arch=arch, tag="[families]", lane_bits=2)


def families_flash(torch, np):
    """flash_attention at the families' prefill shapes against its plain
    version (bf16 atol 5e-3, rtol 2e-2; causal and not), each on the design
    its config takes, and timed beside plain and SDPA."""
    from repro_torch.kernels.flash_attention import _design

    rng = np.random.default_rng(37)
    rows = {}
    for name, (t, hq, hkv, d, want) in FAMILY_FLASH.items():
        mk = lambda h: torch.from_numpy(rng.standard_normal(
            (1, t, h, d), dtype=np.float32)).to("cuda", torch.bfloat16)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        check(_design(q.dtype, d) == want, f"{name}: the {_design(q.dtype, d)} design chosen")
        err = max(flash_compare(torch, q, k, v, causal, 5e-3, 2e-2,
                                f"{name} bf16 B=1 T={t} {hq}/{hkv} heads d={d} "
                                f"{'causal' if causal else 'non-causal'}", tag="[families]")
                  for causal in (True, False))
        rows[name] = dict(flash_times(torch, q, k, v, "[families]"), design=want,
                          max_abs_err=err)
        del q, k, v
    return rows


def vision_run(torch, np):
    """Llama-3.2-Vision-90B at published width, VISION_LAYERS of its 100
    layers: a prefill of 4 lanes (each its own vision tokens) and decode
    steps that reuse the stored vision tokens; a long one-lane prefill with
    the cross layers' share. flash_attention launches once per self layer
    per prefill (wgmma), never in a decode step. Returns the launches of the
    two prefills and the decode steps, and the measured paths."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"), n_layers=VISION_LAYERS)
    n_self = attention_layers(cfg)
    check(flash_design(cfg) == "wgmma", f"{cfg.name} takes the {flash_design(cfg)} design")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = _n_params(M, params)
    # ModelConfig.param_count leaves out the final norm's d_model scales
    check(n_params == cfg.param_count()[0] + cfg.d_model,
          f"{n_params} params drawn, the config counts {cfg.param_count()[0]}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    vision = torch.randn((VISION_LANES, cfg.n_vision_tokens, cfg.d_model), device="cuda",
                         generator=gen).bfloat16()
    toks = torch.randint(0, cfg.vocab, (VISION_LANES, VISION_PREFILL_T + VISION_DECODE_STEPS),
                         device="cuda", generator=gen, dtype=torch.int32)
    state = M.init_decode_state(cfg, VISION_LANES, VISION_PREFILL_T + VISION_DECODE_STEPS + 8,
                                "cuda")
    ev = lambda: torch.cuda.Event(enable_timing=True)
    _lib.reset_launches()
    torch.cuda.synchronize()
    a, b, h0 = ev(), ev(), time.perf_counter()
    a.record()
    logits, state = M.prefill(params, {"tokens": toks[:, :VISION_PREFILL_T],
                                       "vision_embeds": vision}, state, cfg)
    b.record()
    b.synchronize()
    prefill_host_ms = (time.perf_counter() - h0) * 1e3
    prefill_ms = a.elapsed_time(b)
    check(_lib.LAUNCHES["flash_attention"] == n_self
          and _lib.LAUNCHES["flash_attention_wgmma"] == n_self,
          f"the {VISION_LANES}-lane prefill launched flash_attention "
          f"{_lib.LAUNCHES['flash_attention']} times ({_lib.LAUNCHES['flash_attention_wgmma']} "
          f"wgmma), not once per self layer ({n_self})")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (VISION_LANES, cfg.vocab),
          "the vision prefill's logits are not finite")
    check(state["vision"] is not None and state["vision"].shape == vision.shape,
          "the prefill did not store the vision tokens")
    step_ms = []
    for i in range(VISION_DECODE_STEPS):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        logits, state = M.decode_step(params, toks[:, VISION_PREFILL_T + i], state, cfg)
        finite = bool(torch.isfinite(logits).all())  # ends when the step has
        step_ms.append((time.perf_counter() - h0) * 1e3)
        check(finite, f"decode step {i} gave non-finite logits")
    launches = dict(_lib.LAUNCHES)
    check(launches["flash_attention"] == n_self, "a decode step launched flash_attention")
    check(torch.equal(state["pos"].cpu(), torch.full((VISION_LANES,),
                                                     VISION_PREFILL_T + VISION_DECODE_STEPS,
                                                     dtype=torch.int32)),
          "the lanes' positions did not advance")
    decode = decode_profile(torch, M, cfg, params, state)

    long = np.random.default_rng(6).integers(0, cfg.vocab, VISION_LONG_T)
    before = dict(_lib.LAUNCHES)
    per, p_ms, _ = prefill_spans(torch, M, cfg, params, long, VISION_LONG_T + 8,
                                 {"cross_block": (M, "_cross_block"),
                                  "flash_attention": (fa, "flash_attention")},
                                 extra={"vision_embeds": vision[:1]})
    check(per["flash_attention"][1] == n_self and per["cross_block"][1] == cfg.n_layers - n_self,
          f"the long prefill called flash_attention {per['flash_attention'][1]} and the cross "
          f"layers {per['cross_block'][1]} times")
    check(_lib.LAUNCHES["flash_attention_wgmma"] - before["flash_attention_wgmma"] == n_self,
          "the long prefill's flash_attention did not run the wgmma design")
    for k in launches:
        launches[k] = _lib.LAUNCHES[k]
    line = dict(
        model=cfg.name, n_layers=cfg.n_layers, self_layers=n_self,
        cross_layers=cfg.n_layers - n_self, dtype=cfg.dtype, n_params=n_params, init_s=t_init,
        vision_tokens=cfg.n_vision_tokens, lanes=VISION_LANES, prefill_tokens=VISION_PREFILL_T,
        prefill_ms=prefill_ms, prefill_host_ms=prefill_host_ms,
        prefill_tokens_per_s=VISION_LANES * VISION_PREFILL_T / prefill_ms * 1e3,
        decode_steps=VISION_DECODE_STEPS, decode_step_ms_median=statistics.median(step_ms),
        decode_step_ms_max=max(step_ms), **decode,
        long_prefill_tokens=VISION_LONG_T, long_prefill_ms=p_ms,
        cross_share_of_long_prefill=per["cross_block"][0] / p_ms,
        flash_share_of_long_prefill=per["flash_attention"][0] / p_ms,
        share_method="CUDA events around each cross block, each flash_attention launch "
                     "and the whole prefill",
        flash_launches=launches["flash_attention"],
        flash_wgmma_launches=launches["flash_attention_wgmma"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[families] " + json.dumps(line, sort_keys=True))
    return launches, [
        measured(cfg, "prefill", VISION_LANES, VISION_PREFILL_T, prefill_ms,
                 "CUDA events around one prefill"),
        measured(cfg, "prefill", 1, VISION_LONG_T, p_ms, "CUDA events around one prefill"),
        decode_measured(cfg, state, VISION_PREFILL_T + VISION_DECODE_STEPS + 8, decode)]


def zamba_serve(torch, np):
    """Zamba2-2.7B at full depth and width served with a drain; the Mamba2
    blocks' and flash_attention's shares of its longest prefill. Returns
    (the serving run's launches, the measured paths)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as M

    cfg = get_config("zamba2-2.7b")
    check(flash_design(cfg) == "wgmma", f"{cfg.name} takes the {flash_design(cfg)} design")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    lens = rng.integers(256, 4001, N_REQUESTS)
    eng, reqs, run = serve_with_drain(torch, np, cfg, params, ZAMBA_SERVE, lens, rng,
                                      "[families]")
    longest = max(reqs, key=lambda r: len(r.prompt)).prompt
    per, p_ms, _ = prefill_spans(torch, M, cfg, params, longest, ZAMBA_SERVE["max_len"],
                                 {"mamba2_block": (M2, "mamba2_block"),
                                  "flash_attention": (fa, "flash_attention")})
    check(per["mamba2_block"][1] == cfg.n_layers
          and per["flash_attention"][1] == attention_layers(cfg),
          f"the profiled prefill called mamba2_block {per['mamba2_block'][1]} and "
          f"flash_attention {per['flash_attention'][1]} times")
    decode = decode_profile(torch, M, cfg, params, eng.states[0])
    line = serve_line(
        cfg, eng, reqs, run, ZAMBA_SERVE, n_params=_n_params(M, params), init_s=t_init,
        attention_applications=attention_layers(cfg), flash_design="wgmma",
        share_prefill_tokens=len(longest), share_prefill_ms=p_ms,
        mamba2_share_of_prefill=per["mamba2_block"][0] / p_ms,
        flash_share_of_prefill=per["flash_attention"][0] / p_ms,
        share_method="CUDA events around each call and around the whole prefill",
        **decode, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[families] " + json.dumps(line, sort_keys=True))
    return run["launches"], [
        measured(cfg, "prefill", 1, len(longest), p_ms, "CUDA events around one prefill"),
        decode_measured(cfg, eng.states[0], ZAMBA_SERVE["max_len"], decode)]


def rwkv_serve(torch, np):
    """RWKV6-7B at full depth and width served with a drain (the engine's
    prefill takes the per-token scan, the reference's default); then one
    model-level prefill of RWKV_PREFILL_T tokens at each of RWKV_CHUNKS.
    Returns (the serving run's launches, the measured paths)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("rwkv6-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    lens = rng.integers(*RWKV_LENS, RWKV_REQUESTS)
    eng, reqs, run = serve_with_drain(torch, np, cfg, params, RWKV_SERVE, lens, rng,
                                      "[families]", drain_lens=RWKV_LENS)
    check(run["launches"]["flash_attention"] == 0, "the ssm family launched flash_attention")
    decode = decode_profile(torch, M, cfg, params, eng.states[0])

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, RWKV_PREFILL_T))).cuda()
    chunks, logits = {}, {}
    for chunk in RWKV_CHUNKS:
        state = M.init_decode_state(cfg, 1, RWKV_PREFILL_T, "cuda")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        a.record()
        logits[chunk], _ = M.prefill(params, {"tokens": toks}, state, cfg, rwkv_chunk=chunk)
        b.record()
        b.synchronize()
        chunks[chunk] = dict(ms=a.elapsed_time(b), host_ms=(time.perf_counter() - h0) * 1e3)
        check(bool(torch.isfinite(logits[chunk]).all()),
              f"the rwkv_chunk={chunk} prefill gave non-finite logits")
    lo, hi = RWKV_CHUNKS
    line = serve_line(
        cfg, eng, reqs, run, RWKV_SERVE, n_params=_n_params(M, params), init_s=t_init,
        prefill_rwkv_chunk=1, model_prefill_tokens=RWKV_PREFILL_T,
        model_prefill_ms={str(c): v["ms"] for c, v in chunks.items()},
        model_prefill_host_ms={str(c): v["host_ms"] for c, v in chunks.items()},
        model_prefill_speedup=chunks[lo]["ms"] / chunks[hi]["ms"],
        model_prefill_max_abs_logit_diff=float((logits[lo] - logits[hi]).abs().max()),
        **decode, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[families] " + json.dumps(line, sort_keys=True))
    return run["launches"], [
        *(measured(cfg, "prefill", 1, RWKV_PREFILL_T, chunks[c]["ms"],
                   f"CUDA events around one prefill at rwkv_chunk={c}", rwkv_chunk=c)
          for c in RWKV_CHUNKS),
        decode_measured(cfg, eng.states[0], RWKV_SERVE["max_len"], decode)]


def hubert_run(torch, np):
    """HuBERT-XLarge's encoder at full depth and width (bf16, random
    weights): ``forward`` over HUBERT_CLIPS x HUBERT_FRAMES frame embeddings,
    no kernel on the path. Returns its measured path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import model as M

    cfg = get_config("hubert-xlarge")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    embeds = torch.randn((HUBERT_CLIPS, HUBERT_FRAMES, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5)).bfloat16()
    before = dict(_lib.LAUNCHES)
    ms = []
    with torch.no_grad():
        for _ in range(4):  # the first call warms up
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            logits, _ = M.forward(params, {"embeds": embeds}, cfg, remat=False)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    check(logits.shape == (HUBERT_CLIPS, HUBERT_FRAMES, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "HuBERT's logits are not finite")
    check(_lib.LAUNCHES == before, "HuBERT's forward launched a kernel")
    t = statistics.median(ms[1:])
    line = dict(model=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
                n_params=_n_params(M, params), clips=HUBERT_CLIPS, frames=HUBERT_FRAMES,
                forward_ms=t, forward_ms_first=ms[0],
                frames_per_s=HUBERT_CLIPS * HUBERT_FRAMES / t * 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say("[families] " + json.dumps(line, sort_keys=True))
    return [measured(cfg, "prefill", HUBERT_CLIPS, HUBERT_FRAMES, t,
                     "CUDA events around forward, median of 3 after a warm-up")]


def families_phase(torch, np):
    """The vlm, audio, hybrid and ssm families, after the earlier phases'
    tensors are freed: the four smoke configs card == CPU; flash_attention
    at their prefill shapes; Llama-3.2-Vision (20 layers) prefills and
    decodes, Zamba2 and RWKV6 at full size served with a drain, HuBERT's
    encoder at full size. Returns (the main-path launches of the vision
    run and the two serving runs, summed; the flash rows; the measured
    paths)."""
    import gc

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    free()
    families_small(torch, np)
    flash = families_flash(torch, np)
    free()
    launches, paths = vision_run(torch, np)
    free()
    for run in (zamba_serve, rwkv_serve):
        got, more = run(torch, np)
        for k, v in got.items():
            launches[k] += v
        paths += more
        free()
    paths += hubert_run(torch, np)
    free()
    say(f"[families] phase {time.perf_counter() - t0:.1f} s")
    return launches, flash, paths


# ---------------------------------------------------------------------------
# phase 12: the measured paths against the H100's roofline
# ---------------------------------------------------------------------------

#: the most a share may read: above it the count or the clock is wrong
ROOFLINE_MAX_SHARE = 1.05


def roofline_phase(card, paths):
    """Each measured path against the port's analytic model of its work
    (``analysis.perfmodel.estimate`` at the path's own batch, length, kind
    and depth; one card: chips = dp = tp = 1; f32 moments, or 8-bit ones where
    the path ran them) on the H100's
    roofline: mfu = model FLOPs / (ms x peak) and roofline_fraction =
    max(compute, memory) / ms, each in (0, ROOFLINE_MAX_SHARE]."""
    from repro_torch.analysis import perfmodel, roofline
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.shapes import ShapeSpec

    chip = roofline.H100
    say(f"[roofline] {chip.name}: {chip.peak_flops:.4g} FLOP/s bf16 dense, "
        f"{chip.hbm_bw:.4g} B/s HBM; the card: {card}")
    for p in paths:
        cfg = p["cfg"]
        shape = ShapeSpec(f"{p['kind']}_{p['batch']}x{p['seq_len']}", p["seq_len"], p["batch"],
                          p["kind"])
        est = perfmodel.estimate(cfg, shape, 1, 1, 1,
                                 eight_bit_opt=p.get("eight_bit_opt", False))
        got = roofline.against(est, model_flops(cfg, shape), p["ms"] / 1e3, chip)
        line = dict(model=cfg.name, n_layers=cfg.n_layers, kind=p["kind"], batch=p["batch"],
                    seq_len=p["seq_len"], ms=p["ms"], ms_of=p["ms_of"], **got,
                    **{k: v for k, v in p.items()
                       if k not in ("cfg", "kind", "batch", "seq_len", "ms", "ms_of")})
        say("[roofline] " + json.dumps(line, sort_keys=True))
        for share in ("mfu", "roofline_fraction"):
            check(0 < got[share] <= ROOFLINE_MAX_SHARE,
                  f"[roofline] {cfg.name} {shape.name}: {share} {got[share]} is outside "
                  f"(0, {ROOFLINE_MAX_SHARE}]: the count or the clock is wrong")


#: the dry run's sharded cells: (arch, shape, mesh) under each variant (the
#: baseline, and seqpar: the residual stream split by sequence over "model")
SHARDED_CELL = ("yi_6b", "train_4k", "single")
SHARDED_VARIANTS = ("baseline", "seqpar")


def start_sharded_dry_run():
    """Start the sharded cells' dry runs (``repro_torch.launch.dryrun`` on
    torch's fake process group: meta tensors, the CPU only), one process a
    variant, side by side; returns per variant the process, its output
    directory and its start."""
    import shutil

    arch, shape, mesh = SHARDED_CELL
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    runs = {}
    for variant in SHARDED_VARIANTS:
        out = ROOT / "build" / "dryrun_sharded" / variant
        shutil.rmtree(out, ignore_errors=True)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--variant", variant, "--out", str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs[variant] = (proc, out, time.perf_counter())
    return runs


def roofline_sharded(runs):
    """Each sharded cell's artifact on the H100's roofline (``analyze``):
    the compute and memory terms from the analytic model at 256 chips, dp
    16, tp 16, and the collective term from the recorded wire bytes a
    device over the link's 450e9 B/s. The seqpar cell's record must hold
    more reduce-scatters than the baseline's (the stream's, on the model
    group: the data ranks issue none) and no fewer all-gathers; its line
    carries the baseline's collective term beside its own."""
    from repro_torch.analysis import roofline

    arch, shape, mesh = SHARDED_CELL
    arts, terms = {}, {}
    for variant, (proc, out, t0) in runs.items():
        log, _ = proc.communicate(timeout=900)
        check(proc.returncode == 0,
              f"[roofline] the sharded dry run ({variant}) failed:\n{log[-3000:]}")
        tag = "" if variant == "baseline" else f"__{variant}"
        art = arts[variant] = json.loads((out / f"{arch}__{shape}__{mesh}{tag}.json").read_text())
        col = art["collectives"]
        kinds = {"all-gather", "all-reduce", "all-to-all"}
        check(col["total_wire_bytes"] > 0 and kinds <= set(col["ops"]),
              f"[roofline] the sharded cell's ({variant}) record lacks wire bytes or one of "
              f"{sorted(kinds)}: {col['ops']}")
        r = roofline.analyze(art, roofline.H100)
        terms[variant] = r.collective_s * 1e3
        extra = {} if variant == "baseline" else dict(
            baseline_collective_ms=terms["baseline"],
            baseline_ops=arts["baseline"]["collectives"]["ops"],
            baseline_wire_bytes=arts["baseline"]["collectives"]["total_wire_bytes"])
        say("[roofline] " + json.dumps(dict(
            model=art["arch"], shape=shape, variant=variant,
            mesh=f"{mesh}: make_production_mesh() on torch's fake "
            "process group (rank 0 of 256), tensor-parallel on 'model'"
            + (", the residual stream split by sequence over 'model'"
               if variant == "seqpar" else ""),
            chips=art["chips"], dp=art["dp"], tp=art["tp"],
            compute_ms=r.compute_s * 1e3, memory_ms=r.memory_s * 1e3,
            collective_ms=r.collective_s * 1e3,
            link_term="recorded wire bytes a device / 450e9 B/s (roofline.H100.link_bw)",
            wire_bytes=col["total_wire_bytes"], ops=col["ops"],
            wire_bytes_by_kind=col["wire_bytes"],
            bottleneck=r.bottleneck, counted_flops_rank0=art["cost"]["flops"],
            argument_bytes_rank0=art["memory"]["argument_size_in_bytes"],
            dry_run_cpu_s=art["lower_compile_s"], wall_s=time.perf_counter() - t0, **extra),
            sort_keys=True))
    base, seq = (arts[v]["collectives"]["ops"] for v in SHARDED_VARIANTS)
    check(seq.get("reduce-scatter", 0) > base.get("reduce-scatter", 0)
          and seq.get("all-gather", 0) >= base.get("all-gather", 0),
          f"[roofline] the seqpar cell's record lacks the stream's reduce-scatters or issues "
          f"fewer all-gathers than the baseline's: {seq} against {base}")


# ---------------------------------------------------------------------------
# phase 13: the operator entry points (drivers), as a user runs them
# ---------------------------------------------------------------------------

#: the tournament and policy comparison of simnet.run at the simulator's
#: full-width straggler traffic (phase 6's config; controld legs run the
#: host engine: sessions are host-side daemons), each leg also on the CPU in
#: a process of its own, beside the card's, the reports compared whole
DRIVER_POLICIES = "proportional,pid,frozen"
DRIVER_WINDOWS = 24
#: the analyzer's traced full-width runs (fused and host engine), head-
#: sampled so that their lossless summaries stay a few MB
ANALYZER_WINDOWS, ANALYZER_SAMPLE = 16, 1 / 16
ANALYZER_PERCENTILES = (50.0, 99.0, 99.9)
ANALYZER_MAX_REL_ERR = 0.01
#: the control plane as a service: the daemon's largest reservation
CONTROLD_MEMBERS, CONTROLD_INSTANCES = 64, 4
#: member leases (wall clock) of the demos and the served daemon at 8x the
#: driver's default: the phase runs its drivers side by side, a member's
#: lease runs from its registration through the other 63 registrations to
#: its first heartbeat, and a lapse there would fail a check that has
#: nothing to do with the card
CONTROLD_LEASE_S = 2.0
DRIVER_TIMEOUT_S = 420
DRIVERS_DIR = ROOT / "build" / "drivers"


def _launch_line(text: str) -> dict:
    """The launch line a driver prints on stderr (the last one)."""
    from repro_torch.kernels import _lib

    lines = [ln for ln in text.splitlines() if ln.startswith(_lib.LAUNCH_LINE)]
    check(bool(lines), f"a driver printed no launch line:\n{text[-2000:]}")
    return json.loads(lines[-1][len(_lib.LAUNCH_LINE):])


def _spawn(name, argv):
    """``python argv`` from the checkout's root in a process group of its
    own (``_kill`` ends the processes it starts too), its output to files
    under ``DRIVERS_DIR``; returns (process, start, its out and err paths,
    its end: set by a thread that waits for it)."""
    import threading

    out, err = DRIVERS_DIR / f"{name}.out", DRIVERS_DIR / f"{name}.err"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=env,
                            stdout=open(out, "w"), stderr=open(err, "w"),
                            start_new_session=True)
    end = []
    threading.Thread(target=lambda: (proc.wait(), end.append(time.perf_counter())),
                     daemon=True).start()
    return proc, time.perf_counter(), out, err, end


def _kill(proc):
    """SIGKILL a spawned driver's process group (--ha-demo's nodes with it)."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _finish(name, run):
    """Wait for a spawned driver; it must exit 0. Returns (stdout, stderr,
    its wall s from spawn to exit)."""
    proc, t0, out, err, end = run
    try:
        rc = proc.wait(timeout=DRIVER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _kill(proc)
        raise SmokeFailure(f"[drivers] {name} ran past {DRIVER_TIMEOUT_S} s")
    while not end:
        time.sleep(0.01)
    wall = end[0] - t0
    o, e = out.read_text(), err.read_text()
    check(rc == 0, f"[drivers] {name} exited {rc}:\n{o[-3000:]}\n{e[-3000:]}")
    return o, e, wall


def driver_cpu_legs(path, windows):
    """The tournament's legs on the CPU (the plain path), in a process of
    its own: each distinct leg's comparable report, to ``path``."""
    from repro_torch.simnet import run as sim_run

    cfg, scn = simnet_config(SIMNET_FUSED_MEMBERS, windows, "fused", "cpu", controld=True)
    report, _ = sim_run.run_leg(cfg, scn)
    legs = sim_run.Legs(cfg, scn, report)
    sim_run.frozen_compare(legs)
    sim_run.policy_compare(legs)
    sim_run.tournament(legs, DRIVER_POLICIES, scn.name)
    out = [dict(frozen=c.frozen_weights, policy=c.controld_policy, report=_comparable(r))
           for c, r in legs.reports()]
    Path(path).write_text(json.dumps(out))


def driver_tournament(torch, cpu_run):
    """simnet.run's --compare-frozen, --compare-policy and --tournament at
    the full-width straggler traffic on the card, through the driver's
    functions on a built config; every leg's report equal to the same leg
    on the CPU. Returns the launches."""
    from repro_torch.kernels import _lib
    from repro_torch.simnet import fused
    from repro_torch.simnet import run as sim_run

    cfg, scn = simnet_config(SIMNET_FUSED_MEMBERS, DRIVER_WINDOWS, "fused", "cuda",
                             controld=True)
    _lib.reset_launches()
    report, _ = sim_run.run_leg(cfg, scn)
    legs = sim_run.Legs(cfg, scn, report)
    frozen, bad_f = sim_run.frozen_compare(legs)
    compare, bad_p = sim_run.policy_compare(legs)
    ranked, bad_t = sim_run.tournament(legs, DRIVER_POLICIES, scn.name)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    done = legs.reports()
    _, _, cpu_wall = _finish("cpu_legs", cpu_run)
    cpu = json.loads((DRIVERS_DIR / "cpu_legs.json").read_text())
    legs_line = [dict(policy=c.controld_policy, frozen=c.frozen_weights, engine=r.engine,
                      wall_s=r.wall_s, windows_per_s=r.steps / r.wall_s,
                      latency_p50_s=r.latency_p50_s, latency_p99_s=r.latency_p99_s,
                      bundles_completed=r.bundles_completed,
                      bundles_timed_out=r.bundles_timed_out,
                      packets_dropped_queue=r.packets_dropped_queue,
                      epoch_switches=r.epoch_switches, violations=r.violations)
                 for c, r in done]
    say("[drivers] " + json.dumps(dict(
        run="simnet.run --compare-frozen --compare-policy --tournament " + DRIVER_POLICIES,
        traffic=f"phase 6's full width: {SIMNET_FUSED_MEMBERS} members, 16 DAQs, 128 "
                f"triggers of 64 kB bundles a window, {DRIVER_WINDOWS} windows",
        engine=f"host ({fused.unsupported_reason(cfg, scn)})", legs=legs_line,
        control=frozen, policy_compare=compare, tournament=ranked["ranked"],
        cpu_legs_wall_s=cpu_wall, launches={k: v for k, v in launches.items() if v}),
        sort_keys=True))
    check(len(done) == 3, f"[drivers] {len(done)} distinct legs, want 3")
    for c, r in done:
        check(r.engine == "host" and not r.violations,
              f"[drivers] leg {c.controld_policy} frozen={c.frozen_weights}: engine "
              f"{r.engine}, {r.violations}")
    violations = list(report.violations) + bad_p + bad_t
    check(not violations, f"[drivers] tournament gates: {violations}")
    check(report.latency_p99_s > report.latency_p50_s > 0, "[drivers] degenerate p99/p50")
    check(compare["pid_p99_s"] <= compare["proportional_p99_s"],
          f"[drivers] PID lost to proportional: {compare}")
    # --compare-frozen's gate is the straggler preset's promise, held where
    # the preset runs (driver_preset). At this traffic the reference's own
    # host engine trails frozen from 12 windows on, with the same legs as the
    # port (tests/test_torch_simnet_full_width.py), so the outcome is printed
    say(f"[drivers] closed loop against frozen at full width: p99 gain "
        f"{frozen['p99_gain_vs_frozen_s']:+.9f} s, the preset's gate "
        + ("holds" if not bad_f else f"does not hold here, as in the reference's "
                                     f"host engine at this traffic: {bad_f}"))
    check(launches["lb_route"] == len(done) * DRIVER_WINDOWS,
          f"[drivers] lb_route launched {launches['lb_route']} times in {len(done)} legs "
          f"of {DRIVER_WINDOWS} windows")
    check(len(cpu) == len(done), "[drivers] the CPU ran other legs")
    for (c, r), want in zip(done, cpu):
        check((c.frozen_weights, c.controld_policy) == (want["frozen"], want["policy"])
              and json.loads(json.dumps(_comparable(r))) == want["report"],
              f"[drivers] leg {c.controld_policy} frozen={c.frozen_weights}: the card's "
              f"report differs from the CPU's")
    say("[drivers] every leg card == CPU (whole report); no leg broke an invariant, PID "
        "not worse than proportional")
    return launches


def driver_preset(run):
    """``python -m repro_torch.simnet.run --scenario straggler
    --compare-frozen --compare-policy --tournament ...`` as a user runs it,
    at the preset's own size and depth on the card: every gate of the
    reference (the closed loop beats frozen, PID not worse than
    proportional, no leg with a violation) must hold. Returns the launches."""
    _, e, wall = _finish("preset", run)
    summary = json.loads((DRIVERS_DIR / "preset.json").read_text())
    launched = _launch_line(e)
    check(not summary["violations"] and summary["p99_gain_vs_frozen_s"] > 0,
          f"[drivers] the straggler preset's gates: {summary['violations']}")
    check(launched["lb_route"] > 0, "[drivers] the preset's legs launched no lb_route")
    say("[drivers] " + json.dumps(dict(
        run="python -m repro_torch.simnet.run --scenario straggler --compare-frozen "
            "--compare-policy --tournament " + DRIVER_POLICIES + " --device cuda",
        windows=summary["steps"], wall_s=wall, primary_wall_s=summary["wall_s"],
        p99_gain_vs_frozen_s=summary["p99_gain_vs_frozen_s"],
        policy_compare=summary["policy_compare"],
        tournament=summary["tournament"]["ranked"]), sort_keys=True)
        + " — every gate holds")
    return launched


def _tables(analyze_trace, tb):
    """The analyzer's tables of a trace and their stage sums' errors."""
    from repro_torch.telemetry.traceview import format_table

    rows, failures = analyze_trace.analyze(tb, ANALYZER_PERCENTILES, ANALYZER_MAX_REL_ERR)
    check(not failures, f"[drivers] analyzer: {failures}")
    return [format_table(d) for d in rows], [d["reconcile_rel_err"] for d in rows]


def _reloaded(analyze_trace, tb, name):
    """The trace through ``--summary-json`` and back through ``--summary``:
    the tables the reloaded summary prints."""
    import contextlib
    import io

    path = DRIVERS_DIR / f"{name}_summary.json"
    analyze_trace.write_summary(tb, str(path), ANALYZER_PERCENTILES)
    buf = io.StringIO()
    argv = ["--summary", str(path)] + [a for p in ANALYZER_PERCENTILES
                                       for a in ("--percentile", str(p))]
    with contextlib.redirect_stdout(buf):
        rc = analyze_trace.main(argv)
    check(rc == 0, f"[drivers] analyze_trace --summary {name} exited {rc}")
    return buf.getvalue(), path.stat().st_size


def driver_analyzer(torch):
    """The critical-path analyzer (telemetry.analyze_trace) on traced
    full-width runs: the fused engine against the host engine on the card,
    and the fabric's vlb_spray at the analyzer's preset on the card against
    the CPU: the same tables, stage sums within 1% at p50/p99/p99.9, the
    summary reloaded to the same tables. Returns the card runs' launches."""
    import argparse
    import dataclasses

    from repro_torch.kernels import _lib
    from repro_torch.simnet import Simulator, fused
    from repro_torch.telemetry import analyze_trace

    launches, tables, lines = {}, {}, []
    for engine in ("fused", "host"):
        cfg, scn = simnet_config(SIMNET_FUSED_MEMBERS, ANALYZER_WINDOWS, engine, "cuda",
                                 trace=True, trace_sample=ANALYZER_SAMPLE)
        _lib.reset_launches()
        sim = Simulator(cfg, dataclasses.replace(scn))
        replays0 = fused.FUSED_STEP_CALLS
        # Simulator.run's own engine for the fused config, held here for its
        # program's launch counts
        eng = fused.FusedEngine(sim, superblock=SIMNET_K) if engine == "fused" else sim
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(report.engine == engine and not report.violations,
              f"[drivers] traced {engine} run: engine {report.engine}, {report.violations}")
        if engine == "fused":  # a graph's launches tick the counts at capture only
            n_rep = fused.FUSED_STEP_CALLS - replays0
            per_run = eng.program.launches_per_run
            check(n_rep == ANALYZER_WINDOWS // SIMNET_K and all(
                per_run.get(k, 0) == SIMNET_K for k in SIMNET_KERNELS),
                f"[drivers] traced fused run: {n_rep} replays of {per_run}")
            ran = {k: v * n_rep for k, v in per_run.items()}
        else:
            ran = dict(_lib.LAUNCHES)
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        tables[engine], errs = _tables(analyze_trace, sim.trace)
        analyze_s = time.perf_counter() - t0
        again, size = _reloaded(analyze_trace, sim.trace, engine)
        check(again == "".join(t + "\n\n" for t in tables[engine]),
              f"[drivers] the {engine} run's summary reloads to other tables")
        lines.append(dict(run=f"simnet straggler, {engine} engine", windows=ANALYZER_WINDOWS,
                          trace_sample=ANALYZER_SAMPLE, wall_s=wall,
                          spans=len(sim.trace.spans()["key"]), analyze_s=analyze_s,
                          summary_bytes=size, reconcile_rel_err=errs,
                          p99_e2e_ms=report.latency_p99_s * 1e3))
    check(tables["fused"] == tables["host"],
          "[drivers] the fused engine's tables differ from the host engine's:\n"
          + "\n".join(tables["fused"]) + "\n" + "\n".join(tables["host"]))

    def fabric(device):
        args = argparse.Namespace(fabric="vlb_spray", steps=50, seed=0,
                                  trace_sample=1.0, trace_tail_k=64, device=device)
        t0 = time.perf_counter()
        tb = analyze_trace.run_fabric(args)
        return tb, time.perf_counter() - t0

    _lib.reset_launches()
    tb, wall = fabric("cuda")
    torch.cuda.synchronize()
    check(_lib.LAUNCHES["lb_route"] > 0, "[drivers] the fabric's traced run launched no "
                                         "lb_route")
    for k, v in _lib.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    card, errs = _tables(analyze_trace, tb)
    cpu, _ = _tables(analyze_trace, fabric("cpu")[0])
    check(card == cpu, "[drivers] the fabric's tables differ card vs CPU")
    again, size = _reloaded(analyze_trace, tb, "vlb_spray")
    check(again == "".join(t + "\n\n" for t in card),
          "[drivers] the fabric's summary reloads to other tables")
    lines.append(dict(run="fabric vlb_spray (the analyzer's 50 windows)", wall_s=wall,
                      spans=len(tb.spans()["key"]), summary_bytes=size,
                      reconcile_rel_err=errs))
    say("[drivers] " + json.dumps(dict(
        run="telemetry.analyze_trace", percentiles=ANALYZER_PERCENTILES, legs=lines,
        launches={k: v for k, v in launches.items() if v}), sort_keys=True)
        + " — fused tables == host tables, fabric card == CPU, summaries reload equal")
    say("[drivers] p99 of the traced fused run:\n" + tables["fused"][1])
    return launches


def _serve_and_scrape(run):
    """Drive a ``--serve --metrics-port 0`` daemon over its socket with the
    demo's rounds at CONTROLD_MEMBERS members; scrape /metrics; stop it."""
    import signal
    import urllib.request

    from repro_torch.controld import ControldClient, SocketClient

    proc, _, out, err, _ = run
    deadline = time.perf_counter() + DRIVER_TIMEOUT_S
    while out.read_text().count("\n") < 2:
        check(proc.poll() is None and time.perf_counter() < deadline,
              f"[drivers] --serve did not come up:\n{err.read_text()[-3000:]}")
        time.sleep(0.1)
    line1, line2 = out.read_text().splitlines()[:2]
    port = int(line1.split(" on ", 1)[1].split()[0].split(":")[1])
    url = line2.split(" on ", 1)[1].strip()
    n, rounds = CONTROLD_MEMBERS, 12
    client = ControldClient(SocketClient("127.0.0.1", port))
    token = client.reserve(policy="pid")["token"]
    for m in range(n):
        client.register(token, member_id=m, node_id=m, lane_bits=1)
    client.tick(current_event=0)
    t0 = time.perf_counter()
    for r in range(rounds):
        reply = client.send_state_batch(token, list(range(n)),
                                        [0.9 if m == 0 else 0.3 for m in range(n)])
        check(reply["n_accepted"] == n and not reply["rejected"],
              f"[drivers] --serve rejected heartbeats: {reply}")
        client.tick(current_event=400 * (r + 1))
    rounds_s = time.perf_counter() - t0
    weights = {int(k): v["weight"] for k, v in
               client.status(token)["sessions"][token]["members"].items()}
    # the daemon is on this host: no proxy of the environment in between
    scrape = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    page = scrape.open(url, timeout=10).read().decode()
    client.close()
    for want in ('controld_messages_total{kind="send_state_batch"} ' + str(rounds),
                 f"controld_heartbeats_total {n * rounds}",
                 f'controld_session_members{{token="{token}"}} {n}',
                 "controld_handle_seconds_bucket"):
        check(want in page, f"[drivers] /metrics lacks {want!r}")
    check(weights[0] < min(weights[m] for m in range(1, n)),
          "[drivers] --serve: the straggler kept its weight")
    proc.send_signal(signal.SIGTERM)
    _, e, wall = _finish("serve", run)
    series = sorted({ln.split()[2] for ln in page.splitlines() if ln.startswith("# TYPE")})
    return dict(members=n, rounds=rounds, heartbeats_per_s=n * rounds / rounds_s,
                round_trip_ms=rounds_s / rounds / 2 * 1e3, series=series,
                process_lifetime_s=wall, launches=_launch_line(e))


def drivers_phase(torch, np):
    """The operator entry points on the card: controld.run (demo, compacted
    demo, a served and scraped daemon, HA failover) and the three examples
    as subprocesses with --device cuda, beside simnet.run's tournament and
    the analyzer in this process. Returns the launches of the phase."""
    import shutil

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(DRIVERS_DIR, ignore_errors=True)
    for d in ("demo", "compacted"):
        (DRIVERS_DIR / d).mkdir(parents=True)
    cd = ["-m", "repro_torch.controld.run", "--device", "cuda"]
    wide = ["--n-instances", str(CONTROLD_INSTANCES), "--n-members", str(CONTROLD_MEMBERS)]
    leased = wide + ["--lease-s", str(CONTROLD_LEASE_S)]
    runs = {
        "cpu_legs": _spawn("cpu_legs", ["-c", "import sys; sys.path.insert(0, 'src'); "
                                              "import chip_smoke; chip_smoke.driver_cpu_legs("
                                              f"{str(DRIVERS_DIR / 'cpu_legs.json')!r}, "
                                              f"{DRIVER_WINDOWS})"]),
        "preset": _spawn("preset", ["-m", "repro_torch.simnet.run", "--scenario", "straggler",
                                    "--compare-frozen", "--compare-policy", "--tournament",
                                    DRIVER_POLICIES, "--device", "cuda", "--json",
                                    str(DRIVERS_DIR / "preset.json")]),
        "demo": _spawn("demo", cd + ["--demo"] + leased + [
            "--journal", str(DRIVERS_DIR / "demo" / "journal.jsonl"),
            "--json", str(DRIVERS_DIR / "demo.json")]),
        "demo_compacted": _spawn("demo_compacted", cd + ["--demo"] + leased + [
            "--compact-every", "16", "--snapshot-dir", str(DRIVERS_DIR / "snapshots"),
            "--journal", str(DRIVERS_DIR / "compacted" / "journal.jsonl"),
            "--json", str(DRIVERS_DIR / "demo_compacted.json")]),
        "serve": _spawn("serve", cd + ["--serve", "--port", "0", "--metrics-port", "0",
                                       "--journal", str(DRIVERS_DIR / "serve.jsonl")] + leased),
        "ha_demo": _spawn("ha_demo", cd + ["--ha-demo", "--n-members", str(CONTROLD_MEMBERS),
                                           "--json", str(DRIVERS_DIR / "ha_demo.json")]),
        "quickstart": _spawn("quickstart", ["examples/quickstart_torch.py", "--device",
                                            "cuda"]),
        "serve_lb": _spawn("serve_lb", ["examples/serve_lb_torch.py", "--device", "cuda"]),
        "elastic_scaling": _spawn("elastic_scaling", [
            "examples/elastic_scaling_torch.py", "--device", "cuda", "--ckpt-dir",
            str(DRIVERS_DIR / "elastic_ckpt")]),
    }
    try:
        total = {}

        def add(name, launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            say(f"[drivers] {name} launched " + json.dumps(
                {k: v for k, v in launches.items() if v}, sort_keys=True))

        add("simnet.run's legs", driver_tournament(torch, runs["cpu_legs"]))
        runs.pop("cpu_legs")
        add("simnet.run at the straggler preset", driver_preset(runs.pop("preset")))
        add("analyze_trace's card runs", driver_analyzer(torch))
        served = _serve_and_scrape(runs["serve"])
        runs.pop("serve")
        add("controld.run --serve", served.pop("launches"))
        say("[drivers] " + json.dumps(dict(run="controld.run --serve --metrics-port 0 "
                                           "--device cuda", **served), sort_keys=True))
        for name in ("demo", "demo_compacted", "ha_demo"):
            _, e, wall = _finish(name, runs.pop(name))
            summary = json.loads((DRIVERS_DIR / f"{name}.json").read_text())
            check(summary["checks"] and all(summary["checks"].values()),
                  f"[drivers] controld.run {name}: {summary['checks']}")
            add(f"controld.run {name}", _launch_line(e))
            keep = {k: summary[k] for k in ("journal_entries", "failover_s", "lease_term_s",
                                            "leader_killed") if k in summary}
            say("[drivers] " + json.dumps(dict(run=f"controld.run {name}", wall_s=wall,
                                               checks=sorted(summary["checks"]), **keep),
                                          sort_keys=True) + " — every check true")
        prints = {"quickstart": "event atomicity: OK", "serve_lb": "drained OK",
                  "elastic_scaling": "trained 50 steps through 4 epochs"}
        for name, want in prints.items():
            o, e, wall = _finish(name, runs.pop(name))
            check(want in o, f"[drivers] {name} did not print {want!r}:\n{o[-2000:]}")
            launched = _launch_line(e)
            add(f"examples/{name}_torch.py", launched)
            say(f"[drivers] examples/{name}_torch.py --device cuda: {wall:.2f} s, "
                f"printed {want!r}; last lines: " + " | ".join(o.strip().splitlines()[-3:]))
            if name == "quickstart":
                # its reassembly is the compute node's host-side numpy plan
                # (DataPlane.make_reassembler's default, as the reference's):
                # no seg_masks on this path
                check(launched["lb_route"] > 0 and launched["seg_masks"] == 0,
                      f"[drivers] quickstart launched {launched}")
            if name == "serve_lb":
                check(launched["lb_route"] > 0 and launched["flash_attention"] > 0,
                      f"[drivers] serve_lb launched {launched}")
    finally:
        for proc, *_ in runs.values():
            _kill(proc)
    say(f"[drivers] the daemon (np policy engine) launches no kernel: controld.run's "
        f"runs touch the card only through CUDA's start; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
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
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace, set before its first handle ([train]'s resume)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np

    sharded = start_sharded_dry_run()
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
        serve_launches, paths = full_serve(torch, np)
        for k, v in controld_serve(torch, np).items():
            serve_launches[k] += v
        simnet_results, simnet_launches = simnet_phase(torch, np)
        results.update(simnet_results)
        controld_launches = controld_phase(torch, np)
        fabric_launches = fabric_phase(torch, np)
        train_launches, train_paths = train_phase(torch, np)
        train_dp_launches = train_dp(torch, np, train_paths[0]["ms"])
        serve_tp_launches = serve_tp(torch, np)
        family_train_launches, family_train_paths = train_families(torch, np)
        for k, v in family_train_launches.items():  # the families' steps count as training
            train_launches[k] = train_launches.get(k, 0) + v
        moe_launches, moe_plans, moe_flash, moe_paths = moe_phase(torch, np)
        results["dispatch_plan"]["moe_shapes"] = moe_plans
        results["flash_attention"]["mixtral_prefill"] = moe_flash
        family_launches, family_flash, family_paths = families_phase(torch, np)
        results["flash_attention"].update(family_flash)
        roofline_phase(card, paths + train_paths + family_train_paths + moe_paths
                       + family_paths)
        roofline_sharded(sharded)
        drivers_launches = drivers_phase(torch, np)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        print(f"FAIL: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        for proc, _out, _t0 in sharded.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # launches: the sum over the main-path runs (each checked on its own)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                    launches=(loop_launches[name] + serve_launches[name]
                              + simnet_launches.get(name, 0) + controld_launches[name]
                              + fabric_launches.get(name, 0) + train_launches.get(name, 0)
                              + train_dp_launches.get(name, 0)
                              + serve_tp_launches.get(name, 0)
                              + moe_launches[name] + family_launches[name]
                              + drivers_launches.get(name, 0)),
                    **results[name])
               for name in REPLACES]
    for row in kernels:
        if fabric_launches.get(row["name"]):  # of which in the fabric phase
            row["launches_fabric"] = fabric_launches[row["name"]]
        if train_launches.get(row["name"]):  # of which in the training phase
            row["launches_train"] = train_launches[row["name"]]
        if train_dp_launches.get(row["name"]):  # of which in the data-parallel step
            row["launches_train_dp"] = train_dp_launches[row["name"]]
        if serve_tp_launches.get(row["name"]):  # of which in the placed serving step
            row["launches_serve_tp"] = serve_tp_launches[row["name"]]
        if moe_launches[row["name"]]:  # of which in the MoE phase
            row["launches_moe"] = moe_launches[row["name"]]
        if family_launches[row["name"]]:  # of which in the families phase
            row["launches_families"] = family_launches[row["name"]]
        if drivers_launches.get(row["name"]):  # of which in the drivers phase
            row["launches_drivers"] = drivers_launches[row["name"]]
        if row["name"] == "flash_attention":  # of which through the wgmma design
            row["launches_wgmma"] = (loop_launches["flash_attention_wgmma"]
                                     + serve_launches["flash_attention_wgmma"]
                                     + serve_tp_launches.get("flash_attention_wgmma", 0)
                                     + moe_launches["flash_attention_wgmma"]
                                     + family_launches["flash_attention_wgmma"]
                                     + drivers_launches.get("flash_attention_wgmma", 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
