"""Device-resident closed loop: the per-window simnet step as ONE program.

The host engine (``sim.Simulator.step``) ping-pongs Python between seven
already-vectorized array programs every window — route (device), downlink
FIFO (numpy), farm Lindley scan, reassembly sort, telemetry dicts, policy,
calendar rebuild. This module is the paper's actual shape: the steady-state
loop runs on the card, and host code runs only at superblock boundaries.

Split of labor (the JAX package's ``simnet/fused.py``, ported op for op):

* **Host precompute (the plant).** Everything control-INDEPENDENT is
  precomputed per run with the simulator's real stateful objects — DAQ
  emission, segmentation, uplink + WAN serialization/loss, the per-window
  downlink randomness (``draw_window`` with the member links' own seed and
  window counter), and each window's wire header words. Within the fused
  scope every packet routes valid, so the downlink draw count per window is
  known before routing — the one fact that makes the plant separable.
* **Device step (the closed loop).** Routing through the ``lb_route`` kernel
  against an epoch *ring*, per-member downlink FIFO serialization (its
  running sum through the ``seq_cumsum`` kernel), the
  bounded Lindley farm queues (the ``farm_serve`` kernel), sort-based
  completion/duplicate detection, reassembly-timeout buckets,
  measured-occupancy telemetry, the proportional-PI policy and the 512-slot
  calendar rebuild (the ``build_calendar`` kernel, which reads the switch
  decision on the device). Python branches became masks.

A superblock of K windows is captured once per shape (npad, G, M, K,
timeout_windows) as a CUDA graph whose inputs are static buffers: each
superblock copies its windows into them and replays the graph once; the
carry stays on the card in float64 between replays. On the CPU the same
step runs eagerly on the kernels' plain versions.

The ring holds ``MAX_EPOCH_ROWS`` (8) starts and calendars; ``lb_route``
takes ``MAX_EPOCH_SEGMENTS`` (16) segments, so the ring is padded at the
front with 8 segments (start 0, row 0): a duplicated oldest row changes no
route (every start of the ring is >= 0, and an event below all of them falls
in the oldest row either way).

Numerical contract: every elementwise operation mirrors the host engine's
op for op, multi-key sorts are chains of stable sorts, and the downlink
FIFO's running sum adds in numpy's row order (the ``seq_cumsum`` kernel:
``torch.cumsum`` on the card adds in a tree, and a last-bit difference there
can flip a drop-tail decision of a queue at its bound), so counters are exact
and latencies equal (tests allow rel 1e-9, as the JAX package's tests do).

Tracing and live metrics are replayed on the host after the run
(``_observe``) from the step's per-window and per-row outputs, which the
step returns whether or not the run is traced: enabling either captures no
new graph. A traced run copies the per-row outputs back once per replay.

``FUSED_STEP_CALLS`` counts superblock runs (graph replays on the card) and
``FUSED_TRACES`` counts captures (one per shape).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.calendar import build_calendar as host_calendar
from repro_torch.core.protocol import CALENDAR_SLOTS, HEADER_BYTES
from repro_torch.core.tables import MAX_EPOCH_ROWS, MAX_EPOCH_SEGMENTS, DeviceTables
from repro_torch.data.segmentation import SEG_HDR_BYTES, next_pow2, segment_bundles
from repro_torch.data.transport import draw_window
from repro_torch.kernels import _lib
from repro_torch.kernels.calendar import build_calendar
from repro_torch.kernels.farm_serve import farm_serve
from repro_torch.kernels.lb_route import lb_route
from repro_torch.kernels.ref import np_sum
from repro_torch.kernels.seq_cumsum import seq_cumsum
from repro_torch.simnet.sim import IP_UDP_BYTES, SimReport
from repro_torch.telemetry.trace import bundle_key

#: superblock runs since import (one graph replay per K-window superblock)
FUSED_STEP_CALLS = 0
#: programs built since import (one CUDA-graph capture per shape; on the CPU,
#: one eager program per shape) — same-shape configs share one
FUSED_TRACES = 0

DEFAULT_SUPERBLOCK = 8
_RING = MAX_EPOCH_ROWS  # resident calendars in the carried epoch ring
_PAD = MAX_EPOCH_SEGMENTS - _RING  # leading (start 0, row 0) segments

# numpy's small-array quicksort was insertion sort (stable) up to this many
# elements — the JAX package's scope for the calendar quota tie-break
_STABLE_ARGSORT_MAX = 16

_PROGRAMS: dict = {}

#: the step's per-row outputs: read back only when a run is traced
ROW_OUTPUTS = ("t_cn", "farm_dep", "memb", "acc")


def unsupported_reason(cfg, scenario=None) -> Optional[str]:
    """Why this (config, scenario) must run on the host engine, or None.

    The fused program covers the embedded-CP single-instance loop with
    hook-free scenarios; anything that mutates the plant mid-run (traffic
    shaping, link flaps, controld lease churn) re-introduces host control
    flow between windows and stays on the oracle path.
    """
    if cfg.controld:
        return "controld sessions are host-side daemons"
    if cfg.n_instances != 1:
        return "multi-instance partitions the farm host-side"
    if scenario is not None:
        if scenario.traffic is not None:
            return "scenario shapes traffic per step"
        if scenario.trigger_boost is not None:
            return "scenario boosts trigger sizes per step"
        if scenario.on_step is not None:
            return "scenario mutates the plant per step"
    if cfg.stale_after_s is not None:
        return "staleness tracking needs host telemetry timestamps"
    if cfg.n_members > _STABLE_ARGSORT_MAX:
        return "calendar quota tie-break only reproducible for <=16 members"
    if not cfg.timeout_windows or cfg.timeout_windows < 1:
        return "reassembly timeout buckets need timeout_windows >= 1"
    # completion keys pack (event_lo, daq, seg) into one 64-bit lane
    ev_bound = (1 << 20) + 7 * cfg.steps * cfg.triggers_per_step
    if ev_bound >= (1 << 31):
        return "event numbers would overflow the packed completion key"
    if cfg.n_daqs >= (1 << 16):
        return "daq ids must fit the packed completion key"
    return None


def fused_supported(cfg, scenario=None) -> bool:
    return unsupported_reason(cfg, scenario) is None


# ---------------------------------------------------------------------------
# the fused per-window step
# ---------------------------------------------------------------------------

def _sort_perm(keys):
    """Permutation that sorts rows by ``keys`` (first key first), ties in row
    order: ``lax.sort``'s stable multi-key order, as stable sorts from the
    last key to the first."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        p = torch.sort(kk, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def _scatter(n_out: int, index, src, reduce: str, fill):
    """``jnp.full(n_out, fill).at[index].<reduce>(src, mode="drop")``: the
    index ``n_out`` stands for a dropped row (one spare slot, sliced off)."""
    buf = torch.full((n_out + 1,), fill, dtype=src.dtype, device=src.device)
    if reduce == "sum":
        buf.scatter_add_(0, index, src)
    else:
        buf.scatter_reduce_(0, index, src, reduce)
    return buf[:n_out]


def _window_step(c, x, p):
    """One window: route -> downlink FIFO -> farm -> completion -> timeout
    buckets -> telemetry -> policy -> (masked) epoch switch. Every branch of
    the host step is a mask; padding windows/rows are exact carry no-ops.
    Nothing here reads a device value on the host."""
    dev = c["weights"].device
    f64, i64 = torch.float64, torch.int64
    valid = x["valid"]
    n = valid.shape[0]
    m_count = c["weights"].shape[0]
    g_count = x["nseg_b"].shape[0]
    inf = float("inf")

    # -- 1) route: the lb_route kernel against the carried epoch ring -------
    zeros_pad = torch.zeros(_PAD, dtype=i64, device=dev)
    tables = DeviceTables(
        seg_start_hi=torch.cat([zeros_pad, c["ring_hi"]]),
        seg_start_lo=torch.cat([zeros_pad, c["ring_lo"]]),
        seg_row=p["seg_row"], calendars=c["ring_cal"],
        member_node=p["member_node"], member_base_lane=p["member_zero"],
        member_lane_mask=p["member_zero"], member_valid=p["member_one"])
    member, _node, _lane, r_valid = lb_route(x["hdr"], tables)
    memb = member.long()
    invalid = (valid & (r_valid == 0)).sum()  # 0 in the fused scope
    mc = memb.clamp(0, m_count - 1)

    # -- 2) downlink: segmented FIFO (links.fifo_departures_multi) ---------
    lk = torch.where(valid, memb, m_count)
    tx = torch.where(valid, x["bytes"] / p["link_rate"], 0.0)
    t_rdy = torch.where(valid, x["t_out"], 0.0)
    s_idx = _sort_perm([lk, t_rdy])
    s_lk, s_t, s_tx = lk[s_idx], t_rdy[s_idx], tx[s_idx]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = s_lk[1:] != s_lk[:-1]
    svalid = s_lk < m_count
    gid = torch.cumsum(new.long(), 0) - 1
    cs = seq_cumsum(s_tx)  # numpy's order of additions (torch.cumsum's differs)
    seg_base = torch.cummax(torch.where(new, cs - s_tx, -inf), 0).values
    cc = cs - seg_base
    a = s_t - (cc - s_tx)
    # the carried busy-until per link, one spare slot for the padding rows
    busy = torch.cat([c["dl_busy"], torch.full((1,), -inf, dtype=f64, device=dev)])
    a = torch.where(new, torch.maximum(a, busy[s_lk]), a)
    amax = torch.where(svalid, a, -inf).max()
    amin = torch.where(svalid, a, inf).min()
    span = torch.where(torch.isfinite(amax), (amax - amin) + 1.0, 0.0)
    off = gid.to(f64) * span
    run = torch.cummax(torch.where(svalid, a + off, -inf), 0).values
    dep_s = cc + (run - off)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = new[1:]
    busy.scatter_reduce_(0, torch.where(last & svalid, s_lk, m_count), dep_s, "amax")
    dl_busy = busy[:m_count]
    dep_row = torch.zeros(n, dtype=f64, device=dev)
    dep_row[s_idx] = dep_s
    # host: arrive = dep + prop_delay + jitter * jitter_s (same association)
    t_cn = (dep_row + p["dl_prop"]) + x["jadd"]

    # -- 3) farm: bounded Lindley queues through the farm_serve kernel -------
    fvalid = valid & x["keep"]
    fm = torch.where(fvalid, memb, m_count)
    ft = torch.where(fvalid, t_cn, 0.0)
    svc = torch.where(fvalid, p["per_pkt"][mc] + x["bytes"] * p["per_byte"][mc], 0.0)
    s_fi = _sort_perm([fm, ft])
    s_fm = fm[s_fi]
    counts = _scatter(m_count, s_fm, torch.ones(n, dtype=i64, device=dev), "sum", 0)
    offsets = torch.zeros(m_count + 1, dtype=i64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    dep_sorted, drop_sorted, farm_w, farm_t, _w_max = farm_serve(
        ft[s_fi].contiguous(), svc[s_fi].contiguous(), offsets.to(torch.int32),
        c["farm_w"], c["farm_t"], p["cap_s"])
    farm_dep = torch.full((n,), inf, dtype=f64, device=dev)
    farm_dep[s_fi] = dep_sorted
    farm_drop = torch.zeros(n, dtype=torch.bool, device=dev)
    farm_drop[s_fi] = drop_sorted
    qdrop = farm_drop.sum()
    acc = fvalid & ~farm_drop
    acc_m = _scatter(m_count, torch.where(acc, memb, m_count),
                     torch.ones(n, dtype=i64, device=dev), "sum", 0)
    recv = acc_m > 0

    # -- 4) completion: sort-based dedup + per-bundle counts ---------------
    key = (x["ev_lo"] << 32) | (x["daq"] << 16) | x["seg"]
    nacc = (~acc).to(torch.int32)
    perm = _sort_perm([nacc, key])
    s_key, s_dep, s_lidx = key[perm], farm_dep[perm], x["lidx"][perm]
    s_acc = nacc[perm] == 0
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = (s_key[1:] == s_key[:-1]) & s_acc[1:] & s_acc[:-1]
    uniq = s_acc & ~same
    tri = torch.cumsum(uniq.long(), 0) - 1
    # first-served copy of a segment = the copy with the minimal departure
    # (FIFO per member: service completions are nondecreasing in arrival
    # order) — exactly the host's dedup-in-service-order rule
    tri_min = _scatter(n, torch.where(s_acc, tri, n), s_dep, "amin", inf)
    val = tri_min[tri.clamp(0, n - 1)]
    to_b = torch.where(uniq, s_lidx, g_count)
    cnt_b = _scatter(g_count, to_b, torch.ones(n, dtype=i64, device=dev), "sum", 0)
    tdone_raw = _scatter(g_count, to_b, val, "amax", -inf)
    dups = s_acc.sum() - uniq.sum()
    done_b = (cnt_b == x["nseg_b"]) & (cnt_b > 0)
    any_b = cnt_b > 0
    t_done_b = torch.where(done_b, tdone_raw, 0.0)
    mem_b = _scatter(g_count, torch.where(valid, x["lidx"], g_count), memb, "amax", -1)
    new_pend = _scatter(m_count, torch.where(any_b & ~done_b, mem_b.clamp(0, m_count - 1),
                                             m_count),
                        torch.ones(g_count, dtype=i64, device=dev), "sum", 0)

    # -- 5) reassembly-timeout buckets (BatchReassembler aging) ------------
    # buckets[m, j] = pending groups that have survived j member-pushes; a
    # push shifts, expires slot A-1 and admits this window's new groups
    buckets = c["buckets"]
    timed = torch.where(recv, buckets[:, -1], 0).sum()
    shifted = torch.cat([new_pend[:, None], buckets[:, :-1]], dim=1)
    buckets = torch.where(recv[:, None], shifted, buckets)
    pend_m = buckets.sum(dim=1)

    # -- 6) measured telemetry at the window boundary ----------------------
    w_dec = torch.clamp_min(farm_w - torch.clamp_min(x["wend"] - farm_t, 0.0), 0.0)
    fill_farm = w_dec / p["cap_s"]
    backlog_q = torch.round(fill_farm * p["cap_pkts"])  # half to even, as the
    backlog = torch.maximum(backlog_q, pend_m.to(f64))   # host's round()
    fill_t = torch.clamp_max(backlog / p["cap_div"], 1.0)

    # -- 7) proportional-PI policy + finalize (policy._prop update) --------
    err = p["target"] - fill_t
    integ_new = torch.clamp(c["integral"] + p["ki"] * err, -1.0, 1.0)
    factor = 1.0 + p["kp"] * err + integ_new
    grow = c["weights"] * torch.clamp_min(factor, 0.1)
    mean = np_sum(grow, m_count) / float(m_count)
    wfin = torch.minimum(torch.maximum(grow / torch.clamp_min(mean, 1e-9), p["min_w"]),
                         p["max_w"])
    upd = x["reweight"] & x["win_valid"]
    integral = torch.where(upd, integ_new, c["integral"])
    weights = torch.where(upd, wfin, c["weights"])

    # -- 8) hysteresis + masked epoch switch -------------------------------
    past = x["cur_event"] >= c["cur_start"]
    delta = ((wfin - c["sched_w"]).abs() / c["sched_w"] > p["rw_thresh"]).any()
    do_sw = upd & past & delta
    boundary = torch.maximum(x["cur_event"] + p["horizon"], c["cur_start"] + 1)
    cal = build_calendar(wfin, do_sw.reshape(1),
                         torch.empty(CALENDAR_SLOTS, dtype=torch.int32, device=dev))
    ring_hi = torch.where(do_sw, torch.cat([c["ring_hi"][1:], (boundary >> 32)[None]]),
                          c["ring_hi"])
    ring_lo = torch.where(do_sw, torch.cat([c["ring_lo"][1:],
                                            (boundary & 0xFFFFFFFF)[None]]), c["ring_lo"])
    ring_cal = torch.where(do_sw, torch.cat([c["ring_cal"][1:], cal[None]]), c["ring_cal"])
    cur_start = torch.where(do_sw, boundary, c["cur_start"])
    sched_w = torch.where(do_sw, wfin, c["sched_w"])

    new_carry = dict(dl_busy=dl_busy, farm_w=farm_w, farm_t=farm_t,
                     ring_hi=ring_hi, ring_lo=ring_lo, ring_cal=ring_cal,
                     cur_start=cur_start, weights=weights, integral=integral,
                     sched_w=sched_w, buckets=buckets)
    ys = dict(done_b=done_b, t_done_b=t_done_b, any_b=any_b, mem_b=mem_b,
              acc_m=acc_m, fill=fill_farm, weights=weights, dups=dups,
              timed=timed, qdrop=qdrop, invalid=invalid, switched=do_sw,
              # per-row stage times, returned unconditionally so tracing
              # never changes the program (one capture either way): spans
              # are materialized on the host from these masked arrays
              t_cn=t_cn, farm_dep=torch.where(acc, farm_dep, 0.0),
              memb=mc.to(torch.int32), acc=acc)
    return new_carry, ys


class _Program:
    """One superblock program per shape: static carry, input and parameter
    buffers, and K window steps. On the card the steps are captured once as
    a CUDA graph (after a warm-up step on a side stream that does every
    kernel's first-call setup) and each ``run`` is one replay; on the CPU
    ``run`` executes the same steps eagerly."""

    def __init__(self, carry, params, xs_spec, k: int, device: torch.device):
        global FUSED_TRACES
        self.k = k
        self.device = device
        self.carry = {n: torch.as_tensor(v).to(device).clone() for n, v in carry.items()}
        self.params = {n: torch.as_tensor(v).to(device).clone() for n, v in params.items()}
        self.xs = {n: torch.zeros((k, *shape), dtype=dt, device=device)
                   for n, (shape, dt) in xs_spec.items()}
        self.graph = None
        #: kernel launches one replay makes (counted at capture; the card only)
        self.launches_per_run: dict[str, int] = {}
        if device.type == "cuda":
            self._capture()
        FUSED_TRACES += 1

    def _steps(self):
        c = dict(self.carry)
        outs = []
        for i in range(self.k):
            c, y = _window_step(c, {n: v[i] for n, v in self.xs.items()}, self.params)
            outs.append(y)
        for n, v in self.carry.items():
            v.copy_(c[n])
        return {n: torch.stack([y[n] for y in outs]) for n in outs[0]}

    def _capture(self):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            _window_step({n: v.clone() for n, v in self.carry.items()},
                         {n: v[0] for n, v in self.xs.items()}, self.params)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = dict(_lib.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.ys = self._steps()
        self.launches_per_run = {n: v - before[n] for n, v in _lib.LAUNCHES.items()
                                 if v != before[n]}

    def load(self, carry, params) -> None:
        for n, v in carry.items():
            self.carry[n].copy_(torch.as_tensor(v))
        for n, v in params.items():
            self.params[n].copy_(torch.as_tensor(v))

    def run(self, blk, rows: bool = False) -> tuple[dict, float, float]:
        """One superblock: ``blk``'s windows into the input buffers, one run;
        returns the outputs on the host, the device milliseconds of the
        replay (0.0 on the CPU) and the host seconds of the per-row outputs'
        copy. The per-row outputs (``ROW_OUTPUTS``) come back only when
        ``rows`` is set (a traced run); the others always."""
        global FUSED_STEP_CALLS
        for n, v in blk.items():
            self.xs[n].copy_(torch.from_numpy(v))
        ms = 0.0
        if self.graph is None:
            ys = self._steps()
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            self.graph.replay()
            end.record()
            ys = self.ys
        out = {n: v.cpu().numpy() for n, v in ys.items() if n not in ROW_OUTPUTS}
        copy_s = 0.0
        if rows:  # the step has finished: the copies above waited for it
            t0 = time.perf_counter()
            out.update({n: ys[n].cpu().numpy() for n in ROW_OUTPUTS})
            copy_s = time.perf_counter() - t0
        if self.graph is not None:
            ms = start.elapsed_time(end)
        FUSED_STEP_CALLS += 1
        return out, ms, copy_s

    def final_carry(self) -> dict:
        return {n: v.cpu().numpy() for n, v in self.carry.items()}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_XS_SPEC = [("hdr", np.int32), ("ev_lo", np.int64), ("daq", np.int64), ("seg", np.int64),
            ("lidx", np.int64), ("bytes", np.float64), ("t_out", np.float64),
            ("keep", bool), ("jadd", np.float64)]


class FusedEngine:
    """Runs one supported scenario end to end: host plant precompute, the
    superblock program, then numpy post-processing into a ``SimReport``
    identical (counters exactly, floats within fp tolerance) to the host
    engine's. Construct from an already-built ``Simulator``."""

    def __init__(self, sim, superblock: int = DEFAULT_SUPERBLOCK):
        self.sim = sim
        self.cfg = sim.cfg
        self.device = sim.device
        self.superblock = max(1, int(superblock))
        self.final_carry: Optional[dict] = None
        self.n_superblocks = 0
        #: device ms of each superblock's replay (empty on the CPU)
        self.replay_ms: list[float] = []
        #: host seconds of each traced superblock's per-row output copy, and
        #: the bytes those copies brought back
        self.row_copy_s: list[float] = []
        self.row_copy_bytes = 0
        self.program: Optional[_Program] = None

    # -- host plant precompute (control-independent randomness) ------------
    def _precompute(self):
        cfg, sim = self.cfg, self.sim
        W = cfg.steps
        G = cfg.triggers_per_step * cfg.n_daqs
        period = cfg.window_period_s(cfg.triggers_per_step)
        ml = cfg.member_link
        dl_seed = sim.member_links.seed
        rows, meta = [], []
        t_clock, dl_ctr = 0.0, 0
        packets_sent = packets_delivered = lost_dl = 0
        emit_all = np.zeros((W, G))
        ev_all = np.zeros((W, G), np.uint64)
        daq_all = np.zeros((W, G), np.int32)
        for i in range(W):
            t0 = t_clock
            window_end = t0 + period
            t_clock = window_end
            bundles = sim.fleet.bundle_window(cfg.triggers_per_step)
            trigger_t = (t0 + np.arange(cfg.triggers_per_step)
                         * cfg.trigger_period_s * 1.0)
            emit_b = np.repeat(trigger_t, cfg.n_daqs)
            batch = segment_bundles(bundles, cfg.mtu_payload)
            packets_sent += len(batch)
            bundle_of_row = np.cumsum(batch.seg_index == 0) - 1
            wire = (batch.payload_len.astype(np.float64)
                    + HEADER_BYTES + SEG_HDR_BYTES + IP_UDP_BYTES)
            t_up, up_keep = sim.daq_uplinks.transit(
                batch.daq_id.astype(np.int64), emit_b[bundle_of_row], wire)
            rows_up = np.flatnonzero(up_keep)
            dlv = sim.wan.transit(t_up[rows_up], wire[rows_up])
            src = rows_up[dlv.src]
            n3 = len(src)
            packets_delivered += n3
            if n3:
                # the member links' own stream, advanced only on non-empty
                # windows (the host step returns before transit when nothing
                # arrived) — loss/jitter identical to LinkSet.transit
                keep, _d, jit_u, _e = draw_window(
                    dl_seed, dl_ctr, n3, loss_prob=float(ml.loss_prob),
                    duplicate_prob=0.0, jitter_scale=1.0, device=self.device)
                dl_ctr += 1
                jadd = jit_u * float(ml.jitter_s)
                lost_dl += int((~keep).sum())
            else:
                keep = np.zeros((0,), bool)
                jadd = np.zeros((0,))
            rows.append(dict(
                hdr=batch.headers[src].view(np.int32),
                ev=batch.event_number[src],
                ev_lo=(batch.event_number[src] & np.uint64(0xFFFFFFFF)).astype(np.int64),
                daq=batch.daq_id[src].astype(np.int64),
                seg=batch.seg_index[src].astype(np.int64),
                lidx=bundle_of_row[src].astype(np.int64),
                bytes=wire[src],
                t_out=dlv.t_arrive + cfg.lb_latency_s,
                keep=keep, jadd=jadd,
                # host-side stage boundaries for the trace replay (never
                # shipped to the device)
                t_emit=emit_b[bundle_of_row][src], t_up=t_up[src],
                t_lb=dlv.t_arrive, sent=len(batch)))
            nseg_b = np.zeros((G,), np.int64)
            nseg_b[bundle_of_row] = batch.n_segs
            ev_all[i][bundle_of_row] = batch.event_number
            daq_all[i][bundle_of_row] = batch.daq_id
            emit_all[i] = emit_b
            reweight = (not cfg.frozen_weights and cfg.reweight_every
                        and (i + 1) % cfg.reweight_every == 0)
            meta.append(dict(nseg_b=nseg_b, reweight=bool(reweight),
                             win_valid=True, t0=t0, wend=window_end,
                             cur_event=sim.fleet.event_number))
        npad = next_pow2(max((len(r["ev_lo"]) for r in rows), default=1))
        return dict(rows=rows, meta=meta, npad=npad, G=G, W=W,
                    packets_sent=packets_sent,
                    packets_delivered=packets_delivered, lost_dl=lost_dl,
                    sim_time=t_clock, emit=emit_all, ev=ev_all, daq=daq_all)

    def _stack_xs(self, plant):
        """Pad rows to one global npad and windows to a whole number of
        superblocks (padding windows are exact carry no-ops), then stack.
        Padding rows carry all-zero header words, which fail validation."""
        npad, K = plant["npad"], self.superblock
        W, G = plant["W"], plant["G"]
        Wp = ((W + K - 1) // K) * K
        xs = {k: np.zeros((Wp, npad), dt) for k, dt in _XS_SPEC}
        xs["hdr"] = np.zeros((Wp, npad, 4), np.int32)
        xs["valid"] = np.zeros((Wp, npad), bool)
        xs["nseg_b"] = np.zeros((Wp, G), np.int64)
        xs["reweight"] = np.zeros((Wp,), bool)
        xs["win_valid"] = np.zeros((Wp,), bool)
        xs["wend"] = np.zeros((Wp,))
        xs["cur_event"] = np.zeros((Wp,), np.int64)
        for i, (r, mt) in enumerate(zip(plant["rows"], plant["meta"])):
            n3 = len(r["ev_lo"])
            for k, _ in _XS_SPEC:
                xs[k][i, :n3] = r[k]
            xs["valid"][i, :n3] = True
            for k in ("nseg_b", "reweight", "win_valid", "wend", "cur_event"):
                xs[k][i] = mt[k]
        return xs, Wp

    def _initial_carry(self):
        cfg = self.cfg
        M = cfg.n_members
        cal0 = host_calendar(np.arange(M, dtype=np.int32), np.ones((M,)),
                             n_slots=CALENDAR_SLOTS)
        # all ring entries start as (start 0, epoch-0 calendar): starts stay
        # sorted ascending across shift-appends, and "newest start <= event"
        # always picks the live epoch — duplicated oldest rows are harmless
        return dict(
            dl_busy=np.full((M,), -np.inf),
            farm_w=np.zeros((M,)), farm_t=np.zeros((M,)),
            ring_hi=np.zeros((_RING,), np.int64),
            ring_lo=np.zeros((_RING,), np.int64),
            ring_cal=np.tile(cal0.astype(np.int32), (_RING, 1)),
            cur_start=np.int64(0),
            weights=np.ones((M,)), integral=np.zeros((M,)),
            sched_w=np.ones((M,)),
            buckets=np.zeros((M, cfg.timeout_windows), np.int64))

    def _params(self):
        cfg = self.cfg
        farm = self.sim.farm.cfg
        M = cfg.n_members
        return dict(
            per_pkt=farm.per_packet_s, per_byte=farm.per_byte_s,
            cap_s=farm.capacity_s,
            link_rate=np.float64(cfg.member_link.rate_Bps),
            dl_prop=np.float64(cfg.member_link.prop_delay_s),
            target=np.float64(0.5), kp=np.float64(0.5), ki=np.float64(0.1),
            min_w=np.float64(0.05), max_w=np.float64(8.0),
            cap_pkts=np.float64(cfg.queue_capacity_pkts),
            cap_div=np.float64(max(cfg.queue_capacity_pkts, 1)),
            horizon=np.int64(max(16, 8 * cfg.triggers_per_step)),
            rw_thresh=np.float64(0.05),
            # the ring's lb_route tables: 8 padding segments on row 0, then
            # the ring's rows; members are plain ids with no lanes
            seg_row=np.concatenate([np.zeros(_PAD), np.arange(_RING)]).astype(np.int32),
            member_node=np.arange(M, dtype=np.int32),
            member_zero=np.zeros((M,), np.int32),
            member_one=np.ones((M,), np.int32))

    def _run_device(self, xs, Wp):
        K = self.superblock
        carry, params = self._initial_carry(), self._params()
        spec = {n: (v.shape[1:], torch.from_numpy(v[:1]).dtype) for n, v in xs.items()}
        key = (str(self.device), K, self.cfg.n_members, self.cfg.timeout_windows) + tuple(
            (n, s) for n, (s, _) in sorted(spec.items()))
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = _Program(carry, params, spec, K, self.device)
        else:
            prog.load(carry, params)
        self.program = prog
        chunks = []
        traced = self.sim.trace is not None
        for s in range(0, Wp, K):
            ys, ms, copy_s = prog.run({n: v[s:s + K] for n, v in xs.items()}, rows=traced)
            self.n_superblocks += 1
            self.replay_ms.append(ms)
            if traced:
                self.row_copy_s.append(copy_s)
                self.row_copy_bytes += sum(ys[n].nbytes for n in ROW_OUTPUTS)
            chunks.append(ys)
        self.final_carry = prog.final_carry()
        return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}

    def state_digest(self) -> tuple:
        """Cross-superblock carry state, hashable — K=1 and K=8 splits must
        land on identical digests."""
        fc = self.final_carry
        assert fc is not None, "run() first"
        return tuple((k, np.asarray(fc[k]).tobytes()) for k in sorted(fc))

    # -- accounting replication (host dict bookkeeping, vectorized) --------
    def _vanished(self, plant, ys):
        """Replicates ``Simulator._purge_vanished``: a bundle's emit entry
        is popped at completion, at reassembly timeout (the timeout-th push
        of its member after entry), or counted vanished at the first purge
        step past the horizon that finds it still tracked."""
        cfg = self.cfg
        W, G, M = plant["W"], plant["G"], cfg.n_members
        T = cfg.timeout_windows
        horizon = max(4 * (T or 1), 64)
        done = ys["done_b"][:W]
        anyb = ys["any_b"][:W]
        memb = ys["mem_b"][:W]
        recv = np.asarray(ys["acc_m"][:W]) > 0
        big = np.iinfo(np.int64).max
        pop = np.full((W, G), big)
        wcol = np.repeat(np.arange(W)[:, None], G, axis=1)
        pop[done] = wcol[done]
        pend = anyb & ~done
        for m in range(M):
            rw = np.flatnonzero(recv[:, m])
            if len(rw) == 0:
                continue
            pos_of = np.full((W,), -1, np.int64)
            pos_of[rw] = np.arange(len(rw))
            ws, gs = np.nonzero(pend & (memb == m))
            if len(ws) == 0:
                continue
            tgt = pos_of[ws] + T
            has = tgt < len(rw)
            pop[ws, gs] = np.where(has, rw[np.minimum(tgt, len(rw) - 1)], big)
        vanished = 0
        alive = np.ones((W, G), bool)
        for P in range(31, W, 32):
            q = alive & (wcol < P - horizon) & (pop > P)
            vanished += int(q.sum())
            alive &= ~q
        return vanished

    # -- host-side observation replay (tracing + live metrics) --------------
    def _trace_window(self, tb, w, plant, ys, sel, pid0: int) -> int:
        """Materialize one window's spans from the plant's host-side stage
        boundaries plus the step's returned per-row arrays — the span set
        the host engine records inline."""
        r, mt = plant["rows"][w], plant["meta"][w]
        key_b = bundle_key(plant["ev"][w], plant["daq"][w])
        tb.record_window("emit_wait", key_b, mt["t0"], plant["emit"][w])
        n3 = len(r["ev_lo"])
        if n3:
            key_r = bundle_key(r["ev"], r["daq"])
            pid_r = np.uint64(pid0) + np.arange(n3, dtype=np.uint64)
            tb.record_window("uplink", key_r, r["t_emit"], r["t_up"], pid=pid_r)
            tb.record_window("wan", key_r, r["t_up"], r["t_lb"], pid=pid_r)
            tb.record_window("lb", key_r, r["t_lb"], r["t_out"], pid=pid_r)
            memb = ys["memb"][w, :n3].astype(np.int64)
            keep = r["keep"]
            t_cn = ys["t_cn"][w, :n3]
            tb.record_window("downlink", key_r[keep], r["t_out"][keep],
                             t_cn[keep], pid=pid_r[keep], aux=memb[keep])
            acc = ys["acc"][w, :n3]
            dep = ys["farm_dep"][w, :n3]
            m_acc = memb[acc]
            fc = self.sim.farm.cfg
            svc = fc.per_packet_s[m_acc] + r["bytes"][acc] * fc.per_byte_s[m_acc]
            tb.record_window("farm_wait", key_r[acc], t_cn[acc],
                             dep[acc] - svc, pid=pid_r[acc], aux=m_acc)
            tb.record_window("service", key_r[acc], dep[acc] - svc, dep[acc],
                             pid=pid_r[acc], aux=m_acc)
            if len(sel):
                keys_done = bundle_key(plant["ev"][w, sel], plant["daq"][w, sel])
                rmin = np.full((plant["G"],), np.inf)
                np.minimum.at(rmin, r["lidx"][acc], dep[acc])
                t_done = ys["t_done_b"][w, sel]
                tb.record_window("reassembly", keys_done, rmin[sel], t_done)
                tb.complete_window(keys_done, plant["emit"][w, sel], t_done)
        return pid0 + n3

    def _observe(self, plant, ys, sels) -> None:
        """Replay the host engine's per-window observation — trace spans
        and ``_emit_metrics`` (same registry updates, same JSONL rows, same
        virtual timestamps) — from the superblocks' returned arrays."""
        sim = self.sim
        tb = sim.trace
        pid0 = 0
        cum_sent = cum_dlv = cum_sw = cum_timed = 0
        if sim.metrics is not None:
            # the host engine's pending gauge leaves out its reassemblers'
            # timed-out groups; the fused engine has no reassemblers and
            # counts those groups in its step instead
            sim.metrics.gauge("simnet_bundles_pending").set_function(
                lambda: sim.bundles_sent - len(sim.latencies) - cum_timed)
        for w in range(plant["W"]):
            sel = sels[w]
            if tb is not None:
                pid0 = self._trace_window(tb, w, plant, ys, sel, pid0)
                tb.end_window()
            r = plant["rows"][w]
            cum_sent += r["sent"]
            cum_dlv += len(r["ev_lo"])
            cum_sw += int(ys["switched"][w])
            cum_timed += int(ys["timed"][w])
            if len(sel):
                sim.latencies.extend(
                    (ys["t_done_b"][w, sel] - plant["emit"][w, sel]).tolist())
                if tb is not None:
                    keys = bundle_key(plant["ev"][w, sel], plant["daq"][w, sel])
                    sim._lat_keys.extend(int(k) for k in keys)
            if sim.metrics is not None:
                sim.packets_sent = cum_sent
                sim.packets_delivered = cum_dlv
                sim.epoch_switches = cum_sw
                sim.bundles_sent = plant["G"] * (w + 1)
                sim.clock.advance_to(float(plant["meta"][w]["wend"]))
                sim._emit_metrics(w, ys["fill"][w])
        if sim._ts_writer is not None:
            sim._ts_writer.close()

    def run(self) -> SimReport:
        t_wall = time.perf_counter()
        cfg, sim = self.cfg, self.sim
        plant = self._precompute()
        xs, Wp = self._stack_xs(plant)
        ys = self._run_device(xs, Wp)
        W, G, M = plant["W"], plant["G"], cfg.n_members

        # latencies in the host's append order: window, then member
        # ascending, then (event, daq) ascending within the member
        lats = []
        sels = []
        done = ys["done_b"][:W]
        for w in range(W):
            d = np.flatnonzero(done[w])
            if len(d) == 0:
                sels.append(d)
                continue
            order = np.lexsort((plant["daq"][w, d], plant["ev"][w, d],
                                ys["mem_b"][w, d]))
            sel = d[order]
            sels.append(sel)
            lats.extend((ys["t_done_b"][w, sel] - plant["emit"][w, sel]).tolist())
        lat = np.asarray(lats)
        if sim.trace is not None or sim.metrics is not None:
            self._observe(plant, ys, sels)
        completed = len(lats)
        pending = int(self.final_carry["buckets"].sum())
        timed_out = int(ys["timed"][:W].sum())
        dups = int(ys["dups"][:W].sum())
        qdrop = int(ys["qdrop"][:W].sum())
        discarded = int(ys["invalid"][:W].sum())
        vanished = self._vanished(plant, ys)
        bundles_sent = W * G

        acc_tot = np.asarray(ys["acc_m"][:W]).sum(axis=0)
        per_member = {int(m): int(acc_tot[m]) for m in range(M) if acc_tot[m] > 0}
        trajectory = [
            (w, {m: round(float(ys["weights"][w, m]), 4) for m in range(M)})
            for w in range(W) if xs["reweight"][w]]
        fill_trace = [
            (float(xs["wend"][w]), [round(float(f), 4) for f in ys["fill"][w]])
            for w in range(W)]
        weights = {str(m): round(float(self.final_carry["weights"][m]), 4)
                   for m in range(M)}

        violations = []
        # split events / corrupt bundles are impossible by construction in
        # fused scope: every segment of a bundle shares its event number
        # (one member), is emitted in one window and payloads are never
        # touched after segmentation
        lost_wan = sim.wan.n_lost + sim.daq_uplinks.n_lost
        lossless = (lost_wan == 0 and plant["lost_dl"] == 0
                    and qdrop == 0 and discarded == 0)
        if lossless and completed + pending + timed_out < bundles_sent:
            violations.append("bundles unaccounted with zero loss")

        return SimReport(
            scenario=sim.scenario.name if sim.scenario else "custom",
            steps=cfg.steps,
            sim_time_s=plant["sim_time"],
            wall_s=time.perf_counter() - t_wall,
            packets_sent=plant["packets_sent"],
            packets_delivered=plant["packets_delivered"],
            packets_lost_wan=lost_wan,
            packets_lost_downlink=plant["lost_dl"],
            packets_dropped_queue=qdrop,
            packets_discarded_invalid=discarded,
            duplicates_absorbed=dups,
            bundles_sent=bundles_sent,
            bundles_completed=completed,
            bundles_pending=pending,
            bundles_timed_out=timed_out,
            bundles_vanished=vanished,
            latency_p50_s=float(np.percentile(lat, 50)) if completed else 0.0,
            latency_p99_s=float(np.percentile(lat, 99)) if completed else 0.0,
            latency_max_s=float(lat.max()) if completed else 0.0,
            latency_mean_s=float(lat.mean()) if completed else 0.0,
            epoch_switches=int(ys["switched"][:W].sum()),
            final_weights=weights,
            weight_trajectory=trajectory,
            queue_fill_trace=fill_trace,
            per_member_segments=per_member,
            violations=violations,
            engine="fused",
        )
