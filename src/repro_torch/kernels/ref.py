"""Plain PyTorch versions of every CUDA kernel in this package.

Each wrapper (``lb_route``, ``dispatch_plan``, ``seg_masks``,
``flash_attention``, and the simulator's ``farm_serve``, ``seq_cumsum``
and ``build_calendar``) takes these for tensors on the CPU; ``chip_smoke.py``
holds each kernel against them on the card. The routing version is
core/router.py itself (the single source of the protocol semantics); the
dispatch-plan version is the sort-based pack of core/router.member_positions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import router as _router
from repro_torch.core.protocol import decode_fields
from repro_torch.core.tables import DeviceTables


def lb_route_ref(headers, tables: DeviceTables, instance_id=None):
    """Plain version of kernels/lb_route.lb_route (single or stacked tables).

    The multi-instance version is deliberately the naive N-way form — route
    through every instance's tables, then select by instance id — so it is
    an independent check of the fused per-packet gather.
    """
    f = decode_fields(headers)
    if instance_id is None:
        r = _router.route(tables, f["event_hi"], f["event_lo"], f["entropy"],
                          header_words=headers)
        return r.member, r.node, r.lane, r.valid.to(torch.int32)

    n_inst = tables.seg_row.shape[0]
    iid = instance_id.to(torch.int64).clamp(0, n_inst - 1)
    per = [_router.route(tables.instance(i), f["event_hi"], f["event_lo"],
                         f["entropy"], header_words=headers)
           for i in range(n_inst)]

    def sel(field):
        out = getattr(per[0], field).to(torch.int32)
        for i in range(1, n_inst):
            out = torch.where(iid == i, getattr(per[i], field).to(torch.int32), out)
        return out

    return sel("member"), sel("node"), sel("lane"), sel("valid")


def dispatch_plan_ref(member, *, n_members: int):
    """Plain version of kernels/dispatch.dispatch_plan (capacity-free)."""
    pos, _keep, counts = _router.member_positions(member, n_members, capacity=2**30)
    pos = torch.where(member >= 0, pos, torch.full_like(pos, -1))
    return pos.to(torch.int32), counts.to(torch.int32)


def seg_masks_ref(valid, ev_hi, ev_lo, daq, seg_index):
    """Plain version of kernels/reassembly.seg_masks (sorted-row compare).

    Columns may be int32 (u32 bit patterns) or int64; equality is all that
    is asked of them, and a nonzero ``valid`` marks a real row.
    """
    def prev(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

    same = ((prev(valid) != 0) & (ev_hi == prev(ev_hi)) & (ev_lo == prev(ev_lo))
            & (daq == prev(daq)))
    ok = valid != 0
    new_group = (ok & ~same).to(torch.int32)
    dup = (ok & same & (seg_index == prev(seg_index))).to(torch.int32)
    return new_group, dup


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version of kernels/flash_attention.flash_attention: softmax
    attention with the whole [B, H, Tq, Tk] logit matrix, in fp32.

    q ``[B, Tq, Hq, d]``, k/v ``[B, Tk, Hkv, d]``; the KV heads are repeated
    to Hq, the causal mask is the bottom-right ``tril(Tk - Tq)`` (the JAX
    oracle ``repro.kernels.ref.flash_attention_ref``), and the result is cast
    back to q's dtype.
    """
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def farm_serve_ref(t, s, offsets, w0, t0, cap):
    """Plain version of kernels/farm_serve.farm_serve: the bounded Lindley
    recursion of the farm queues as the JAX package's ``_serve_np`` runs it,
    one column of every member's queue per step, in float64.

    Rows are sorted by (member, arrival, row), member m's at
    ``[offsets[m], offsets[m + 1])``; rows past ``offsets[-1]`` keep
    ``dep = inf``, ``drop = False``. Returns ``(dep, drop, w, t_last, w_max)``.
    """
    n_members = w0.shape[0]
    counts = offsets[1:].long() - offsets[:-1].long()
    base = offsets[:-1].long()
    dep = torch.full_like(t, math.inf)
    drop = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    w, t_last, w_max = w0.clone(), t0.clone(), w0.clone()
    zero = torch.zeros_like(w)
    t_cols = int(counts.max()) if n_members and t.shape[0] else 0
    for j in range(t_cols):
        v = counts > j
        rows = torch.where(v, base + j, torch.zeros_like(base))
        tt = torch.where(v, torch.maximum(t[rows], t_last), t_last)
        w = torch.maximum(w - (tt - t_last), zero)
        s_col = torch.where(v, s[rows], zero)
        d = v & (w + s_col > cap)
        acc = v & ~d
        dep[rows[v]] = torch.where(acc, (tt + w) + s_col, math.inf)[v]
        drop[rows[v]] = d[v]
        w = torch.where(acc, w + s_col, w)
        w_max = torch.maximum(w_max, w)
        t_last = tt
    return dep, drop, w, t_last, w_max


def seq_cumsum_ref(x):
    """Plain version of kernels/seq_cumsum.seq_cumsum: the float64 inclusive
    running sum added in row order, as ``np.cumsum`` adds. PyTorch's CPU
    cumsum adds in that order; its CUDA cumsum adds in a tree, so a card
    tensor's sum is taken on the CPU. PyTorch's sum starts from +0.0 and
    numpy's from ``x[0]``; the two differ only while every value so far is
    -0.0 (numpy keeps -0.0, ``+0.0 + -0.0`` is +0.0), so that run is set
    back to -0.0."""
    xc = x.cpu()
    out = torch.cumsum(xc, 0)
    lead = torch.cummin(((xc == 0) & torch.signbit(xc)).to(torch.int8), 0).values.bool()
    out[lead] = -0.0
    return out.to(x.device)


def _np_sum_block(x, m: int):
    """numpy's pairwise sum of ``m <= 128`` lanes: in order below 8 lanes;
    above, eight running sums with numpy's fixed combine tree, then the
    tail."""
    if m < 8:
        acc = x[0]
        for i in range(1, m):
            acc = acc + x[i]
        return acc
    r = [x[j] for j in range(8)]
    i = 8
    while i < m - (m % 8):
        for j in range(8):
            r[j] = r[j] + x[i + j]
        i += 8
    acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, m):
        acc = acc + x[k]
    return acc


def np_sum(x, m: int):
    """numpy's pairwise ``add.reduce`` over the first ``m`` lanes of ``x``,
    association for association, at any length: blocks of up to 128 lanes
    (numpy's ``PW_BLOCKSIZE``) as ``_np_sum_block``; above 128 the sums of
    the two halves, the first cut down to a multiple of 8, added. (The JAX
    package's ``simnet/fused.py::_np_sum`` stops at 128 lanes.)"""
    if m <= 128:
        return _np_sum_block(x, m)
    h = m // 2 - (m // 2) % 8
    return np_sum(x[:h], h) + np_sum(x[h:], m - h)


def build_calendar_ref(w, do_sw, out):
    """Plain version of kernels/calendar.build_calendar: when ``do_sw``
    holds, the ``out.shape[0]``-slot calendar of weights ``w`` (float64[M],
    all positive) written into ``out`` — largest-remainder quotas, smooth
    weighted round-robin, then the quota-enforcing walk, op for op with the
    JAX package's ``simnet/fused.py::_device_calendar``; otherwise ``out``
    as it was. Returns ``out``."""
    if not bool(do_sw):
        return out
    m, n_slots = w.shape[0], out.shape[0]
    ideal = w / np_sum(w, m) * n_slots
    counts = torch.floor(ideal).long()
    counts = torch.where(counts == 0, torch.ones_like(counts), counts)
    rem = ideal - torch.floor(ideal)
    for _ in range(m):  # surplus
        over = torch.where(counts > 1, counts.double() - ideal, -math.inf)
        pick = int(torch.argmax(over))
        counts[pick] -= int(counts.sum() > n_slots)
    order = torch.sort(-rem, stable=True).indices.tolist()
    for i in range(m):  # deficit
        counts[order[i]] += int(counts.sum() < n_slots)

    remaining = counts.double()
    credit = torch.zeros_like(w)
    cal = []
    for _ in range(n_slots):  # smooth weighted round-robin
        credit = credit + remaining
        pick = int(torch.argmax(credit))
        credit[pick] += -float(n_slots)
        cal.append(pick)

    want = counts.tolist()
    have = [0] * m
    for c in cal:
        have[c] += 1
    def_ids = [k for k in range(m) if have[k] < want[k]]
    len_def = len(def_ids)
    need = [want[k] - have[k] if have[k] < want[k] else 0 for k in range(m)]
    def_ids += [m] * (m - len_def)
    di = 0
    for sl, c in enumerate(cal):  # the quota-enforcing walk
        d = min(def_ids[min(di, m - 1)], m - 1)
        if have[c] > want[c] and di < len_def:
            have[c] -= 1
            have[d] += 1
            need[d] -= 1
            cal[sl] = d
            if need[d] == 0:
                di += 1
    out.copy_(torch.tensor(cal, dtype=out.dtype))
    return out
