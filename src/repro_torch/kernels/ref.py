"""Plain PyTorch versions of every CUDA kernel in this package.

Each wrapper (``lb_route``, ``dispatch_plan``, ``seg_masks``,
``flash_attention``) takes these for tensors on the CPU; ``chip_smoke.py``
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
