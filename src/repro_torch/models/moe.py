"""Mixture-of-Experts FFN with capacity-based dispatch.

Port of the JAX package's ``repro/models/moe.py``. The dispatch is the
EJ-FAT pack applied to tokens: each (token, k) assignment is a "packet"
whose "member" is the chosen expert, its buffer position is its arrival
rank within that member, and capacity overflow is dropped *and accounted*
(the paper's discard rule). The positions come from the hand-written
``kernels.dispatch.dispatch_plan`` kernel, one launch per layer call, over
the group-offset members ``group * E + expert``: positions within a
(group, expert) then count only that group's packets in arrival order,
which is the reference's ``vmap`` of ``core/router.member_positions`` over
the groups. A CPU tensor takes the kernel's plain version; a CUDA tensor
launches the kernel or raises.

Dispatch groups (``cfg.moe_dispatch_groups > 1``): the token stream splits
into g contiguous groups, each with its own capacity slice, as in the
reference (which shards them over the data axes). In a training step over
several ranks (``distributed.dp``'s slots) the stream is the microbatch's:
its ranks' tokens in rank order, unequal counts allowed, and a group may
span ranks or cut within one. Each rank packs its own tokens' packets
(one kernel call over the groups they meet) and adds the packets of each
group ahead of them that other ranks hold (one ``all_gather`` of every
rank's per-group, per-choice expert counts, from which the kept counts of
the aux loss follow too; where each microbatch of the round lies within
one rank, or in one process, no counts are exchanged). The expert products are plain batched matrix
products (``torch.bmm`` over the experts), as the reference leaves its
einsums to XLA. The expert buffer is laid out ``[E, h * C, d]`` over the h
groups this rank's tokens meet, where the reference's is ``[g, E, C, d]``:
the same rows, so the products need no transpose.

arctic-480b additionally runs a dense residual FFN in parallel with the MoE
output (``cfg.moe_dense_residual``).

Under tensor parallelism (``distributed.tp``) the router, top-k and the
pack run on every rank of the model group on the same (replicated) tokens;
the expert products are split on ``ff``, and their shares are added (one
``all_reduce``) on the rows gathered back to the tokens. Under ``seqpar``
those tokens are the stream's parts gathered (one ``all_gather``), the
pack's label and expert counts stay the microbatch's, and the layer keeps
the rank's part of its output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import dp
from repro_torch.distributed import tp
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.models import layers as L

F32 = torch.float32


def _expert_stack_init(generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """``layers.dense_init`` of an ``[E, ...]`` stack with the reference's
    fan-in (its first dim, E), drawn one expert at a time so that the
    float32 draw of a whole stack (17.8 GB for one of Arctic's) is never
    held on the device."""
    std = scale / (shape[0] ** 0.5)
    w = torch.empty(shape, dtype=dtype, device=device)
    for w_e in w:
        draw = torch.empty(shape[1:], dtype=F32, device=device)
        torch.nn.init.trunc_normal_(draw, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        w_e.copy_(draw.mul_(std))
    return w


def moe_init(generator: torch.Generator, cfg, dtype, device="cuda"):
    """Router (float32 whatever ``cfg.dtype`` is, as in the reference),
    ``w_gate``/``w_up`` ``[E, d, ff]``, ``w_down`` ``[E, ff, d]`` and, with
    ``cfg.moe_dense_residual``, a dense ``mlp``."""
    dev = resolve_device(device)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    p = {
        "router": L.dense_init(generator, (d, e), 1.0, F32, dev),
        "w_gate": _expert_stack_init(generator, (e, d, ff), 1.0, dtype, dev),
        "w_up": _expert_stack_init(generator, (e, d, ff), 1.0, dtype, dev),
        "w_down": _expert_stack_init(generator, (e, ff, d), out_scale, dtype, dev),
    }
    if cfg.moe_dense_residual:
        p["dense"] = L.mlp_init(generator, d, ff, cfg.act, cfg.n_layers, dtype, dev)
    return p


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, largest first,
    a tie going to the lower index (a stable descending sort's first k
    columns; ``torch.topk`` orders ties otherwise, which would pick other
    experts and change who drops)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_positions(member_g: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``member_g`` int ``[g, P]`` (each group's packets, experts in
    ``[0, E)``) -> int32 ``[g, P]``: each packet's arrival rank within its
    (group, expert), from one ``dispatch_plan`` call over the members
    ``group * E + expert``: the pack of a whole stream's g groups, which
    ``_routed`` forms over the groups that a rank's packets meet."""
    g = member_g.shape[0]
    offset = torch.arange(g, device=member_g.device)[:, None] * n_experts
    members = (member_g + offset).reshape(-1).to(torch.int32).contiguous()
    pos, _counts = _dispatch.dispatch_plan(members, n_members=g * n_experts)
    return pos.view(member_g.shape)


def expert_products(params, buf, act: str) -> torch.Tensor:
    """Each expert's FFN over its rows: ``buf`` ``[E, R, d]`` -> ``[E, R, d]``
    (batched matrix products over the experts, the reference's einsums).
    With the experts' ``ff`` split over "model" the result is this rank's
    share of the sum over ``ff`` (``moe_ffn`` adds the shares)."""
    if act == "swiglu":
        h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    else:
        h = F.gelu(torch.bmm(buf, params["w_up"]), approximate="tanh")
    return torch.bmm(h, params["w_down"])


def moe_ffn(params, x, cfg):
    """x: [B, T, d] -> ([B, T, d], {"aux_loss", "dropped"}): the Switch-style
    load-balance loss and the count of assignments past capacity.

    Under the layouts of ``distributed.tp``: with ``seq`` the layer routes
    the stream's tokens whole and keeps the rank's part of the output (in
    training the aux loss, computed whole on every rank, counts as its
    ``1 / size`` share in ``model.train_loss``); with the experts split over
    every rank (serving's ``wide``) it routes every data rank's rows (one
    process's dispatch over the batch) and keeps this rank's."""
    par = tp.current()
    kind = None if par is None else par.kind(params["w_up"])
    y_in = x
    if par is not None:
        x = par.full(x)
    if kind == "wide":
        with dp.use_slots(None):
            y, aux = _routed(params, par.rows_all(x), cfg)
        y = par.rows_mine(y)
    else:
        y, aux = _routed(params, x, cfg)
    if par is not None:
        y = par.part(y)
    if cfg.moe_dense_residual:
        y = y + L.mlp(params["dense"], y_in, cfg.act)
    return y, aux


def _routed(params, x, cfg):
    """``moe_ffn``'s routed experts over the tokens of ``x``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    xt = x.reshape(n, d)

    logits = xt.to(F32) @ params["router"]  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # [N, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # the microbatch's token stream: over several ranks (distributed.dp)
    # their streams follow each other in rank order, and this rank's n
    # tokens start at ``off``; a dispatch group is a contiguous range of
    # that stream, which may span ranks or cut within one. Every rank of
    # the round takes g from the round's microbatch (an idle rank too), so
    # that the counts they exchange have one shape.
    slots = dp.current()
    off, n_all, mine = 0, n, 0
    if slots is not None:
        toks = [rows * t for rows in slots.rows(b)]
        mine = slots.members.index(slots.rank)
        off, n_all = sum(toks[:mine]), slots.round_rows(b) * t
    g = max(int(getattr(cfg, "moe_dispatch_groups", 1) or 1), 1)
    if n_all % g:
        g = 1
    ng = n_all // g

    # k-major within each group: first-choice packets dispatch before any
    # second-choice ones (first choices win capacity contention). The
    # capacity floor of 8 keeps small serving batches drop-free; the ng*k
    # cap never allocates more slots than assignments.
    capacity = min(ng * k, max(int(cfg.capacity_factor * ng * k / e) + 1, 8))
    dev = x.device
    g0 = off // max(ng, 1)  # the first group this rank's tokens meet
    h = (off + n - 1) // ng - g0 + 1 if n else 1  # the groups they meet
    grp = ((off + torch.arange(n, device=dev)) // max(ng, 1)).repeat(k)  # [K*n], choice-major
    expert = gate_idx.t().reshape(-1)
    # positions among this rank's packets of each (group, expert): one
    # dispatch_plan call over the members ``(group - g0) * E + expert`` in
    # choice-major order, which is k-major within every group
    members = ((grp - g0) * e + expert).to(torch.int32).contiguous()
    pos, held = _dispatch.dispatch_plan(members, n_members=h * e)
    pos = pos.long()
    if slots is None or slots.alone:
        # the microbatch's stream is this rank's (or, idle, it holds none
        # of it): nothing of it lies ahead on another rank
        kept = torch.clamp(held.view(h, e), max=capacity)
    else:
        # plus the packets of the group's stream ahead of them that the
        # slot's other ranks hold: their choices below j, and the earlier
        # ranks' choice j (one ``all_gather`` of every rank's [group,
        # choice, expert] counts)
        choice = torch.arange(k, device=dev).repeat_interleave(n)
        counts = torch.zeros(g * k * e, dtype=torch.int64, device=dev).index_add_(
            0, (grp * k + choice) * e + expert, torch.ones_like(expert, dtype=torch.int64)).view(
            g, k, e)
        parts = slots.parts(counts)
        total = sum(parts[1:], parts[0])
        others = total - counts
        ahead = torch.cumsum(others, 1) - others + sum(parts[:mine], torch.zeros_like(counts))
        pos = pos + ahead[grp, choice, expert]
        kept = torch.clamp(total.sum(1), max=capacity)
    keep = pos < capacity

    # Scatter into the [E, h*C, d] buffer (the reference's [g, E, C, d]
    # rows of this rank's groups, so the products need no transpose); a
    # dropped packet goes to a spill row past the end (the reference's
    # out-of-bounds index, mode="drop").
    slot = (expert * h + grp - g0) * capacity + pos  # [K*n]
    spill = e * h * capacity
    # tensor parallelism with ``ff`` split: the buffer's rows enter through
    # ``to_parallel`` as tokens (the router reads them whole), and the
    # ranks' shares of the products are added once gathered back to the
    # tokens' k slots, before the gates: far fewer rows than the buffer's
    # capacity, and the gates' gradient sees the whole output
    par = tp.current()
    kind = None if par is None else par.kind(params["w_up"])
    src = (par.to_parallel(xt) if kind == "model" else xt).repeat(k, 1)
    buf = x.new_zeros(spill + 1, d).index_copy(0, torch.where(keep, slot, spill), src)
    buf = buf[:spill].view(e, h * capacity, d)

    out_buf = expert_products(params, buf, cfg.act).reshape(spill, d)

    # Gather back and combine with the gates; dropped assignments give 0.
    got = out_buf.index_select(0, torch.where(keep, slot, 0))
    if kind == "model":
        got = par.from_parallel(got)
    elif kind == "wide":
        got = dp.all_reduce(got.contiguous(), par.wide.ranks.group)
    got = torch.where(keep.reshape(-1, 1), got, torch.zeros((), dtype=got.dtype,
                                                            device=got.device))
    combined = (got.to(F32).view(k, n, d) * gate_vals.t()[..., None]).sum(0)
    y = combined.to(x.dtype).reshape(b, t, d)

    # Aux: Switch-style load-balance loss + drop accounting. Over several
    # ranks, ``me`` is this rank's share of the mean router prob and ``ce``
    # the microbatch's kept fraction (a (group, expert) keeps the first
    # ``capacity`` of its packets), so the ranks' aux losses (and their
    # gradients) add up to the microbatch's.
    me = probs.sum(0) / max(n_all, 1)  # [E] mean router prob
    ce = kept.sum(0).to(F32) / max(n_all * k, 1)
    aux_loss = e * torch.sum(me * ce)
    dropped = torch.sum(~keep)  # every packet's expert is in [0, E)
    return y, {"aux_loss": aux_loss, "dropped": dropped}
