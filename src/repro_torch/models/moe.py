"""Mixture-of-Experts FFN with capacity-based dispatch.

Port of the JAX package's ``repro/models/moe.py``. The dispatch is the
EJ-FAT pack applied to tokens: each (token, k) assignment is a "packet"
whose "member" is the chosen expert, its buffer position is its arrival
rank within that member, and capacity overflow is dropped *and accounted*
(the paper's discard rule). The positions come from the hand-written
``kernels.dispatch.dispatch_plan`` kernel, one launch per layer call, over
the group-offset members ``group * E + expert`` (``n_members = g * E``):
positions within a (group, expert) then count only that group's packets in
arrival order, which is the reference's ``vmap`` of
``core/router.member_positions`` over the groups. A CPU tensor takes the
kernel's plain version; a CUDA tensor launches the kernel or raises.

Dispatch groups (``cfg.moe_dispatch_groups > 1``): the token stream splits
into g groups, each with its own capacity slice, as in the reference (which
shards them over the data axes; the port runs one device, so the groups
change only which packets contend for a slot). The expert products are
plain batched matrix products (``torch.bmm`` over the experts), as the
reference leaves its einsums to XLA. The expert buffer is laid out
``[E, g * C, d]`` where the reference's is ``[g, E, C, d]``: the same rows,
so the products need no transpose.

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
    ``group * E + expert``."""
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


def _stream_offsets(gate_idx: torch.Tensor, n_experts: int, slots) -> torch.Tensor:
    """int64 [K, E]: for this rank's choice-j packets of expert x, the
    packets of the microbatch's k-major stream before them that this rank
    does not hold: every other rank's choices below j, and the earlier
    ranks' choice j (one ``all_gather`` of the per-choice expert counts)."""
    k = gate_idx.shape[1]
    local = torch.zeros(k, n_experts, dtype=torch.int64, device=gate_idx.device)
    local.scatter_add_(1, gate_idx.t().long(), torch.ones_like(gate_idx.t(), dtype=torch.int64))
    parts = slots.parts(local)
    mine = slots.members.index(slots.rank)
    others = sum(parts) - local
    return torch.cumsum(others, 0) - others + sum(parts[:mine], torch.zeros_like(local))


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

    # the microbatch's tokens: this rank's n, times its ranks in a step
    # over several (distributed.dp), whose token streams follow each other
    # in rank order
    slots = dp.current()
    size = 1 if slots is None else slots.size
    n_all = n * size
    g = max(int(getattr(cfg, "moe_dispatch_groups", 1) or 1), 1)
    if n_all % g:
        g = 1
    ng = n_all // g

    # k-major flatten within each group: first-choice packets dispatch
    # before any second-choice ones (first choices win capacity contention).
    # The capacity floor of 8 keeps small serving batches drop-free; the
    # ng*k cap never allocates more slots than assignments.
    capacity = min(ng * k, max(int(cfg.capacity_factor * ng * k / e) + 1, 8))
    if g > 1 and g % size:
        raise NotImplementedError(
            f"{cfg.name}: {g} dispatch groups over {size} ranks: a group would span ranks "
            "(take a multiple of the ranks, or 1)")
    spans = g == 1 and size > 1  # one group over the ranks' streams
    g = max(g // size, 1)  # this rank's groups: whole groups, or its part of the one
    ng = n // g
    member_g = gate_idx.reshape(g, ng, k).transpose(1, 2).reshape(g, k * ng)
    pos = pack_positions(member_g, e)
    if spans:
        pos = pos + _stream_offsets(gate_idx, e, slots)[
            torch.arange(k, device=x.device).repeat_interleave(n), member_g[0]][None]
    keep = pos < capacity

    # Scatter into the [E, g*C, d] buffer; a dropped packet goes to a spill
    # row past the end (the reference's out-of-bounds index, mode="drop").
    group = torch.arange(g, device=x.device)[:, None]
    slot = (member_g * g + group) * capacity + pos  # [g, K*ng]
    spill = e * g * capacity
    # tensor parallelism with ``ff`` split: the buffer's rows enter through
    # ``to_parallel`` as tokens (the router reads them whole), and the
    # ranks' shares of the products are added once gathered back to the
    # tokens' k slots, before the gates: far fewer rows than the buffer's
    # capacity, and the gates' gradient sees the whole output
    par = tp.current()
    kind = None if par is None else par.kind(params["w_up"])
    src = (par.to_parallel(xt) if kind == "model" else xt).reshape(g, ng, d).repeat(1, k, 1).reshape(
        g * k * ng, d)
    buf = x.new_zeros(spill + 1, d).index_copy(
        0, torch.where(keep, slot, spill).reshape(-1), src)
    buf = buf[:spill].view(e, g * capacity, d)

    out_buf = expert_products(params, buf, cfg.act).reshape(spill, d)

    # Gather back and combine with the gates; dropped assignments give 0.
    got = out_buf.index_select(0, torch.where(keep, slot, 0).reshape(-1))
    if kind == "model":
        got = par.from_parallel(got)
    elif kind == "wide":
        got = dp.all_reduce(got.contiguous(), par.wide.ranks.group)
    got = torch.where(keep.reshape(-1, 1), got, torch.zeros((), dtype=got.dtype,
                                                            device=got.device))
    gates_g = gate_vals.reshape(g, ng, k).transpose(1, 2).reshape(g, k * ng)
    combined = (got.to(F32).view(g, k * ng, d) * gates_g[..., None]).view(
        g, k, ng, d).sum(1)
    y = combined.to(x.dtype).reshape(b, t, d)

    # Aux: Switch-style load-balance loss + drop accounting. Over several
    # ranks, ``me`` is this rank's share of the mean router prob and ``ce``
    # the microbatch's kept fraction, so the ranks' aux losses (and their
    # gradients) add up to the microbatch's.
    me = probs.sum(0) / n_all  # [E] mean router prob
    ce = dp.slot_sum(torch.zeros(e, dtype=F32, device=x.device).index_add_(
        0, member_g.reshape(-1), keep.reshape(-1).to(F32))) / max(n_all * k, 1)
    aux_loss = e * torch.sum(me * ce)
    dropped = torch.sum(~keep)  # every packet's expert is in [0, E)
    return y, {"aux_loss": aux_loss, "dropped": dropped}
