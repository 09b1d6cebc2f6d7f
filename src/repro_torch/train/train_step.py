"""The training step, with the EJ-FAT ingest stage as a first-class part.

Port of the JAX package's ``repro/train/train_step.py``. Pipeline inside one
step (``TrainConfig.lb_ingest``):
  1. Arrival-ordered event shards (tokens/labels/headers) land on each
     data-parallel rank — what the network delivered, NOT who owns the
     events.
  2. The LB data plane routes each event header through the epoch calendar
     (``DataPlane.route``: the ``lb_route`` kernel on the card).
  3. An ``all_to_all`` (``router.make_redistribute``) moves each event to
     its owning rank: the paper's "in-network sorting". Capacity overflow is
     dropped and accounted (masked labels, ``ingest_occupancy``).
  4. Forward/backward (+ microbatch accumulation), AdamW update in place.

The step runs eagerly (no jit): ``make_train_step`` returns a plain
function. A mesh with more than one data-parallel rank is taken by
``_ingest`` alone; the sharded step (``jit_train_step`` in the reference)
is not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dataplane import DataPlane
from repro_torch.core.protocol import words_to_tensor
from repro_torch.core.tables import DeviceTables
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import compress_decompress
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: bool = True
    accum_steps: int = 1
    lb_ingest: bool = True
    grad_compress: bool = False
    q_chunk: int = 1024
    k_chunk: int = 1024
    rwkv_chunk: int = 1


def init_train_state(generator: torch.Generator, model_cfg: ModelConfig,
                     train_cfg: TrainConfig, device="cuda"):
    """Fresh state on ``device``: params drawn from ``generator`` (a
    ``torch.Generator`` on that device), zero moments, step 0."""
    dev = resolve_device(device)
    params = M.init_params(model_cfg, generator, dev)
    return {
        "params": params,
        "opt": opt.init(params, train_cfg.adamw),
        "efb": None,  # error-feedback residual (grad compression), lazy
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _as_tensor(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)


def _ingest(batch, tables: DeviceTables, mesh, global_batch: Optional[int] = None):
    """LB route + redistribution across the data-parallel ranks: a
    distributed counting sort. Returns (this rank's rows, their occupancy).

    Each arrival-ordered event is routed through the calendar to its owning
    member (the node id of its route); its destination row is ``node * cap +
    position``, where position is the exclusive running count of the
    node's events in global arrival order, and cap = B/W (the output batch
    is the input's size; overflow events are dropped and accounted, the
    paper's discard rule). Rank r holds arrival rows ``[r*B_r, (r+1)*B_r)``:
    its running count starts at its exclusive offset (an ``all_gather`` of
    every rank's per-member counts), and the rows travel to their owner by
    ``all_to_all_single`` (``make_redistribute``), so rank r ends with the
    rows that the reference's single-program scatter puts in shard r. With
    one rank there is no collective.
    """
    n_members = shd.data_extent(mesh)
    dev = tables.device
    dp = DataPlane(tables)
    headers = batch["headers"]
    if not isinstance(headers, torch.Tensor):
        headers = words_to_tensor(np.asarray(headers, np.uint32), dev)
    r = dp.route(headers)
    fields = {k: _as_tensor(v, dev) for k, v in batch.items() if k != "headers"}
    b_local = fields["labels"].shape[0]
    cap = max((global_batch or b_local * n_members) // n_members, 1)

    node = r.node.to(torch.int64)
    pos, _, counts = dp.member_positions(r.node, n_members, b_local)
    offset = torch.zeros(n_members, dtype=torch.int64, device=dev)
    if n_members > 1:
        rank = dist.get_rank(mesh.group)
        every = [torch.empty_like(counts) for _ in range(n_members)]
        dist.all_gather(every, counts, group=mesh.group)
        offset = torch.stack(every)[:rank].sum(0).to(torch.int64)
    valid = (node >= 0) & (node < n_members)
    gpos = pos.to(torch.int64) + offset[node.clamp(0, n_members - 1)]
    keep = valid & (gpos < cap)
    send_to = torch.where(keep, node, torch.full_like(node, -1))

    # every kept row fits its source's send buffer: capacity b_local
    exchange = dp.redistribute(mesh, shd.data_axes(mesh), b_local)
    got_pos, occ_rows = exchange(gpos, send_to)
    slot = torch.where(occ_rows > 0, got_pos, torch.full_like(got_pos, cap))

    def scatter_field(x, fill):
        recv, _ = exchange(x, send_to)
        buf = torch.full((cap + 1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        buf[slot] = recv
        return buf[:cap]

    out = {k: scatter_field(v, -1 if k == "labels" else 0) for k, v in fields.items()}
    occ = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    occ[slot] = 1
    return out, occ[:cap]


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh=None,
    global_batch: Optional[int] = None,
):
    """Returns step(state, batch, tables) -> (state, metrics). ``tables``
    may be None when lb_ingest is off. The batch is numpy or tensors; it is
    moved to the params' device. ``state`` is updated in place (params,
    moments) and returned."""
    if mesh is not None and shd.data_extent(mesh) > 1:
        raise NotImplementedError(
            "a training step over several data-parallel ranks (the reference's "
            "jit_train_step) is not ported yet (ROADMAP.md queue 1); _ingest takes such "
            "a mesh on its own")

    def loss_fn(params, mb):
        return M.train_loss(params, mb, model_cfg, remat=train_cfg.remat,
                            q_chunk=train_cfg.q_chunk, k_chunk=train_cfg.k_chunk,
                            rwkv_chunk=train_cfg.rwkv_chunk)

    def value_and_grad(params, mb):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss, met = loss_fn(params, mb)
        # a leaf the loss does not reach (the token embedding of an encoder
        # fed frame embeddings) gets a zero gradient, as jax.grad gives it
        grads = iter(torch.autograd.grad(loss, ps, materialize_grads=True))
        return (loss.detach(), {k: v.detach() for k, v in met.items()},
                tree_map(lambda p, stacked: next(grads), params))

    def grads_of(params, mb):
        if train_cfg.accum_steps <= 1:
            return value_and_grad(params, mb)
        a = train_cfg.accum_steps
        gsum, lsum = None, 0.0
        for i in range(a):
            sl = {k: v[i * (v.shape[0] // a):(i + 1) * (v.shape[0] // a)] if v.ndim >= 1 else v
                  for k, v in mb.items()}
            loss, _met, g = value_and_grad(params, sl)
            g32 = tree_map(lambda x, stacked: x.to(F32), g)
            gsum = g32 if gsum is None else tree_map(
                lambda acc, x, stacked: acc.add_(x), gsum, g32)
            lsum = lsum + loss
        return lsum / a, {}, tree_map(lambda x, stacked: x / a, gsum)

    def step(state, batch, tables):
        dev = state["step"].device
        metrics = {}
        if train_cfg.lb_ingest:
            if mesh is None or tables is None:
                raise ValueError("lb_ingest needs a mesh and the LB tables")
            mb, occ = _ingest(batch, tables, mesh, global_batch)
            metrics["ingest_occupancy"] = occ.to(F32).mean()
        else:
            mb = {k: _as_tensor(v, dev) for k, v in batch.items() if k != "headers"}

        loss, lmet, grads = grads_of(state["params"], mb)
        metrics.update(lmet)

        if train_cfg.grad_compress:
            # int8 round-trip + error feedback (the collective payload's
            # transform; compression.psum_compressed is the all-reduce)
            efb = state["efb"]
            if efb is None:
                efb = tree_map(lambda g, stacked: torch.zeros(g.shape, dtype=F32,
                                                                  device=g.device), grads)
            grads_fb = tree_map(lambda g, e, stacked: g.to(F32) + e, grads, efb)
            deq = tree_map(lambda g, stacked: compress_decompress(g), grads_fb)
            state = dict(state, efb=tree_map(lambda g, d, stacked: g - d, grads_fb, deq))
            grads = deq

        new_params, new_opt, omet = opt.update(grads, state["opt"], state["params"],
                                               train_cfg.adamw)
        metrics.update(omet)
        metrics["loss"] = loss
        return dict(state, params=new_params, opt=new_opt, step=state["step"] + 1), metrics

    return step

