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
function. Over the ranks of a mesh bound to a process group
(``launch.mesh``: W data ranks x T model ranks) each process runs the step
on its data rank's rows of the global batch (the T model ranks of one data
rank hold the same rows), and the step equals the reference's one program
over all of them: ``jit_train_step`` places params by ``param_sharding``
and each moment as its param (``sharding.moment_sharding``); each rank
keeps its (data, model) block (``distributed.sharding.shard_tree``),
gathers the params over the data axes for the forward and backward (FSDP),
keeps the model slices and runs the model tensor-parallel on them
(``distributed.tp``), sums the gradients over the data ranks
(``all_reduce``) and updates its blocks; the loss divides by the global
label count (``distributed.dp``). With ``accum_steps`` the global batch
splits into the reference's microbatches whatever the mesh: each rank runs
its pieces of them in rounds (``_rounds``), all ranks every round.
``make_train_step`` takes the placement as ``specs`` (needed over a
process group), or holds every leaf whole in one process. ``seqpar`` (the
reference's ``logical_rules(seq_axis="model")``, Megatron's sequence
parallelism) splits the residual stream over the T model ranks by sequence
between blocks: each rank's gradient of a whole leaf is then its tokens'
share, and the step adds the shares over the model group once.
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
from repro_torch.distributed import dp as DP
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.distributed.compression import compress_decompress
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, map_stacked, tree_map

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
                     train_cfg: TrainConfig, device="cuda", *, specs: Optional[dict] = None,
                     mesh=None):
    """Fresh state on ``device``: params drawn from ``generator`` (a
    ``torch.Generator`` on that device), zero moments, step 0. With
    ``specs`` (``placement``'s) the params are drawn whole and cut to this
    rank's blocks on ``mesh`` before the moments are made, so that no rank
    holds a whole moment: the same state as ``shard_state`` of the whole
    one (a zero moment's block is the zero moment of the block)."""
    dev = resolve_device(device)
    params = M.init_params(model_cfg, generator, dev)
    moments = None
    if specs is not None:
        # the moments of the params' blocks, then the leaves placed on the
        # layer list cut to the rank's layers
        params = shd.shard_tree(params, specs["params"], mesh, lists=False)
        moments = shd.shard_lists(opt.init(params, train_cfg.adamw), specs["opt"], mesh)
        params = shd.shard_lists(params, specs["params"], mesh)
    return {
        "params": params,
        "opt": opt.init(params, train_cfg.adamw) if moments is None else moments,
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
    node's events in global arrival order (``DataPlane.plan``), and cap =
    B/W (the output batch is the input's size; overflow events are dropped
    and accounted, the paper's discard rule). Rank r holds arrival rows
    ``[r*B_r, (r+1)*B_r)``: its running count starts at its exclusive
    offset (an ``all_gather`` of every rank's per-member counts), and the
    rows travel to their owner by ``all_to_all_single``
    (``make_redistribute``), so rank r ends with the rows that the
    reference's single-program scatter puts in shard r. With one rank there
    is no collective.
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
    pos, counts = dp.plan(r.node, n_members)  # the dispatch_plan kernel on the card
    offset = torch.zeros(n_members, dtype=torch.int64, device=dev)
    if n_members > 1:
        rank = dist.get_rank(mesh.group)
        offset = torch.stack(DP.all_gather(counts, mesh.group))[:rank].sum(0).to(torch.int64)
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


def _rounds(a: int, w: int, rank: int, rows: int) -> list:
    """Per round of this rank's forward/backward passes: (its rows in the
    round, every rank's microbatch in it, every rank's rows of it).

    The reference slices the global batch (the ranks' rows in rank order)
    into ``a`` microbatches of ``m = W * rows // a`` rows, dropping the rest;
    a microbatch may span ranks, take unequal rows from them, or lie within
    one. All of a microbatch's rows run in one round, so that its sums
    (label count, MoE counts) are one collective over the group; the
    microbatches that share a rank run in separate rounds, each in the
    first round that none of its ranks is busy in (first fit over the
    ranks' contiguous rows: as many rounds as the most microbatches that
    one rank meets). Every rank runs every round, on no rows where it holds
    none (its slot None), so that the collectives match."""
    m = (w * rows) // a
    if m == 0:
        raise ValueError(f"accum_steps={a} over a global batch of {w * rows} rows: a "
                         "microbatch of no rows")
    busy, pieces = [], []  # per round: its ranks, and {rank: (microbatch, lo, hi)}
    for j in range(a):
        lo, hi = j * m, (j + 1) * m
        ranks = set(range(lo // rows, (hi - 1) // rows + 1))
        i = next((i for i, b in enumerate(busy) if not b & ranks), len(busy))
        if i == len(busy):
            busy.append(set())
            pieces.append({})
        busy[i] |= ranks
        for r in ranks:
            pieces[i][r] = (j, max(lo, r * rows) - r * rows, min(hi, (r + 1) * rows) - r * rows)
    out = []
    for got in pieces:
        lo, hi = got.get(rank, (None, 0, 0))[1:]
        out.append((slice(lo, hi), tuple(got.get(r, (None,))[0] for r in range(w)),
                    tuple(got[r][2] - got[r][1] if r in got else 0 for r in range(w))))
    return out


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh=None,
    global_batch: Optional[int] = None,
    *,
    specs: Optional[dict] = None,
    seqpar: bool = False,
):
    """Returns step(state, batch, tables) -> (state, metrics). ``tables``
    may be None when lb_ingest is off. The batch is numpy or tensors (this
    rank's rows); it is moved to the params' device. ``state`` is updated
    in place (params, moments) and returned.

    With a mesh bound to a process group, the step reduces across its
    ranks (also a group of one): the gradients, the loss's label count and
    the metrics over the data ranks, the tensor-parallel products over the
    model ranks. It then needs ``specs`` ({"params", "opt"}, as
    ``placement`` makes them), which say which leaves ``state`` holds as
    this rank's blocks.

    ``seqpar`` on a mesh of several model ranks holds each rank's part of
    the sequence in the residual stream (``distributed.tp``'s ``seq``): a
    sequence length that does not split over them raises ``ValueError``.
    Each rank's loss and gradient are then its share of the model group's,
    and the step adds the whole leaves' gradients (one ``all_reduce`` of
    their float32 concatenation) and the metrics over the model group."""
    w = shd.data_extent(mesh) if mesh is not None else 1
    t_size = shd.model_extent(mesh) if mesh is not None else 1
    group = None if mesh is None else mesh.group
    if w > 1 and group is None:
        raise ValueError(f"a mesh of {w} data-parallel ranks needs its process group "
                         "(launch.mesh binds it)")
    if t_size > 1 and (mesh.model_group is None or group is None):
        raise ValueError(f"a mesh of {t_size} model ranks needs its process groups "
                         "(launch.mesh binds them)")
    if group is not None and specs is None:
        raise ValueError("a mesh bound to a process group needs the placement specs of the "
                         "params and moments (jit_train_step makes them)")
    a = max(train_cfg.accum_steps, 1)
    # whether ``specs`` place a leaf on its layer list (``sharding.LIST``),
    # known from the state at the first step
    lists = [None]

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

    def grads_of(params, mb, rank):
        """This rank's share of the loss and of the gradient (f32 sums of
        the rounds' over ``a`` when accumulating)."""
        def run(rows, slot_of, rows_of):
            sl = mb if a <= 1 else {k: v[rows] if v.ndim >= 1 else v for k, v in mb.items()}
            with DP.use_slots(None if group is None else DP.Slots(group, rank, slot_of, rows_of)):
                return value_and_grad(params, sl)

        rounds = _rounds(a, w, rank, mb["labels"].shape[0])
        if a <= 1:
            return run(*rounds[0])
        gsum, lsum = None, 0.0
        for rnd in rounds:
            loss, _met, g = run(*rnd)
            # added into the float32 sum in place (a bf16 term widens
            # exactly), so no second float32 copy of the gradient is held
            gsum = tree_map(lambda x, stacked: x.to(F32), g) if gsum is None else tree_map(
                lambda acc, x, stacked: acc.add_(x), gsum, g)
            lsum = lsum + loss
        return lsum / a, {}, tree_map(lambda x, stacked: x.div_(a), gsum)

    seq = seqpar and t_size > 1

    def step(state, batch, tables):
        if seq and batch["labels"].shape[1] % t_size:
            raise ValueError(f"seqpar: a sequence of {batch['labels'].shape[1]} tokens does not "
                             f"split over {t_size} model ranks")
        dev = state["step"].device
        rank = 0 if mesh is None else shd.rank_of(mesh)
        params = state["params"]
        metrics = {}
        if train_cfg.lb_ingest:
            if mesh is None or tables is None:
                raise ValueError("lb_ingest needs a mesh and the LB tables")
            mb, occ = _ingest(batch, tables, mesh, global_batch)
        else:
            mb = {k: _as_tensor(v, dev) for k, v in batch.items() if k != "headers"}

        par = None
        if specs is not None:
            whole = shd.gather_tree(params, specs["params"], mesh, axes=("data",))
            if t_size > 1:
                mdims = leaves(shd.placed_dims(params, specs["params"], mesh, "model"))
                par = TP.TP(group=mesh.model_group, rank=shd.model_rank(mesh), size=t_size,
                            dims={id(x): d for x, d in zip(leaves(whole), mdims)
                                  if d is not None}, seq=seq)
        else:
            whole = params
        with TP.use_tp(par):
            loss, lmet, grads = grads_of(whole, mb, rank)
        del whole
        stats = [loss] + list(lmet.values())
        if seq:
            # each rank's shares (its tokens') of the whole leaves' gradients
            # and of the loss, added over the model group
            _add_shares([g for g, d in zip(leaves(grads), mdims) if d is None],
                        mesh.model_group)
            stats = list(DP.all_reduce(torch.stack(stats), mesh.model_group).unbind())
        if train_cfg.lb_ingest:
            stats.append(occ.sum().to(F32))
        if group is not None:
            # the sums over the ranks: the gradient, the loss's shares and
            # the ingest's kept rows
            for g in leaves(grads):
                DP.all_reduce(g, group)
            stats = DP.all_reduce(torch.stack(stats), group).unbind()
        loss, lmet = stats[0], dict(zip(lmet, stats[1:]))
        if train_cfg.lb_ingest:
            # the reference's mean, as XLA compiles it: the sum times the
            # float32 reciprocal of the count (not a division, which rounds
            # otherwise where the count is not a power of two)
            metrics["ingest_occupancy"] = stats[-1] * (1.0 / (occ.numel() * w))
        metrics.update(lmet)

        if train_cfg.grad_compress:
            # int8 round-trip + error feedback on the summed gradient, whole
            # on every rank (gathered over "model"): the int8 blocks run over
            # the reference's flattened leaf, a per-layer list stacked
            # (map_stacked); the residual is kept whole too
            if t_size > 1:
                grads = shd.gather_tree(grads, specs["params"], mesh, axes=("model",))
            efb = state["efb"]
            if efb is None:
                efb = tree_map(lambda g, stacked: torch.zeros(g.shape, dtype=F32,
                                                                  device=g.device), grads)
            grads_fb = tree_map(lambda g, e, stacked: g.to(F32) + e, grads, efb)
            deq = map_stacked(compress_decompress, grads_fb)
            state = dict(state, efb=tree_map(lambda g, d, stacked: g - d, grads_fb, deq))
            grads = deq

        shards = None
        moments = state["opt"]
        if group is not None:
            # a leaf placed on its layer list is whole around the update:
            # every rank updates its every layer (the same numbers on each)
            # and keeps its own (an 8-bit row scale placed so while its
            # moment's rows are split by tensor dim needs them all)
            if lists[0] is None:
                lists[0] = any(d == shd.LIST for tree, sp in (
                    (params, specs["params"]), (moments, specs["opt"]))
                    for d in leaves(shd.placed_dims(tree, sp, mesh)))
            if lists[0]:
                params = shd.gather_lists(params, specs["params"], mesh)
                moments = shd.gather_lists(moments, specs["opt"], mesh)
            pdims = tree_map(lambda d, stacked: None if d == shd.LIST else d,
                             shd.placed_dims(params, specs["params"], mesh))
            mdims = shd.placed_dims(params, specs["params"], mesh, "model")
            mrank = shd.model_rank(mesh)
            cut = lambda g, d, r, n: g if d is None else g.narrow(d, r * (g.shape[d] // n),
                                                                    g.shape[d] // n)
            if train_cfg.grad_compress and t_size > 1:
                grads = tree_map(lambda g, d, stacked: cut(g, d, mrank, t_size), grads, mdims)
            grads = tree_map(lambda g, d, stacked: cut(g, d, rank, w), grads, pdims)
            shards = opt.Shards(group=group, rank=rank, world=w, params=pdims,
                                model_group=mesh.model_group, model_rank=mrank,
                                model_size=t_size, model=mdims)
        new_params, new_opt, omet = opt.update(grads, moments, params, train_cfg.adamw,
                                               shards=shards)
        if lists[0]:
            new_params = shd.shard_lists(new_params, specs["params"], mesh)
            new_opt = shd.shard_lists(new_opt, specs["opt"], mesh)
        metrics.update(omet)
        metrics["loss"] = loss
        return dict(state, params=new_params, opt=new_opt, step=state["step"] + 1), metrics

    return step


def _add_shares(grads: list, group) -> None:
    """``grads`` summed over ``group`` in place, through one ``all_reduce``
    of their float32 concatenation."""
    if not grads:
        return
    flat = DP.all_reduce(torch.cat([g.reshape(-1).to(F32) for g in grads]), group)
    for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(piece.view_as(g))


def state_shapes(model_cfg: ModelConfig, train_cfg: TrainConfig) -> dict:
    """The params and optimizer state on the meta device (shapes only), as
    ``jit_train_step`` takes them."""
    params = M.init_params(model_cfg, None, "meta")
    return {"params": params, "opt": opt.init(params, train_cfg.adamw)}


def placement(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh, params, **kw) -> dict:
    """The specs of the params (``param_sharding`` over ``params``, with
    its keywords ``kw``: FSDP on the data axes, tensor parallelism on
    "model") and of the optimizer state (each moment as its param)."""
    pspecs = shd.param_sharding(params, mesh, model_cfg, **kw)
    return {"params": pspecs, "opt": shd.moment_sharding(pspecs, train_cfg.adamw.eight_bit)}


def jit_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh,
    state_shapes,
    *,
    global_batch: Optional[int],
    donate: bool = True,
    seqpar: bool = False,
):
    """The step with params and moments placed by the sharding rules
    (``placement`` over ``state_shapes["params"]``). Its ``specs``
    attribute holds them: ``shard_state`` places a whole state so, and
    ``gather_state`` makes it whole again. ``donate=False`` leaves the
    caller's state as it was (the step works on a copy); with ``donate``
    the step updates it in place, as it always does. ``seqpar``: see
    ``make_train_step``."""
    specs = placement(model_cfg, train_cfg, mesh, state_shapes["params"])
    inner = make_train_step(model_cfg, train_cfg, mesh, global_batch, specs=specs,
                            seqpar=seqpar)

    def step(state, batch, tables):
        if not donate:
            copy = lambda x, stacked: x.detach().clone()
            state = dict(state, params=tree_map(copy, state["params"]),
                         opt=tree_map(copy, state["opt"]))
        return inner(state, batch, tables)

    step.specs = specs
    return step


def shard_state(state: dict, specs: dict, mesh) -> dict:
    """A whole state (the same on every rank) as this rank's blocks."""
    return dict(state, params=shd.shard_tree(state["params"], specs["params"], mesh),
                opt=shd.shard_tree(state["opt"], specs["opt"], mesh))


def gather_state(state: dict, specs: dict, mesh) -> dict:
    """The inverse of ``shard_state``, on every rank (collective)."""
    return dict(state, params=shd.gather_tree(state["params"], specs["params"], mesh),
                opt=shd.gather_tree(state["opt"], specs["opt"], mesh))
