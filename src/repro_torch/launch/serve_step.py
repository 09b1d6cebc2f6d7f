"""Prefill and decode under the placement: the serving step over the
(data, model) ranks of a mesh.

The reference lowers ``prefill`` and ``decode_step`` as one GSPMD program
(``repro/launch/dryrun.py``'s prefill and decode cells): params placed by
``param_sharding(..., min_fsdp_size=2**24, wide_tp=wide, fsdp=not wide)``,
the batch by ``batch_shardings`` and the decode state by
``decode_state_shardings``. The port runs one process per rank, as its
training step does (``train/train_step.py``):

  * each rank holds its block of every param (``param_specs``,
    ``sharding.shard_tree``) and of the decode state
    (``shardspecs.placed_state_shardings``, ``shardspecs.shard_state``):
    a KV cache by batch on the data axes, or by sequence where the batch
    does not split over them (``long_500k``: batch 1), and by KV heads on
    "model" where they divide; the recurrent states (Mamba2, RWKV6) by
    batch only, their blocks running whole on every model rank;
  * each step gathers the params placed on the data axes (FSDP) and runs
    the model on its data rank's rows (``batch_rows``; every rank holds
    every row where the batch does not split), tensor-parallel on "model"
    (``distributed/tp.py``), under ``torch.no_grad``;
  * ``wide`` (the reference's ``widetp``): the params' TP dims split over
    every rank and no FSDP; their products gather the batch's rows instead
    of the weights (``tp.Wide``);
  * ``seqpar``: the residual stream of the dense, moe and vlm families
    holds the rank's ``T / model`` tokens between blocks at a prefill whose
    length divides (``TP.seq``); the blocks that run whole (Mamba2, RWKV6)
    need the whole sequence on every rank, so the hybrid and ssm families
    keep the stream whole;
  * a sequence-split cache: every data rank attends over its slots and the
    ranks merge their partial softmaxes; only the rank that holds a token's
    ring slot writes it (``layers.self_attention_block``);
  * a MoE layer sums its capacity and expert counts over the data ranks of
    the batch (``distributed.dp.Slots``); ``moegroup`` (the reference's
    shard-local dispatch) is ``moe_dispatch_groups`` = the data extent, so
    each rank packs its own groups with ``dispatch_plan``.

The logits come back whole on the vocab for the rank's rows. The serving
engine (``serve/engine.py``) stays one process, as the reference's does.

    step = ServeStep(cfg, mesh, specs, global_batch=B)
    logits, state = step.prefill(params, batch_rows(batch, mesh, B), state)
    logits, state = step.decode(params, tokens_rows, state)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.distributed import dp
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.launch import shardspecs
from repro_torch.models import model as M
from repro_torch.tree import flat_paths, leaves, tree_map

#: the reference's FSDP threshold for serving (``lower_cell``)
MIN_FSDP = 2 ** 24
#: the families whose residual stream ``seqpar`` splits
SEQ_FAMILIES = ("dense", "moe", "vlm")


def param_specs(cfg, mesh: shd.Mesh, params, *, wide: bool = False,
                min_fsdp_size: int = MIN_FSDP) -> dict:
    """The reference's serving placement of the params: TP on "model" (over
    every axis with ``wide``), FSDP on the data axes unless ``wide``."""
    return shd.param_sharding(params, mesh, cfg, min_fsdp_size=min_fsdp_size,
                              wide_tp=wide, fsdp=not wide)


def placement(cfg, mesh: shd.Mesh, params, state, *, wide: bool = False,
              min_fsdp_size: int = MIN_FSDP) -> dict:
    """{"params", "state"}: the specs of the params and of the decode state."""
    return {"params": param_specs(cfg, mesh, params, wide=wide, min_fsdp_size=min_fsdp_size),
            "state": shardspecs.placed_state_shardings(cfg, mesh, state)}


def rows_split(mesh: shd.Mesh, global_batch: int) -> bool:
    """Whether the batch's rows split over the data ranks (else every rank
    holds every row), the reference's rule for a decode's tokens."""
    w = shd.data_extent(mesh)
    return w > 1 and global_batch % w == 0


def batch_rows(batch: dict, mesh: shd.Mesh, global_batch: int) -> dict:
    """This data rank's rows of each input (dim 0), or the whole batch
    where it does not split over the data ranks."""
    if not rows_split(mesh, global_batch):
        return batch
    w, r = shd.data_extent(mesh), shd.rank_of(mesh)
    n = global_batch // w
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


@dataclasses.dataclass
class ServeStep:
    """``prefill``, ``decode`` and (an encoder) ``forward`` on this rank's
    blocks; ``specs`` as ``placement`` gives them."""

    cfg: object
    mesh: shd.Mesh
    specs: dict
    global_batch: int
    seqpar: bool = False
    q_chunk: int = 1024
    k_chunk: int = 1024
    rwkv_chunk: int = 1

    def __post_init__(self):
        mesh = self.mesh
        self._w, self._m = w, m = shd.data_extent(mesh), shd.model_extent(mesh)
        if (w > 1 and mesh.group is None) or (m > 1 and mesh.model_group is None):
            raise ValueError(f"a mesh of {w} x {m} ranks needs its process groups "
                             "(launch.mesh binds them)")
        self._split = rows_split(mesh, self.global_batch)
        self._rank, self._mrank = shd.rank_of(mesh), shd.model_rank(mesh)
        kpos = flat_paths(self.specs.get("state") or {}).get("kv/pos")
        self._kv_seq = (TP.Group(mesh.group, self._rank, w)
                        if kpos and w > 1 and shd.data_dim(kpos, mesh) == len(kpos) - 1
                        else None)
        self._placed = None  # (params, its leaves' data, wide and model dims)

    def _dims(self, params) -> tuple:
        """Per leaf of ``params`` (in ``leaves`` order) the dim placed on the
        data axes, on both (wide) and on "model"; walked once per tree."""
        if self._placed is None or self._placed[0] is not params:
            specs, mesh = self.specs["params"], self.mesh
            self._placed = (params, *(leaves(shd.placed_dims(params, specs, mesh, axis))
                                      for axis in ("data", "wide", "model")))
        return self._placed[1:]

    def _context(self, params, t: int):
        """The params gathered over the data axes (wide leaves kept) and the
        ``TP`` of this step (``t`` tokens a row)."""
        mesh, w, m = self.mesh, self._w, self._m
        ddims, wdims, mdims = self._dims(params)
        whole = params
        if w > 1:
            it = iter([None if wd is not None else d for d, wd in zip(ddims, wdims)])

            def gather(x, stacked):
                d = next(it)
                return x if d is None else torch.cat(dp.all_gather(x, mesh.group), dim=d)

            whole = tree_map(gather, params)
        xs = leaves(whole)
        wide = None
        if w * m > 1 and any(d is not None for d in wdims):
            if dist.get_rank() != self._rank * m + self._mrank:
                raise ValueError("a wide placement needs the world's ranks data-major on the "
                                 "mesh (launch.mesh binds them so)")
            wide = TP.Wide(dims={id(x): d for x, d in zip(xs, wdims) if d is not None},
                           ranks=TP.Group(None, dist.get_rank(), dist.get_world_size()))
        split = {id(x): d for x, d, wd in zip(xs, mdims, wdims)
                 if d is not None and wd is None} if m > 1 else {}
        seq = (self.seqpar and m > 1 and t > 1 and t % m == 0
               and self.cfg.family in SEQ_FAMILIES)
        par = TP.TP(group=mesh.model_group, rank=self._mrank, size=m, dims=split, wide=wide,
                    rows=TP.Group(mesh.group, self._rank, w) if self._split else None,
                    seq=seq, kv_seq=self._kv_seq)
        slots = dp.Slots(mesh.group, self._rank, (0,) * w) if self._split else None
        return whole, par, slots

    def _run(self, fn, params, t):
        whole, par, slots = self._context(params, t)
        with torch.no_grad(), TP.use_tp(par), dp.use_slots(slots):
            return fn(whole)

    def prefill(self, params, batch: dict, state):
        """``model.prefill`` on this rank's rows and blocks -> (logits
        ``[rows, V]``, state blocks; the KV caches written in place)."""
        t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
        return self._run(lambda p: M.prefill(p, batch, state, self.cfg, q_chunk=self.q_chunk,
                                             k_chunk=self.k_chunk, rwkv_chunk=self.rwkv_chunk),
                         params, t)

    def decode(self, params, tokens, state):
        """``model.decode_step``: ``tokens`` int ``[rows]``."""
        return self._run(lambda p: M.decode_step(p, tokens, state, self.cfg,
                                                 q_chunk=self.q_chunk, k_chunk=self.k_chunk),
                         params, 1)

    def forward(self, params, batch: dict):
        """``model.forward`` (the encoder's prefill) -> logits of the rank's
        rows, this rank's vocab columns where ``head`` is split."""
        t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
        return self._run(lambda p: M.forward(p, batch, self.cfg, remat=False,
                                             q_chunk=self.q_chunk, k_chunk=self.k_chunk)[0],
                         params, t)
