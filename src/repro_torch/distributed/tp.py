"""Tensor parallelism on the mesh's "model" axis in the training step.

The reference's step is one program with its params placed on ("data",
"model"), and GSPMD partitions every product. The port runs one process
per rank: the step (``train/train_step.py``) gathers each param over the
data axes and keeps its slice on "model" (``sharding.placed_dims(...,
"model")``), and the model code reads from the current ``TP`` which leaves
are so split and issues the collectives that the split needs, Megatron's
way:

  * a column-parallel product (a leaf split on its output dim: q heads,
    ``d_ff``, an expert's ``ff``) takes a replicated input through
    ``to_parallel`` (identity forward, one ``all_reduce`` of its gradient
    backward) and leaves its output on the rank;
  * a row-parallel product (a leaf split on its input dim) sums the ranks'
    partial outputs through ``from_parallel`` (one ``all_reduce`` forward,
    identity backward);
  * ``gather_to_parallel`` gathers a split leaf whole for a use that differs
    by rank (the KV heads that this rank's q heads read): ``all_gather``
    forward, ``reduce_scatter`` of its gradient backward;
  * ``whole`` gathers a split leaf for a block that runs whole on every
    rank (Mamba2, RWKV6's time-mix, attention whose heads do not split):
    ``all_gather`` forward, this rank's slice of the gradient backward;
  * the vocabulary: ``embed`` (a masked lookup of the rank's rows, then one
    ``all_reduce``) and ``vocab_stats`` (the cross-entropy from each
    shard's max, sum-exp and label logit, ``[B, T]`` statistics).

Activations outside those products are replicated over "model": every
rank of a model group holds the same rows and computes the same residual
stream, so the gradient of a replicated tensor is whole on every rank.
Every collective goes through ``distributed.dp``'s counted functions.

With no ``TP`` current (one process, serving, a model extent of 1) the
model code runs as it did. The current ``TP`` is a module global, as
``dp.Slots`` is: a CUDA backward runs in autograd's own thread, and a
checkpointed block recomputed there must see it too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import dp


class _ToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dp.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _FromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return dp.all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank, per_rank_use):
        ctx.group, ctx.dim, ctx.rank, ctx.per_rank_use = group, dim, rank, per_rank_use
        return torch.cat(dp.all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.per_rank_use:
            return dp.reduce_scatter(g, ctx.group, ctx.dim), None, None, None, None
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return g.narrow(ctx.dim, ctx.rank * n, n).contiguous(), None, None, None, None


@dataclasses.dataclass(frozen=True)
class TP:
    """The model group of this step: its ``size`` ranks, this one's
    ``rank``, and ``dims``: ``id(leaf) -> dim`` of every param leaf that the
    step holds as its slice on "model" (a leaf not in it is whole)."""

    group: object
    rank: int
    size: int
    dims: dict

    def dim(self, leaf: torch.Tensor) -> Optional[int]:
        return self.dims.get(id(leaf))

    def span(self, n: int) -> tuple:
        """This rank's [lo, hi) of ``n`` items split evenly over the ranks."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def to_parallel(self, x):
        return _ToParallel.apply(x, self.group)

    def from_parallel(self, x):
        return _FromParallel.apply(x, self.group)

    def gather_to_parallel(self, leaf):
        """A leaf whole, for a use that differs by rank; a whole leaf goes
        through ``to_parallel`` (its gradient is summed over the ranks)."""
        d = self.dim(leaf)
        if d is None:
            return self.to_parallel(leaf)
        return _Gather.apply(leaf, self.group, d, self.rank, True)

    def whole(self, leaf):
        """A leaf whole, for a use that every rank runs alike."""
        d = self.dim(leaf)
        return leaf if d is None else _Gather.apply(leaf, self.group, d, self.rank, False)

    def embed(self, table, tokens):
        """Rows of a vocab-split table: each rank looks up the tokens in
        its rows (zeros elsewhere), and one ``all_reduce`` adds them."""
        lo, n = self.rank * table.shape[0], table.shape[0]
        local = tokens.long() - lo
        ok = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
        return self.from_parallel(rows)

    def vocab_stats(self, logits, labels):
        """From vocab-split logits ``[..., V / size]`` (f32) and labels
        ``[...]`` in ``[0, V)``: (log-prob of the label, logsumexp), both
        ``[...]``. The max is all-reduced without a gradient (the
        logsumexp's gradient does not depend on it), the sum-exp and the
        label logit in one ``all_reduce``."""
        n = logits.shape[-1]
        m = dp.all_reduce(logits.detach().amax(dim=-1), self.group, op=dist.ReduceOp.MAX)
        local = labels - self.rank * n
        ok = (local >= 0) & (local < n)
        lab = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        lab = torch.where(ok, lab, torch.zeros_like(lab))
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        se, lab = self.from_parallel(torch.stack([se, lab])).unbind()
        lse = m + torch.log(se)
        return lab - lse, lse


_current: Optional[TP] = None


def current() -> Optional[TP]:
    return _current


@contextlib.contextmanager
def use_tp(tp: Optional[TP]):
    global _current
    prev, _current = _current, tp
    try:
        yield
    finally:
        _current = prev


def whole(leaf):
    """``leaf`` whole on every rank (``TP.whole``); the leaf itself with
    no ``TP`` current."""
    return leaf if _current is None else _current.whole(leaf)
