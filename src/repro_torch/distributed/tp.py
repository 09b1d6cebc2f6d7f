"""Tensor parallelism on the mesh's "model" axis: the training step and
the placed serving step.

The reference's step is one program with its params placed on ("data",
"model"), and GSPMD partitions every product. The port runs one process
per rank: the step (``train/train_step.py``, ``launch/serve_step.py``)
gathers each param over the data axes and keeps its slice on "model"
(``sharding.placed_dims(..., "model")``), and the model code reads from the
current ``TP`` which leaves are so split and issues the collectives that
the split needs, Megatron's way:

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

``seq`` (``seqpar``, Megatron's sequence parallelism; the training step and
the serving step's prefill): the residual stream holds this rank's
``T / size`` tokens between blocks. A block gathers them (``full``: one
``all_gather`` forward, a ``reduce_scatter`` of the gradient backward)
before its column products, and its row products end in a
``reduce_scatter`` over the tokens (``exit``; an ``all_gather`` of the
gradient backward) where they would all-reduce; a block that runs whole
keeps its rank's part of the output (``part``). Its gradients then follow
one rule: each rank's loss is its share of the model group's (a term that
every rank computes whole, such as the cross-entropy from ``vocab_stats``
or a MoE layer's load-balance loss, counts ``1 / size`` on each), and the
gradient of every tensor on a rank is that rank's share. So
``to_parallel`` is the identity both ways, ``from_parallel`` all-reduces
both ways, a leaf gathered for a whole block reduce-scatters its gradient,
and the step adds the whole leaves' shares over the model group once
(``train_step``).

Serving (under ``torch.no_grad``) adds two more layouts, each a field of
the ``TP``:

  * ``wide`` (``wide_tp``): leaves split over every rank of the mesh
    (data-major). A product on such a leaf gathers the batch's rows over
    the data ranks (``rows_all``), and its partial sums are added over all
    ranks (one ``all_reduce``) before each rank keeps its rows
    (``rows_mine``): the activations move, not the weights;
  * ``kv_seq``: the KV caches' sequence split over the data ranks (a batch
    that does not split over them, ``long_500k``). Each data rank attends
    over its slots and the ranks merge their partial softmaxes
    (``layers.attention``'s ``merge``).

With no ``TP`` current (one process, a model extent of 1 in training) the
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


class _AllReduce(torch.autograd.Function):
    """The ranks' shares added: ``all_reduce`` forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return dp.all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return dp.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _Scatter(torch.autograd.Function):
    """The ranks' partial sums added and cut along ``dim``
    (``reduce_scatter``); backward, the slices' gradients joined
    (``all_gather``)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return dp.reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(dp.all_gather(g, ctx.group), dim=ctx.dim), None, None


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
class Group:
    """``size`` ranks of a process group (None: the default group) and this
    one's ``rank`` among them."""

    group: object
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Wide:
    """The leaves split over every rank of the mesh (``wide_tp``):
    ``dims``, ``id(leaf) -> dim``; ``ranks``: all of them, this rank's
    block being ``data_rank * model_ranks + model_rank``."""

    dims: dict
    ranks: Group


@dataclasses.dataclass(frozen=True)
class TP:
    """The model group of this step: its ``size`` ranks, this one's
    ``rank``, and ``dims``: ``id(leaf) -> dim`` of every param leaf that the
    step holds as its slice on "model" (a leaf not in it is whole, or
    ``wide``). Serving's layouts (module docstring): ``wide``; ``rows``,
    the data ranks over which the batch's rows split (None: every rank
    holds every row); ``seq``; ``kv_seq``, the data ranks over which the KV
    caches' sequence splits."""

    group: object
    rank: int
    size: int
    dims: dict
    wide: Optional[Wide] = None
    rows: Optional[Group] = None
    seq: bool = False
    kv_seq: Optional[Group] = None

    def dim(self, leaf: torch.Tensor) -> Optional[int]:
        return self.dims.get(id(leaf))

    def kind(self, leaf: torch.Tensor) -> Optional[str]:
        """"model" (split over the model group), "wide" (over every rank)
        or None (whole)."""
        if id(leaf) in self.dims:
            return "model"
        if self.wide is not None and id(leaf) in self.wide.dims:
            return "wide"
        return None

    def span(self, n: int) -> tuple:
        """This rank's [lo, hi) of ``n`` items split evenly over the ranks."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def to_parallel(self, x):
        return x if self.seq else _ToParallel.apply(x, self.group)

    def from_parallel(self, x):
        return (_AllReduce if self.seq else _FromParallel).apply(x, self.group)

    def gather_to_parallel(self, leaf):
        """A leaf whole, for a use that differs by rank; a whole leaf goes
        through ``to_parallel`` (its gradient is summed over the ranks)."""
        d = self.dim(leaf)
        if d is None:
            return self.to_parallel(leaf)
        return _Gather.apply(leaf, self.group, d, self.rank, True)

    def whole(self, leaf):
        """A leaf whole, for a use that every rank runs alike."""
        if self.kind(leaf) == "wide":  # serving: no gradient
            return torch.cat(dp.all_gather(leaf, self.wide.ranks.group),
                             dim=self.wide.dims[id(leaf)])
        d = self.dim(leaf)
        # under ``seq`` each rank's use keeps only its tokens' outputs: the
        # ranks' gradients are shares, added before the slice is kept
        return leaf if d is None else _Gather.apply(leaf, self.group, d, self.rank, self.seq)

    # -- the layouts of the stream ---------------------------------------------

    def full(self, x):
        """A residual-stream tensor ``[B, T', ...]`` with all its tokens:
        under ``seq`` the model ranks' parts joined (one ``all_gather``;
        backward, one ``reduce_scatter`` of the ranks' shares)."""
        return _Gather.apply(x, self.group, 1, self.rank, True) if self.seq else x

    def part(self, x):
        """This rank's tokens of a whole ``[B, T, ...]`` under ``seq``."""
        if not self.seq:
            return x
        n = x.shape[1] // self.size
        return x.narrow(1, self.rank * n, n)

    def last(self, x):
        """The stream's last token ``[B, 1, ...]``: under ``seq`` the last
        model rank's (one ``all_gather`` of each rank's last)."""
        return dp.all_gather(x[:, -1:], self.group)[-1] if self.seq else x[:, -1:]

    def rows_all(self, x):
        """Every data rank's rows of ``x`` (dim 0), in rank order."""
        if self.rows is None:
            return x
        return torch.cat(dp.all_gather(x, self.rows.group), dim=0)

    def rows_mine(self, x):
        """This data rank's rows of a ``rows_all`` tensor."""
        if self.rows is None:
            return x
        n = x.shape[0] // self.rows.size
        return x.narrow(0, self.rows.rank * n, n)

    def enter(self, leaf, x):
        """The input of a column product on a split ``leaf``."""
        return self.to_parallel(x) if self.kind(leaf) == "model" else self.rows_all(x)

    def exit(self, leaf, y):
        """The ranks' partial outputs of the row product that pairs with a
        split ``leaf`` added: over the model group (a ``reduce_scatter`` of
        the tokens under ``seq``), or for a wide leaf over every rank, this
        rank's rows (and tokens) kept."""
        if self.kind(leaf) == "model":
            return _Scatter.apply(y, self.group, 1) if self.seq else self.from_parallel(y)
        y = dp.all_reduce(y.contiguous(), self.wide.ranks.group)
        return self.part(self.rows_mine(y))

    def embed(self, table, tokens):
        """Rows of a vocab-split table: each rank looks up the tokens in
        its rows (zeros elsewhere), and the ranks add them (``exit``; a
        wide table looks up every data rank's tokens)."""
        wide = self.kind(table) == "wide"
        tokens = self.rows_all(tokens) if wide else tokens
        n = table.shape[0]
        lo = (self.wide.ranks.rank if wide else self.rank) * n
        local = tokens.long() - lo
        ok = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
        return self.exit(table, rows)

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

    def vocab_whole(self, leaf, logits):
        """Logits whole on the vocab from a product on a vocab-split head
        (the input's rows gathered first for a wide one: ``enter``)."""
        if self.kind(leaf) == "model":
            return torch.cat(dp.all_gather(logits, self.group), dim=-1)
        return self.rows_mine(torch.cat(dp.all_gather(logits, self.wide.ranks.group), dim=-1))

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

