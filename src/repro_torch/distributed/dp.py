"""Reductions across the data-parallel ranks of one training step.

The reference's step is one program over the global batch (GSPMD places
it); the port runs one process per rank, each with its rows of the batch.
What the reference computes over the whole batch, the port sums across
ranks here:

  * the counted collectives (``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``), which every collective of the step
    goes through (``COUNTS`` tallies them). A collective over a group of
    one rank moves nothing: it is not issued and not counted;
  * ``Slots``: the ranks whose rows make up this rank's microbatch in one
    round of the step's passes. A microbatch of the reference (the batch,
    or one of ``accum_steps`` slices of it) may span several ranks, each
    holding any part of its rows; the loss's label count and the MoE
    layers' token stream, capacity, expert counts and load-balance loss
    are sums over exactly those ranks. ``use_slots`` makes a ``Slots``
    current for the model code (``models/model.py``, ``models/moe.py``);
    with none current the model runs as one process.

The current ``Slots`` is a module global, not a thread-local: a CUDA
backward runs in autograd's own thread, and recomputing a checkpointed
block there must see the same slots as the forward did.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

#: collectives issued through this module, by kind
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group``, in place; returns ``x`` (contiguous: a
    view's reduction would not reach it)."""
    if dist.get_world_size(group) == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("all_reduce in place needs a contiguous tensor")
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (equal shapes), in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return [x]
    COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``, cut into equal slices along
    ``dim``: this rank's slice."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    COUNTS["reduce_scatter"] += 1
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    # ``reduce_scatter_single`` where torch has it (``_tensor`` is its old name)
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s equal slices along dim 0, the i-th sent to rank i; returns
    what every rank sent this one, in rank order (``all_to_all_single``)."""
    if dist.get_world_size(group) == 1:
        return x
    COUNTS["all_to_all"] += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


@dataclasses.dataclass(frozen=True)
class Slots:
    """One round of a step's forward/backward passes over the ranks of
    ``group``: ``slot_of`` gives each rank's microbatch in the round (None:
    the rank holds no rows of it, and runs the round on none, so that every
    rank of the group issues the round's collectives), ``rows_of`` the rows
    that each rank holds of it (None: as many on every rank of a slot as on
    this one). The rows of a slot's ranks, in rank order, are that
    microbatch of the reference; the ranks of one slot may hold unequal row
    counts, down to zero."""

    group: object
    rank: int
    slot_of: tuple
    rows_of: Optional[tuple] = None

    @property
    def members(self) -> tuple:
        """The ranks of this rank's slot, in rank order."""
        return tuple(r for r, s in enumerate(self.slot_of) if s == self.slot_of[self.rank])

    @property
    def size(self) -> int:
        return len(self.members)

    def rows(self, mine: int) -> list:
        """The rows of each rank of this rank's slot, in rank order
        (``mine``: this rank's)."""
        if self.rows_of is None:
            return [mine] * self.size
        return [self.rows_of[r] for r in self.members]

    def round_rows(self, mine: int) -> int:
        """The rows of one microbatch of the round, which all of its
        microbatches share: the same number on every rank, an idle one's
        too (``mine``: this rank's rows)."""
        if self.rows_of is None:
            return mine * self.size
        held = next(s for s in self.slot_of if s is not None)
        return sum(n for n, s in zip(self.rows_of, self.slot_of) if s == held)

    @property
    def alone(self) -> bool:
        """Each microbatch of the round lies within one rank: no rank's
        sums need another's."""
        held = [s for s in self.slot_of if s is not None]
        return len(held) == len(set(held))

    def parts(self, x: torch.Tensor) -> list:
        """``x`` of every rank of this slot, in rank order (one
        ``all_gather`` over the group)."""
        every = all_gather(x, self.group)
        return [every[r] for r in self.members]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over this slot's ranks, added in rank order (the
        one rank's ``x`` itself, bit for bit, in a slot of one)."""
        parts = self.parts(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


_current: Optional[Slots] = None


def current() -> Optional[Slots]:
    return _current


@contextlib.contextmanager
def use_slots(slots: Optional[Slots]):
    global _current
    prev, _current = _current, slots
    try:
        yield
    finally:
        _current = prev


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the current slot's ranks (``x`` with none)."""
    return x if _current is None else _current.sum(x)
