"""Reductions across the data-parallel ranks of one training step.

The reference's step is one program over the global batch (GSPMD places
it); the port runs one process per rank, each with its rows of the batch.
What the reference computes over the whole batch, the port sums across
ranks here:

  * the counted collectives (``all_reduce``, ``all_gather``), which every
    collective of the step goes through (``COUNTS`` tallies them);
  * ``Slots``: the ranks whose rows make up this rank's microbatch. A
    microbatch of the reference (the batch, or one of ``accum_steps``
    slices of it) may span several ranks; the loss's label count and the
    MoE layers' capacity, expert counts and load-balance loss are sums over
    exactly those ranks. ``use_slots`` makes a ``Slots`` current for the
    model code (``models/model.py``, ``models/moe.py``); with none current
    the model runs as one process.

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
    """``x`` reduced over ``group``, in place; returns ``x``."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (equal shapes), in rank order."""
    COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


@dataclasses.dataclass(frozen=True)
class Slots:
    """The microbatch slot of every rank of ``group`` in this round of the
    step; ranks of one slot hold equal row counts, and their rows, in rank
    order, are that microbatch of the reference."""

    group: object
    rank: int
    slot_of: tuple

    @property
    def members(self) -> tuple:
        """The ranks of this rank's slot, in rank order."""
        return tuple(r for r, s in enumerate(self.slot_of) if s == self.slot_of[self.rank])

    @property
    def size(self) -> int:
        return len(self.members)

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
