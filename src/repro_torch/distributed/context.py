"""Logical-axis sharding context.

Port of the JAX package's ``repro/distributed/context.py``. Model code of the
reference annotates activations with *logical* axis names
(``constrain(x, ("batch", None, "embed"))``) and the active
``ShardingRules`` maps logical names to physical mesh axes. PyTorch has no
GSPMD to take such a constraint: ``constrain`` is a no-op here, kept so the
rules and their resolution to placement specs (``ShardingRules.spec``) carry
over and are tested against the reference. The sequence-parallel layout that
``logical_rules(seq_axis="model")`` names is carried out by the model code
itself (``distributed/tp.py``'s ``seq``) under the training step's
``seqpar`` and the placed serving step's. The training step places params
and moments itself (``sharding.shard_tree``), and its activations are each
rank's rows of the batch, which is the placement the "batch" rule names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> physical mesh axis (or tuple of axes, or None)."""

    mesh: object
    rules: dict

    def spec(self, logical) -> tuple:
        """The placement spec of ``logical``: one mesh axis (or tuple of
        axes, or None) per dim, as the reference's ``PartitionSpec``."""
        return tuple(None if name is None else self.rules.get(name) for name in logical)


def set_rules(rules: Optional[ShardingRules]) -> None:
    _state.rules = rules


def get_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def constrain(x, logical):
    """The reference's ``with_sharding_constraint`` by logical axes. There is
    no GSPMD in PyTorch to take it, so ``x`` is returned as it is, with or
    without active rules."""
    return x
