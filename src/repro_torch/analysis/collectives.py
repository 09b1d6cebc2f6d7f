"""The collectives of a step, recorded as they are issued.

The counterpart of the JAX package's ``repro/analysis/hlo.py``, which reads
the collectives out of the compiled HLO text. The port has no HLO: its step
runs eagerly, one process per rank, and every collective is a
``torch.distributed`` call. ``CollectiveRecord`` is a ``TorchDispatchMode``
that sees those calls as the c10d operators they dispatch to, the eager
ones (``c10d.allreduce_``, ``allgather_``, ``_allgather_base_``,
``reduce_scatter_``, ``_reduce_scatter_base_``, ``alltoall_base_``) and
the functional ones (``_c10d_functional.*``), each with its tensors' bytes
and its group's size. It gives the reference's ``CollectiveStats`` (the
same ``to_json()`` keys) with the reference's ring factors per device:

    all-gather:         F = the gathered buffer;      wire = F*(g-1)/g
    all-reduce:         F = the buffer;               wire = 2*F*(g-1)/g
    reduce-scatter:     F = s*g (s: the shard);       wire = F*(g-1)/g
    all-to-all:         F = the buffer;               wire = F*(g-1)/g

(the port issues no collective-permute, whose wire is F). The serving
step's collectives are the same calls: ``seqpar``'s reduce-scatters of the
residual stream, ``widetp``'s all-reduces over every rank, and the merge of
a sequence-split decode (an all-reduce of the max, then one of the rescaled
sums) each count as their kind. A group of one
rank moves nothing and is skipped, as in the reference. Each call counts
once (an eager step has no loop to weight), so ``dynamic_ops``
equals ``ops``. It records on any device, the meta device of a dry run on
torch's fake process group included. A ``DTensor`` that reaches it is
handed back (``NotImplemented``), so that DTensor's own dispatch issues
the collectives it implies and the record sees those.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: (namespace, op packet name) -> (collective kind, the argument whose bytes
#: are F, or that argument's bytes times the group's size)
_OPS = {
    ("c10d", "allreduce_"): ("all-reduce", "tensors"),
    ("c10d", "allgather_"): ("all-gather", "output_tensors"),
    ("c10d", "_allgather_base_"): ("all-gather", "output_tensor"),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", "input_tensors"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "input_tensor"),
    ("c10d", "alltoall_base_"): ("all-to-all", "output"),
    ("_c10d_functional", "all_reduce"): ("all-reduce", "input"),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "input"),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "input x group"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "input"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "input"),
}


@dataclasses.dataclass
class CollectiveStats:
    ops: dict            # op kind -> static count
    dynamic_ops: dict    # op kind -> trip-weighted count
    payload_bytes: dict  # op kind -> full-buffer bytes (per device, weighted)
    wire_bytes: dict     # op kind -> ring-model wire bytes (per device, weighted)
    total_payload: float
    total_wire: float

    def to_json(self):
        return {
            "ops": dict(self.ops),
            "dynamic_ops": {k: float(v) for k, v in self.dynamic_ops.items()},
            "payload_bytes": {k: float(v) for k, v in self.payload_bytes.items()},
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "total_payload_bytes": float(self.total_payload),
            "total_wire_bytes": float(self.total_wire),
        }


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _named_args(func, args, kwargs) -> dict:
    names = [a.name for a in func._schema.arguments]
    return {**dict(zip(names, args)), **kwargs}


def _group_size(named: dict) -> int:
    """The size of the op's group: its ``process_group`` (eager ops, a
    boxed ``ProcessGroup``) or its ``group_name`` (functional ops)."""
    from torch.distributed import distributed_c10d as c10d

    pg = named.get("process_group")
    if pg is not None:
        return (pg if isinstance(pg, c10d.ProcessGroup) else c10d.ProcessGroup.unbox(pg)).size()
    name = named["group_name"]
    if isinstance(name, c10d.ProcessGroup):
        return name.size()
    return c10d._resolve_process_group(name).size()


def ring_bytes(kind: str, full: float, g: int) -> float:
    """The ring model's wire bytes per device of one collective over ``g``
    ranks whose full buffer is ``full`` bytes (``hlo.py``'s factors)."""
    return (2.0 if kind == "all-reduce" else 1.0) * full * (g - 1) / g


class CollectiveRecord(TorchDispatchMode):
    """Records every c10d collective issued while it is active (``with
    CollectiveRecord() as rec: ...``); ``stats()`` gives the
    ``CollectiveStats``, ``calls`` the calls (kind, full bytes, group
    size) in order, ``shapes`` each call's tensor (shape, dtype) beside it,
    and ``by_shape()`` the calls summed by (kind, tensor, group size)."""

    def __init__(self):
        super().__init__()
        self.calls: list = []
        self.shapes: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._overloadpacket.__name__
        hit = _OPS.get((func.namespace, name))
        if hit is not None:
            kind, arg = hit
            named = _named_args(func, args, kwargs)
            g = _group_size(named)
            full = _nbytes(named[arg.split(" x ")[0]]) * (g if " x " in arg else 1)
            if g > 1:
                self.calls.append((kind, float(full), g))
                t = next(t for t in tree_leaves(named[arg.split(" x ")[0]])
                         if isinstance(t, torch.Tensor))
                self.shapes.append((tuple(t.shape), str(t.dtype).replace("torch.", "")))
        return func(*args, **kwargs)

    def by_shape(self, top: int = 16) -> list:
        """The ``top`` largest groups of calls by payload: each call's
        kind, tensor shape and dtype (the input of an all-reduce, the
        output of an all-gather), group size, count and payload bytes."""
        acc = defaultdict(lambda: [0, 0.0])
        for (kind, full, g), (shape, dtype) in zip(self.calls, self.shapes):
            a = acc[(kind, shape, dtype, g)]
            a[0] += 1
            a[1] += full
        rows = [dict(kind=k, shape=list(sh), dtype=dt, group=g, calls=n, payload_bytes=b)
                for (k, sh, dt, g), (n, b) in acc.items()]
        return sorted(rows, key=lambda r: -r["payload_bytes"])[:top]

    def stats(self) -> CollectiveStats:
        ops, payload, wire = defaultdict(int), defaultdict(float), defaultdict(float)
        for kind, full, g in self.calls:
            ops[kind] += 1
            payload[kind] += full
            wire[kind] += ring_bytes(kind, full, g)
        return CollectiveStats(ops=dict(ops), dynamic_ops={k: float(v) for k, v in ops.items()},
                               payload_bytes=dict(payload), wire_bytes=dict(wire),
                               total_payload=float(sum(payload.values())),
                               total_wire=float(sum(wire.values())))
