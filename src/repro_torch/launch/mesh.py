"""Production meshes. Functions (not module-level constants), so importing
this module never touches process-group state.

Port of the JAX package's ``repro/launch/mesh.py``: each factory returns the
port's ``Mesh`` (``distributed/sharding.py``) with the reference's axis
names and sizes. Where a process group is up, a factory binds the mesh to
it: the world must have exactly as many ranks as the mesh has places
(another size is refused), and the groups of the data axes and of "model"
come from ``torch.distributed.device_mesh.init_device_mesh`` over the mesh's
axes, on the device type of the group's backend (NCCL: "cuda"; gloo and
torch's fake process group: "cpu").
Without a process group the mesh carries names and sizes only, which is all
the placement specs (``param_sharding``, ``shardspecs``) read.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh, data_axes


def _bind(axis_sizes: tuple, axis_names: tuple) -> Mesh:
    """A ``Mesh`` of these axes, bound to the process group when one is up."""
    sizes, names = tuple(axis_sizes), tuple(axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(names, sizes)
    world = dist.get_world_size()
    if world != math.prod(sizes):
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {math.prod(sizes)} ranks; "
                         f"the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    d_ax = data_axes(Mesh(names, sizes))
    sub = dm[d_ax[0]] if len(d_ax) == 1 else dm[d_ax]._flatten()
    model = dm["model"].get_group() if "model" in names else None
    return Mesh(names, sizes, group=sub.get_group(), model_group=model)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _bind(shape, axes)


def make_dp_mesh(*, multi_pod: bool = False) -> Mesh:
    """The same 256 places per pod as pure data parallelism: (256, 1)."""
    shape = (2, 256, 1) if multi_pod else (256, 1)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _bind(shape, axes)


def make_hybrid_mesh(tp: int, *, multi_pod: bool = False) -> Mesh:
    """The same 256 places per pod as (256/tp, tp): tensor parallelism of
    degree ``tp`` on "model"."""
    dp = 256 // tp
    shape = (2, dp, tp) if multi_pod else (dp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _bind(shape, axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """A small ("data", "model") mesh over the ranks of the process group
    (or none)."""
    return _bind((n_data, n_model), ("data", "model"))
