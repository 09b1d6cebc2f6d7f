"""Parameter/activation sharding rules per architecture family.

Port of the JAX package's ``repro/distributed/sharding.py``. Physical mesh
axes: ("pod", "data", "model") multi-pod or ("data", "model") single-pod.
Policy:

  * TP on "model" for: q-head projections, d_ff, expert d_ff, vocab — only
    when the dim is divisible by the model-axis size (checked per param; the
    fallback is FSDP-only for that param).
  * FSDP on "data" (+"pod") for the largest remaining dim of every large
    param.
  * Activations: batch on ("pod", "data").

``Mesh`` stands where ``jax.sharding.Mesh`` stands: axis names and sizes,
the process group of the data-parallel ranks and that of the "model" axis.
The rules resolve to placement specs (a tuple per leaf: a mesh axis, a
tuple of axes or None per dim), equal to the reference's
``PartitionSpec``s. ``shard_tree`` carries a placement out on both axes (a
rank keeps its (data, model) block of each leaf: FSDP along the dim the spec
puts on the data axes, tensor parallelism along the dim it puts on "model"),
and ``gather_tree`` undoes it on the axes asked for (a ``wide_tp`` dim,
on the data axes and "model" at once, is cut data-major: block
``data_rank * model_ranks + model_rank``); the training step
(``train/train_step.py``) holds params and moments so, gathers the data
axes for its forward and backward and keeps the model slices
(``distributed/tp.py``). ``moment_sharding`` places an optimizer moment as
its param (the reference's rules do not match the moments' paths, so
GSPMD holds them whole over "model"; the port splits them with their
params and updates each block where it lies).

A list in a params tree (the port's per-layer list) is described as the
reference stores it (``repro_torch.tree``): one leaf per path whose leading
dim is the list's length, so a spec has the layer dim first. A spec that
places that dim on the data axes (FSDP's largest divisible dim may be the
layer dim) gives each data rank its ``L / W`` whole items of the list, in
rank order; the rank's tree holds None in place of the other items
(``shard_lists``, ``gather_lists``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import dp
from repro_torch.distributed.context import ShardingRules
from repro_torch.tree import (flat_paths, leaves, list_depth, stacked_shape, tree_map,
                              unflatten_paths)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes; ``group`` is the process group of
    the ranks along the data axes and ``model_group`` that of the ranks
    along "model" (None: not bound to a process group)."""

    axis_names: tuple
    axis_sizes: tuple
    group: Optional[object] = None
    model_group: Optional[object] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes {self.axis_sizes} "
                             "differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def data_axes(mesh: Mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def data_extent(mesh: Mesh) -> int:
    """Ranks along the data axes: the data-parallel members."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def model_extent(mesh: Mesh) -> int:
    """Ranks along "model": the tensor-parallel degree."""
    return mesh.shape.get("model", 1)


def logical_rules(mesh: Mesh, *, seq_axis: Optional[str] = None) -> ShardingRules:
    """seq_axis="model" => Megatron-style sequence-parallel activations (the
    residual stream stays seq-sharded on the model axis between blocks)."""
    d_ax = data_axes(mesh)
    batch = d_ax if len(d_ax) > 1 else (d_ax[0] if d_ax else None)
    return ShardingRules(
        mesh=mesh,
        rules={
            "batch": batch,
            "vocab": model_axis(mesh),
            "ff": model_axis(mesh),
            "heads": model_axis(mesh),
            "seq": (model_axis(mesh) if seq_axis == "model" else None),
        },
    )


# -- parameter annotation -----------------------------------------------------

_TP_RULES = [
    # (path regex, dim index (negative ok), logical group)
    (r".*attn/w[qkv]$", -1, "tp_out"),     # [*, d, H*hd] shard H*hd
    (r".*attn/wo$", -2, "tp_in"),          # [*, H*hd, d] shard H*hd (input dim)
    (r".*(mlp|dense)/w_(gate|up)$", -1, "tp_out"),
    (r".*(mlp|dense)/w_down$", -2, "tp_in"),
    (r".*moe/w_(gate|up)$", -1, "tp_out"),  # [L, E, d, ff]
    (r".*moe/w_down$", -2, "tp_in"),        # [L, E, ff, d]
    (r".*embed$", 0, "vocab"),
    (r".*head$", -1, "vocab"),
    (r".*rwkv/(ck)$", -1, "tp_out"),
    (r".*rwkv/(cv)$", -2, "tp_in"),
    (r".*rwkv/w[rkvg]$|.*rwkv/wo$", -1, "tp_out_sq"),
    (r".*mamba/w_in$", -1, "tp_out"),
    (r".*mamba/w_out$", -2, "tp_in"),
]


def param_sharding(
    params,
    mesh: Mesh,
    cfg,
    *,
    fsdp: bool = True,
    min_fsdp_size: int = 2**16,
    wide_tp: bool = False,
    tp_enabled: bool = True,
):
    """Returns a tree of placement specs (one tuple per leaf, in the
    reference's stacked layout) matching ``params``: leaves are anything
    with a ``shape`` (tensors, numpy arrays).

    TP where divisible; optional FSDP on the largest remaining dim (prefers
    dims already unsharded). kv-head projections smaller than the model axis
    stay replicated across "model" (GQA kv<TP).

    ``wide_tp`` (serving): TP dims shard over ALL mesh axes (data+model
    combined) when divisible. ``tp_enabled=False``: pure-DP/FSDP layout (no
    model-axis param sharding).
    """
    m_ax = model_axis(mesh)
    m_size = mesh.shape[m_ax] if m_ax else 1
    d_ax = data_axes(mesh)
    d_size = data_extent(mesh)
    all_ax = tuple(d_ax) + ((m_ax,) if m_ax else ())
    all_size = d_size * m_size

    def one(pstr, shape):
        ndim = len(shape)
        spec = [None] * ndim
        if tp_enabled and m_ax and m_size > 1:
            for pat, dim, _group in _TP_RULES:
                if re.match(pat, pstr):
                    di = dim % ndim
                    # wide TP only where no head-reshape follows the matmul
                    # (attention projections reshape H*hd -> [H, hd]).
                    wide_ok = wide_tp and "attn/" not in pstr
                    if wide_ok and shape[di] % all_size == 0:
                        spec[di] = all_ax
                    elif shape[di] % m_size == 0:
                        spec[di] = m_ax
                    break
        if fsdp and d_ax and d_size > 1 and math.prod(shape) >= min_fsdp_size:
            # largest unsharded dim divisible by the data extent
            used = {a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))}
            if not (used & set(d_ax)):
                cand = sorted((i for i in range(ndim) if spec[i] is None),
                              key=lambda i: -shape[i])
                for i in cand:
                    if shape[i] % d_size == 0:
                        spec[i] = d_ax if len(d_ax) > 1 else d_ax[0]
                        break
        return tuple(spec)

    return unflatten_paths({path: one(path, stacked_shape(leaf))
                            for path, leaf in flat_paths(params).items()})


def batch_sharding(mesh: Mesh, ndim: int, *, batch_dim: int = 0) -> tuple:
    d_ax = data_axes(mesh)
    spec = [None] * ndim
    if d_ax:
        spec[batch_dim] = d_ax if len(d_ax) > 1 else d_ax[0]
    return tuple(spec)


def replicated(mesh: Mesh) -> tuple:
    return ()


def moment_sharding(param_specs, eight_bit: bool) -> dict:
    """Placement specs of the optimizer state (``optimizer.init``'s tree)
    that put each moment where its param lies: ``m`` and ``v`` (or their
    int8 values ``q``) take the param's spec, an 8-bit row scale ``s`` (last
    dim 1) the same without its last dim. The moments' count is whole."""
    out = {}
    for path, spec in flat_paths(param_specs).items():
        for mom in ("m", "v"):
            if eight_bit:
                out[f"mu/{path}/{mom}/q"] = spec
                out[f"mu/{path}/{mom}/s"] = spec[:-1] + (None,) if spec else spec
            else:
                out[f"mu/{path}/{mom}"] = spec
    out["count"] = ()
    return unflatten_paths(out)


# -- carrying a placement out on the mesh ---------------------------------------

def _dim_on(spec, axes: set) -> Optional[int]:
    """The dim of ``spec`` that names any of ``axes`` (None: none does)."""
    for i, s in enumerate(spec):
        named = set(s) if isinstance(s, tuple) else {s}
        if s is not None and named & axes:
            return i
    return None


def data_dim(spec, mesh: Mesh) -> Optional[int]:
    """The dim of ``spec`` on the data axes (None: replicated over them),
    a dim that also names "model" (``wide_tp``) included."""
    return _dim_on(spec, set(data_axes(mesh)))


def model_dim(spec, mesh: Mesh) -> Optional[int]:
    """The dim of ``spec`` on "model" (None: replicated over it), a dim
    that also names the data axes (``wide_tp``) included."""
    return _dim_on(spec, {"model"})


def wide_dim(spec, mesh: Mesh) -> Optional[int]:
    """The dim of ``spec`` that names both the data axes and "model"
    (``wide_tp``: split over every rank of the mesh, data-major), or None."""
    d = data_dim(spec, mesh)
    return d if d is not None and d == model_dim(spec, mesh) else None


_DIM_OF = {"data": data_dim, "model": model_dim, "wide": wide_dim}


#: ``placed_dims``' value for a leaf whose spec places a list above it (the
#: layer list's dim of the reference's stacked leaf) on the data axes:
#: each data rank holds its items of that list, whole, in rank order, and
#: None in place of the other items (``shard_lists``)
LIST = "list"


def _walk(tree, specs, fn):
    """The tree of ``fn(x, key, spec, idx, lens)`` over the leaves ``x``
    of ``tree`` (the port's layout; None stands for an item that this rank
    does not hold): its ``/``-joined path, its spec in ``specs`` (the
    reference's stacked layout; None for a None leaf without one), its
    index in each list above it and those lists' lengths."""
    flat = flat_paths(specs)

    def walk(x, path, idx, lens):
        if isinstance(x, dict):
            return {k: walk(v, path + (str(k),), idx, lens) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, path, idx + (i,), lens + (len(x),)) for i, v in enumerate(x)]
        key = "/".join(path)
        return fn(x, key, flat[key] if x is not None else flat.get(key), idx, lens)

    return walk(tree, (), (), ())


def placed_dims(tree, specs, mesh: Mesh, axis: str = "data"):
    """Per leaf of ``tree`` (the port's layout), the tensor dim that its spec
    (``specs``: the reference's stacked layout) places on the data axes
    (``axis="data"``), on "model" (``axis="model"``) or on both at once
    (``axis="wide"``), or None; a wide dim counts for "data" and "model"
    too. A spec that places a list dim on the data axes gives ``LIST``; on
    "model" it is refused (the port's model code splits tensor dims)."""
    dim_of = _DIM_OF[axis]

    def one(x, key, spec, idx, lens):
        d = None if spec is None else dim_of(spec, mesh)
        if d is None or d >= len(idx):
            return None if d is None else d - len(idx)
        if axis != "data" or model_dim(spec, mesh) == d:
            raise NotImplementedError(
                f"{key}: spec {spec} places list dim {d} on the {axis} axes; only the data "
                "axes take a list dim (whole layers per rank)")
        return LIST

    return _walk(tree, specs, one)


def _list_owner(key, spec, idx, lens, mesh: Mesh) -> Optional[int]:
    """The data rank that holds this item of a leaf placed on a list dim
    (items ``[r * n / W, (r + 1) * n / W)`` of that list on rank r), or
    None for a leaf not placed so."""
    d = None if spec is None else data_dim(spec, mesh)
    if d is None or d >= len(idx):
        return None
    w = data_extent(mesh)
    if lens[d] % w:
        raise ValueError(f"{key}: spec {spec} places a list of {lens[d]} items on {w} data "
                         "ranks")
    return idx[d] // (lens[d] // w)


def shard_lists(tree, specs, mesh: Mesh):
    """``tree`` with each leaf that its spec places on a list dim cut to
    this data rank's items of that list: None in place of the others
    (already None stays None). Every other leaf is left as it is."""
    if data_extent(mesh) == 1:
        return tree
    r = rank_of(mesh)

    def one(x, key, spec, idx, lens):
        owner = _list_owner(key, spec, idx, lens, mesh)
        return x if owner is None or owner == r else None

    return _walk(tree, specs, one)


def gather_lists(tree, specs, mesh: Mesh):
    """The inverse of ``shard_lists``, on every data rank: each leaf placed
    on a list dim gets every item of that list (one ``all_gather`` over the
    data group per such leaf, of each rank's items stacked in tree order);
    this rank's own items are kept as they are, and every other leaf too."""
    if data_extent(mesh) == 1:
        return tree
    r = rank_of(mesh)
    mine: dict = {}

    def collect(x, key, spec, idx, lens):
        if _list_owner(key, spec, idx, lens, mesh) == r:
            mine.setdefault(key, []).append(x)
        return x

    _walk(tree, specs, collect)
    parts = {key: [p.unbind(0) for p in dp.all_gather(torch.stack(xs), mesh.group)]
             for key, xs in mine.items()}
    taken: dict = {}

    def fill(x, key, spec, idx, lens):
        owner = _list_owner(key, spec, idx, lens, mesh)
        if owner is None or owner == r:
            return x
        i = taken.get((key, owner), 0)
        taken[(key, owner)] = i + 1
        return parts[key][owner][i]

    return _walk(tree, specs, fill)


def rank_of(mesh: Mesh) -> int:
    """This process's rank along the data axes (0 with one rank)."""
    return dist.get_rank(mesh.group) if data_extent(mesh) > 1 else 0


def model_rank(mesh: Mesh) -> int:
    """This process's rank along "model" (0 with one rank)."""
    return dist.get_rank(mesh.model_group) if model_extent(mesh) > 1 else 0


def is_first(mesh: Optional[Mesh]) -> bool:
    """Whether this process is the mesh's first rank (rank 0 on both axes)."""
    return mesh is None or (rank_of(mesh) == 0 and model_rank(mesh) == 0)


def _axes(mesh: Mesh, axes) -> list:
    """(axis, ranks, this rank, group) of each of ``axes`` with several
    ranks."""
    out = []
    if "data" in axes and data_extent(mesh) > 1:
        out.append(("data", data_extent(mesh), rank_of(mesh), mesh.group))
    if "model" in axes and model_extent(mesh) > 1:
        out.append(("model", model_extent(mesh), model_rank(mesh), mesh.model_group))
    return out


def shard_tree(tree, specs, mesh: Mesh, *, lists: bool = True):
    """This rank's block of every leaf: its slice (an owned copy) along the
    dim that the leaf's spec places on the data axes and along the one it
    places on "model"; a replicated leaf, or any leaf with one rank, is the
    leaf itself. A dim on both (``wide_tp``) is cut over the data ranks,
    then each piece over the model ranks: block ``data_rank * model_ranks
    + model_rank``, the order of the spec's axes. A leaf placed on a list
    dim keeps this data rank's items of that list (``shard_lists``; with
    ``lists=False`` all of them)."""
    placed_dims(tree, specs, mesh)  # a list dim on "model" is refused with one rank too
    out = tree
    for axis, n_ranks, r, _group in _axes(mesh, ("data", "model")):
        dims = placed_dims(out, specs, mesh, axis)

        def take(x, d, n_ranks=n_ranks, r=r):
            if d is None or d == LIST or x is None:
                return x
            n = x.shape[d] // n_ranks
            return x.narrow(d, r * n, n).clone()

        out = tree_map(lambda x, d, stacked: take(x, d), out, dims)
    return shard_lists(out, specs, mesh) if lists else out


def gather_tree(tree, specs, mesh: Mesh, axes=("data", "model")):
    """The inverse of ``shard_tree`` on ``axes``: every leaf whole along
    them on every rank (an ``all_gather`` over the axis's group per placed
    leaf; "model" first, so that a wide leaf's pieces join in
    ``shard_tree``'s order; a leaf placed on a list dim by
    ``gather_lists``). A wide leaf is gathered on both axes or on none:
    ``axes=("data",)`` refuses it."""
    placed_dims(tree, specs, mesh)
    if set(axes) != {"data", "model"} and any(
            d is not None for d in leaves(placed_dims(tree, specs, mesh, "wide"))):
        raise NotImplementedError(f"a wide leaf (data and model on one dim) gathers on both "
                                  f"axes, not on {tuple(axes)} alone")
    out = tree
    for axis, _n, _r, group in reversed(_axes(mesh, axes)):
        dims = placed_dims(out, specs, mesh, axis)

        def gather(x, d, group=group):
            if d is None or d == LIST or x is None:
                return x
            return torch.cat(dp.all_gather(x, group), dim=d)

        out = tree_map(lambda x, d, stacked: gather(x, d), out, dims)
    return gather_lists(out, specs, mesh) if "data" in axes else out
