"""Explicit placement specs for the decode/prefill states per family.

Port of the JAX package's ``repro/launch/shardspecs.py``. Rules (DESIGN.md
§5): cache batch on the data axes when divisible; when the batch is too
small (long_500k, batch = 1) the cache's *sequence* dim goes on the data
axes (sequence-parallel decode); heads / ssm heads / feature dims on
"model" when divisible.

The specs are tuples (one mesh axis, tuple of axes or None per dim), in the
reference's stacked layout, as ``distributed.sharding.param_sharding``
gives them. The port's decode state (``models.model.init_decode_state``)
holds a list per layer, or a list per group (vlm, hybrid), where the
reference stacks; ``repro_torch.tree`` describes it as the reference's
paths and stacked shapes (a ``KVCache`` as its four fields). Each path has
its rule in ``_RULES``, chosen by name and never from a shape.

``shard_state`` carries a placement out on a live state (each rank keeps
its block of every cache, position and recurrent leaf: a KV cache by batch,
or by sequence where the batch does not split, and by KV heads) and
``gather_state`` undoes it; the placed serving step
(``launch/serve_step.py``) holds its state so, by
``placed_state_shardings``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import KVCache
from repro_torch.tree import flat_paths, stacked_shape, unflatten_paths


def _div(n, by) -> bool:
    return by > 0 and n % by == 0


def _as_tree(x):
    """Dicts and lists as they are, a ``KVCache`` as the dict of its fields."""
    if isinstance(x, KVCache):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_as_tree(v) for v in x]
    return x


def _cache_rule(spec, shape, ax):
    """[..., B, S, H, hd]: batch (else sequence) on data, heads on model."""
    nd = len(shape)
    b_ax, s_ax, h_ax = nd - 4, nd - 3, nd - 2
    if ax.batch(shape[b_ax]):
        spec[b_ax] = ax.d_axes
    elif _div(shape[s_ax], ax.d_size):
        spec[s_ax] = ax.d_axes
    spec[h_ax] = ax.model(shape[h_ax])


def _pos_rule(spec, shape, ax):
    """[..., B, S] cache positions: batch, else sequence, on data."""
    nd = len(shape)
    b_ax, s_ax = nd - 2, nd - 1
    if ax.batch(shape[b_ax]):
        spec[b_ax] = ax.d_axes
    elif _div(shape[s_ax], ax.d_size):
        spec[s_ax] = ax.d_axes


def _ssm_h_rule(spec, shape, ax):
    """[..., B, H, N, P]: batch on data, heads on model."""
    nd = len(shape)
    spec[nd - 4] = ax.batch(shape[nd - 4])
    spec[nd - 3] = ax.model(shape[nd - 3])


def _shift_rule(spec, shape, ax):
    """[L, B, d]: batch on data, features on model."""
    spec[1] = ax.batch(shape[1])
    spec[2] = ax.model(shape[2])


def _lead_batch_rule(spec, shape, ax):
    """[B, ...]: batch on data."""
    spec[0] = ax.batch(shape[0])


def _replicated(spec, shape, ax):
    pass


#: the reference's path -> its rule. The reference picks a rule by suffix
#: in a fixed order (``repro/launch/shardspecs.py:38-82``), and its first
#: test (a path ending in "k" or "v") also takes ``ssm/conv`` and ``wkv``:
#: both get the cache rule there, and so here.
_RULES = {
    "kv/k": _cache_rule,
    "kv/v": _cache_rule,
    "ssm/conv": _cache_rule,
    "wkv": _cache_rule,
    "kv/pos": _pos_rule,
    "kv/length": _replicated,
    "ssm/h": _ssm_h_rule,
    "tshift": _shift_rule,
    "cshift": _shift_rule,
    "vision": _lead_batch_rule,
    "pos": _lead_batch_rule,
}


@dataclasses.dataclass(frozen=True)
class _Axes:
    d_axes: object  # the data axes as a spec entry (an axis, a tuple or None)
    d_size: int
    m_ax: object
    m_size: int

    def batch(self, b):
        return self.d_axes if _div(b, self.d_size) else None

    def model(self, n):
        return self.m_ax if _div(n, self.m_size) else None


def decode_state_shardings(cfg, mesh: shd.Mesh, state_specs) -> dict:
    """Placement specs of a decode state (``init_decode_state``'s output,
    plus ``vision`` for the vlm family): a nested dict of the reference's
    paths, one tuple per leaf. A path without a rule raises."""
    d_ax = shd.data_axes(mesh)
    m_ax = shd.model_axis(mesh)
    ax = _Axes(d_axes=d_ax if len(d_ax) > 1 else (d_ax[0] if d_ax else None),
               d_size=shd.data_extent(mesh), m_ax=m_ax,
               m_size=mesh.shape[m_ax] if m_ax else 1)
    out = {}
    for path, leaf in flat_paths(_as_tree(state_specs)).items():
        if leaf is None:  # the vlm's vision before a prefill: no leaf
            continue
        if path not in _RULES:
            raise ValueError(f"{cfg.name}: decode-state path {path!r} has no placement rule")
        shape = stacked_shape(leaf)
        spec = [None] * len(shape)
        _RULES[path](spec, shape, ax)
        out[path] = tuple(spec)
    return unflatten_paths(out)


def batch_shardings(mesh: shd.Mesh, batch_specs) -> dict:
    """The batch dim of every input on the data axes."""
    return {k: shd.batch_sharding(mesh, len(v.shape)) for k, v in batch_specs.items()}


# -- carrying the placement out on a live state ---------------------------------

#: the recurrent leaves (Mamba2's ``h`` and ``conv``, RWKV6's ``wkv`` and
#: shifts) -> their batch dim in the stacked layout. Their blocks run whole
#: on every model rank (``distributed/tp.py``), so the placed serving step
#: holds them by batch on the data axes (when it divides) and whole over
#: "model", where the reference's specs split heads or features on "model"
#: (and its cache rule, which also takes ``ssm/conv`` and ``wkv``, would put
#: a group or head dim on the data axes).
_RECURRENT = {"ssm/h": -4, "ssm/conv": -3, "wkv": 1, "tshift": 1, "cshift": 1}


def placed_state_shardings(cfg, mesh: shd.Mesh, state) -> dict:
    """The specs by which the placed serving step holds a decode state:
    ``decode_state_shardings``' for the KV caches, their positions, the
    lanes' positions and ``vision``, and for the recurrent leaves
    (``_RECURRENT``) the batch on the data axes when it divides, else
    nothing."""
    flat = flat_paths(decode_state_shardings(cfg, mesh, state))
    d_ax = shd.data_axes(mesh)
    d_axes = d_ax if len(d_ax) > 1 else (d_ax[0] if d_ax else None)
    shapes = flat_paths(_as_tree(state))
    for path, b_ax in _RECURRENT.items():
        if path in flat:
            shape = stacked_shape(shapes[path])
            spec = [None] * len(shape)
            if _div(shape[b_ax], shd.data_extent(mesh)):
                spec[b_ax] = d_axes
            flat[path] = tuple(spec)
    return unflatten_paths(flat)


def _like(tree, like):
    """``tree`` (``_as_tree``'s layout) with a ``KVCache`` wherever ``like``
    has one."""
    if isinstance(like, KVCache):
        return KVCache(**tree)
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_like(t, v) for t, v in zip(tree, like)]
    return tree


def shard_state(state, specs, mesh: shd.Mesh):
    """This rank's block of every leaf of a decode state (the same whole
    state on every rank), by ``specs`` (``placed_state_shardings``)."""
    return _like(shd.shard_tree(_as_tree(state), specs, mesh), state)


def gather_state(state, specs, mesh: shd.Mesh):
    """The inverse of ``shard_state``, on every rank (collective)."""
    return _like(shd.gather_tree(_as_tree(state), specs, mesh), state)
