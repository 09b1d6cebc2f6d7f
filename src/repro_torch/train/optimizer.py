"""AdamW with optional int8 per-row quantized moments (8-bit Adam).

Port of the JAX package's ``repro/train/optimizer.py``: plain functions over
the params tree, not ``torch.optim``, so the state keeps the reference's
keys (``mu/<path>/m|v``, ``count``) and checkpoints cross over. The update
is written in place: each parameter tensor, and each float32 moment, is
overwritten with its new value (under ``torch.no_grad``), and the returned
params and moments are the same tensors; a caller that needs the old
values copies them first (the checkpoint's ``AsyncSaver`` copies to the
host before it returns).

A leaf of the layer list counts the list as a leading dim
(``repro_torch.tree``), as the reference's stacked (scanned) layers do: the
rule "decoupled weight decay on matrices only" (``ndim >= 2``) then decays
the layers' norm scales and not ``ln_f``, as in the reference.

Over several ranks (``Shards``: data-parallel, and tensor-parallel on
"model"), each rank updates its blocks of the params and moments
(``distributed.sharding.shard_tree``; a moment lies as its param) with the
same numbers as the reference's one program: the clip's global norm sums
the ranks' squares over both axes, and an 8-bit moment whose rows are split
across ranks takes its row scale as the ``amax`` over them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import dp
from repro_torch.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    eight_bit: bool = False
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 (``step``: an int32 count)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _q_state(x):
    """Shape-preserving per-row int8 quantization (rows on the last dim);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _deq_state(st):
    return st["q"].to(F32) * st["s"]


def init(params, cfg: AdamWConfig):
    def one(p, stacked):
        z = torch.zeros(p.shape, dtype=F32, device=p.device)
        if cfg.eight_bit:
            return {"m": _q_state(z), "v": _q_state(z)}
        return {"m": z, "v": z.clone()}

    dev = leaves(params)[0].device
    return {"mu": tree_map(one, params), "count": torch.zeros((), dtype=torch.int32, device=dev)}


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where this rank's blocks lie: ``params`` holds, per param leaf, the
    tensor dim split across the ``world`` ranks of ``group`` (the data
    axes; None: whole along them), and ``model`` the dim split across the
    ``model_size`` ranks of ``model_group``. A moment lies as its param
    (``sharding.moment_sharding``)."""

    group: object
    rank: int
    world: int
    params: object
    model_group: object
    model_rank: int
    model_size: int
    model: object


def _q_shard(x, pd, pm, sh: Optional[Shards]):
    """``_q_state`` of a moment's block; a row split across ranks (the last
    dim split on the data axes, ``pd``, or on "model", ``pm``) takes the
    ``amax`` over all of them."""
    if sh is None:
        return _q_state(x)
    amax = x.abs().amax(dim=-1, keepdim=True)
    if pd == x.ndim - 1:
        dp.all_reduce(amax, sh.group, op=dist.ReduceOp.MAX)
    if pm == x.ndim - 1:
        dp.all_reduce(amax, sh.model_group, op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def global_norm(grads, sh: Optional[Shards] = None) -> torch.Tensor:
    """The L2 norm of all gradients, summed leaf by leaf in tree order. Over
    ranks (``grads`` this rank's blocks): the per-leaf squares summed over
    the data ranks, then over the model ranks (one ``all_reduce`` each), a
    leaf that the ranks of an axis hold whole counted from that axis's
    rank 0."""
    sq = [torch.sum(g.to(F32) ** 2) for g in leaves(grads)]
    if sh is not None:
        counted = [(d is not None or sh.rank == 0) and (m is not None or sh.model_rank == 0)
                   for d, m in zip(leaves(sh.params), leaves(sh.model))]
        vec = torch.stack([s if c else torch.zeros_like(s) for s, c in zip(sq, counted)])
        vec = dp.all_reduce(vec, sh.group)
        if sh.model_size > 1:
            vec = dp.all_reduce(vec, sh.model_group)
        sq = vec.unbind()
    return torch.sqrt(sum(sq))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, shards: Optional[Shards] = None):
    """Returns (params, new_state, metrics); ``params`` are updated in
    place. The arithmetic is the reference's, step for step, in float32.
    With ``shards`` the three trees hold this rank's slices."""
    count = state["count"] + 1
    lr = schedule(cfg, count)

    gnorm = global_norm(grads, shards)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1 - torch.pow(cfg.b1, count.to(F32))
    b2c = 1 - torch.pow(cfg.b2, count.to(F32))

    def one(p, g, mu, pd, pm, stacked):
        gf = g.to(F32) * clip
        if cfg.eight_bit:
            m, v = _deq_state(mu["m"]), _deq_state(mu["v"])
        else:
            m, v = mu["m"], mu["v"]
        # in place (the reference's products and sum, rounded the same), so a
        # step holds one copy of the float32 moments, not the old and the new
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim + stacked >= 2:  # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * upd).to(p.dtype))
        if cfg.eight_bit:
            return {"m": _q_shard(m, pd, pm, shards), "v": _q_shard(v, pd, pm, shards)}
        return {"m": m, "v": v}

    none = tree_map(lambda p, stacked: None, params)
    dims = none if shards is None else shards.params
    mdims = none if shards is None else shards.model
    new_mu = tree_map(one, params, grads, state["mu"], dims, mdims)
    return params, {"mu": new_mu, "count": count}, {"grad_norm": gnorm, "lr": lr}
