"""Model assembly of the port: all ten archs behind one API (the dense, moe,
vlm, audio, hybrid and ssm families).

Port of the JAX package's ``repro/models/model.py``. Parameters are a plain
dict of tensors with one entry per layer in a list where the JAX package
stacks the layers on a leading dim for ``scan``; the layers run in a Python
loop. Grouped stacks keep the reference's grouping: the vlm family's
``groups`` are a list of ``{"self": [cross_attn_every - 1 blocks], "cross":
block}``, the hybrid family's a list of ``{"mamba": [attn_every blocks]}``
with one ``shared_attn`` block applied after each group. Weights keep the
JAX layout (``x @ W``, W ``[in, out]``), so ``params_from_numpy`` carries
the JAX parameters across with no transposes.

Public API:
    init_params(cfg, generator, device)        -> params
    params_from_numpy(tree, cfg, device)       -> params (from the JAX pytree)
    forward(params, batch, cfg, remat=...)     -> (logits [B, T, V] f32, aux)
    train_loss(params, batch, cfg)             -> (loss, metrics)
    init_decode_state(cfg, batch, max_len, device) -> cache state
    prefill(params, batch, state, cfg)         -> (logits_last, state)
    decode_step(params, token, state, cfg)     -> (logits, state)

``forward`` attends through the plain chunked ``layers.attention`` (it is
differentiable; the JAX package trains through the same function); only
the cached path's prefill asks for the forward-only ``flash_attention``
kernel, in each self-attention layer (the dense, moe and vlm families) and
each application of the hybrid family's shared block. Cross-attention
attends through the plain ``attention`` (queries and keys differ in
length). A moe layer's FFN is ``moe.moe_ffn`` (one ``dispatch_plan`` launch
per layer call on the card); ``forward`` sums its aux loss over the layers,
the cached path drops it, as the reference does. The audio family has no
decode path, as in the reference.

Under tensor parallelism (``distributed.tp``: the training step and the
placed serving step, ``launch/serve_step.py``) a vocab-split ``embed`` is a
masked lookup plus one ``all_reduce``, a vocab-split ``head`` gives this
rank's columns of the logits (gathered whole on the vocab by the cached
path), and ``train_loss`` takes the cross-entropy and z-loss from the
shards' ``[B, T]`` statistics (``TP.vocab_stats``). Under ``seqpar`` the
residual stream holds the rank's part of the tokens (``TP.part``), which
stands for the reference's ``constrain(x, ("batch", "seq", None))``
points: the embedding reduce-scatters it, each block gathers it (Mamba2's
scan and RWKV6's token shift and WKV state run over the gathered tokens
and keep the rank's part of their output), ``forward``'s head gathers the
tokens before its product, and the cached path's head reads the last
token from the last model rank. In training each rank's loss is then its
share of the model group's (``distributed/tp.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import dp
from repro_torch.distributed import tp
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(p, x, cfg, positions, cache, q_chunk, k_chunk, flash=False):
    h, new_cache = L.self_attention_block(
        p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
        positions=positions, cache=cache, q_chunk=q_chunk, k_chunk=k_chunk, flash=flash,
    )
    x = x + h
    y = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, aux = MOE.moe_ffn(p["moe"], y, cfg)
    else:
        ff, aux = L.mlp(p["mlp"], y, cfg.act), None
    return x + ff, new_cache, aux


def _attn_block_init(generator, cfg, dtype, device, cross=False):
    p = {
        "attn": L.attn_init(generator, cfg, dtype, device, cross=cross),
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.n_layers,
                              dtype, device)
    return p


def _cross_block(p, x, cfg, vision, q_chunk, k_chunk):
    h = L.cross_attention_block(
        p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), vision, cfg,
        q_chunk=q_chunk, k_chunk=k_chunk,
    )
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)


def _mamba_block_init(generator, cfg, dtype, device):
    return {
        "mamba": M2.mamba2_init(generator, cfg, dtype, device),
        "ln": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _mamba_block(p, x, cfg, state):
    h, new_state = M2.mamba2_block(
        p["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps), cfg, state=state)
    return x + h, new_state


def _rwkv_block_init(generator, cfg, dtype, device):
    return {
        "rwkv": R6.rwkv6_init(generator, cfg, dtype, device),
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _rwkv_block(p, x, cfg, state, chunk_size):
    """state: dict(tshift [B,d], wkv [B,H,P,P], cshift [B,d]) or None."""
    st_t = None if state is None else {"shift": state["tshift"], "wkv": state["wkv"]}
    h, new_t = R6.rwkv6_time_mix(
        p["rwkv"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
        state=st_t, chunk_size=chunk_size,
    )
    x = x + h
    st_c = None if state is None else state["cshift"]
    h2, new_c = R6.rwkv6_channel_mix(
        p["rwkv"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg, state=st_c)
    return x + h2, {"tshift": new_t["shift"], "wkv": new_t["wkv"], "cshift": new_c}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn on ``device`` from ``generator`` (a
    ``torch.Generator`` on that device). The draws differ from
    ``jax.random``'s; ``params_from_numpy`` carries JAX weights across.
    Leaves the reference draws in float32 inside a bf16 model (a MoE
    router; RWKV6's mixes, decay and bonus; Mamba2's A, D and dt bias) are
    float32 here too."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model), 1.0, dtype, dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "head": L.dense_init(generator, (cfg.d_model, cfg.vocab), 1.0, dtype, dev),
    }
    if cfg.family in ("dense", "moe", "audio"):
        params["layers"] = [_attn_block_init(generator, cfg, dtype, dev)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "vlm":
        g, s = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
        params["groups"] = [
            {"self": [_attn_block_init(generator, cfg, dtype, dev) for _ in range(s)],
             "cross": _attn_block_init(generator, cfg, dtype, dev, cross=True)}
            for _ in range(g)]
    elif cfg.family == "hybrid":
        params["groups"] = [
            {"mamba": [_mamba_block_init(generator, cfg, dtype, dev)
                       for _ in range(cfg.attn_every)]}
            for _ in range(cfg.n_layers // cfg.attn_every)]
        params["shared_attn"] = _attn_block_init(generator, cfg, dtype, dev)
    elif cfg.family == "ssm":
        params["layers"] = [_rwkv_block_init(generator, cfg, dtype, dev)
                            for _ in range(cfg.n_layers)]
    else:
        raise ValueError(cfg.family)
    return params


def _tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # owned and writable (JAX leaves are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _carry(node, device, index=()):
    """A JAX (sub)tree as tensors on ``device``, each leaf indexed by
    ``index`` (the positions on its stacked leading dims) and kept in its
    own dtype (bf16 bits carried exactly)."""
    if isinstance(node, dict):
        return {k: _carry(v, device, index) for k, v in node.items()}
    a = np.asarray(node)[index]
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else getattr(torch, a.dtype.name)
    return _tensor_from_numpy(a, dtype, device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The JAX ``init_params`` pytree, taken leaf by leaf with
    ``np.asarray``, as the port's parameters: stacked leaves are split on
    their leading dims (``layers`` on one; the vlm's ``groups`` on one, its
    ``self`` blocks on two; the hybrid's ``groups/mamba`` on two), and every
    leaf becomes a tensor on ``device`` of the JAX leaf's own dtype (a bf16
    model's float32 leaves stay float32, bit for bit). Same layout, so no
    transposes."""
    dev = resolve_device(device)
    out = {k: _carry(tree[k], dev) for k in ("embed", "ln_f", "head")}
    if cfg.family in ("dense", "moe", "audio", "ssm"):
        out["layers"] = [_carry(tree["layers"], dev, (i,)) for i in range(cfg.n_layers)]
    elif cfg.family == "vlm":
        grp = tree["groups"]
        s = cfg.cross_attn_every - 1
        out["groups"] = [{"self": [_carry(grp["self"], dev, (g, i)) for i in range(s)],
                          "cross": _carry(grp["cross"], dev, (g,))}
                         for g in range(cfg.n_layers // cfg.cross_attn_every)]
    elif cfg.family == "hybrid":
        mb = tree["groups"]["mamba"]
        out["groups"] = [{"mamba": [_carry(mb, dev, (g, i)) for i in range(cfg.attn_every)]}
                         for g in range(cfg.n_layers // cfg.attn_every)]
        out["shared_attn"] = _carry(tree["shared_attn"], dev)
    else:
        raise ValueError(cfg.family)
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a params or decode-state tree (dicts,
    lists, ``KVCache``s), leaf by leaf with the same leaves of ``rest``; a
    ``None`` leaf (the vlm's vision tokens before a prefill) stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *r) for v, *r in zip(tree, *rest)]
    if isinstance(tree, L.KVCache):
        return L.KVCache(*(tree_map(fn, getattr(tree, f.name),
                                    *(getattr(r, f.name) for r in rest))
                           for f in dataclasses.fields(L.KVCache)))
    return fn(tree, *rest)


def to_device(tree, device):
    """``tree`` (params or decode state) with every tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# forward (training / no-cache path)
# ---------------------------------------------------------------------------

def _embed(params, batch, cfg):
    """Token or stub-frontend embedding. batch: dict with 'tokens' [B,T] int
    or 'embeds' [B,T,d] (audio frames / any precomputed stream). Under
    ``seqpar`` (``distributed.tp``) the rank's part of the tokens."""
    par = tp.current()
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
        return x if par is None else par.part(x)
    if par is not None and par.kind(params["embed"]) is not None:
        return par.embed(params["embed"], batch["tokens"])
    x = params["embed"][batch["tokens"].long()]
    return x if par is None else par.part(x)


def _vocab_split(params) -> bool:
    par = tp.current()
    return par is not None and par.dim(params["head"]) is not None


def _head_logits(params, x, cfg, whole: bool = False):
    """The logits in f32: this rank's vocab columns when ``head`` is split
    over "model", unless ``whole`` (serving's last token) gathers every
    column. ``x`` is the stream (``forward``: under ``seq`` the rank's
    tokens, gathered here after the norm) or, with ``whole``, the last
    token, which every rank holds."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    par = tp.current()
    kind = None if par is None else par.kind(params["head"])
    if par is not None and not whole:
        x = par.full(x)
    if kind:
        x = par.enter(params["head"], x)
    # The JAX package takes f32 logits from bf16 operands
    # (preferred_element_type=f32): each bf16 x bf16 product is exact in f32
    # and the sum is kept in f32. Upcasting both operands to f32 exactly and
    # taking an f32 product computes the same.
    logits = torch.matmul(x.to(F32), params["head"].to(F32))
    return par.vocab_whole(params["head"], logits) if kind and whole else logits


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 1024, k_chunk: int = 1024, rwkv_chunk: int = 1):
    """Full-sequence forward -> (logits [B, T, V] f32, aux loss). ``batch``
    may carry 'vision_embeds' [B, Nv, d] for the vlm family. ``remat``
    recomputes each block in the backward pass (``torch.utils.checkpoint``,
    non-reentrant) where the reference wraps its scan body in
    ``jax.checkpoint`` (not the hybrid family's shared block)."""
    x = _embed(params, batch, cfg)
    b, t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[:2]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)[None].expand(b, t)
    zero = torch.zeros((), dtype=F32, device=x.device)
    run = lambda fn, *a: checkpoint(fn, *a, use_reentrant=False) if remat else fn(*a)

    def attn_body(x, p):
        y, _, aux = _attn_block(p, x, cfg, positions, None, q_chunk, k_chunk)
        return y, (aux["aux_loss"] if aux else zero)

    aux_acc = zero
    if cfg.family in ("dense", "moe", "audio"):
        auxs = []
        for p in params["layers"]:
            x, aux = run(attn_body, x, p)
            auxs.append(aux)
        aux_acc = torch.stack(auxs).sum()
    elif cfg.family == "vlm":
        vision = batch["vision_embeds"].to(_dtype(cfg))
        cross = lambda x, p: _cross_block(p, x, cfg, vision, q_chunk, k_chunk)
        for gp in params["groups"]:
            for p in gp["self"]:
                x, _ = run(attn_body, x, p)
            x = run(cross, x, gp["cross"])
    elif cfg.family == "hybrid":
        mamba = lambda x, p: _mamba_block(p, x, cfg, None)[0]
        for gp in params["groups"]:
            for p in gp["mamba"]:
                x = run(mamba, x, p)
            x, _, _ = _attn_block(params["shared_attn"], x, cfg, positions, None,
                                  q_chunk, k_chunk)
    elif cfg.family == "ssm":
        rwkv = lambda x, p: _rwkv_block(p, x, cfg, None, rwkv_chunk)[0]
        for p in params["layers"]:
            x = run(rwkv, x, p)
    else:
        raise ValueError(cfg.family)

    logits = _head_logits(params, x, cfg)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, aux_acc


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
               q_chunk: int = 1024, k_chunk: int = 1024, rwkv_chunk: int = 1):
    """Next-token CE over the labels >= 0 (the ingest's dropped rows carry
    -1) for causal archs, per-frame CE with unshifted labels for the
    encoder (audio), plus z-loss 1e-4 and 0.01 x the aux loss (the moe
    layers' summed load-balance loss; zero for the other families), as the
    reference computes them.

    Under tensor parallelism with ``head`` split on the vocab, ``logits``
    are this rank's columns and the CE and z-loss come from the shards'
    statistics. Under ``distributed.dp.use_slots`` (a training step over
    several ranks) the CE and the z-loss divide by the label count of the whole
    microbatch (a sum over its ranks), and the moe layers' aux loss is this
    rank's share: each rank's loss, and its gradient, is its share of the
    microbatch's, and the shares add up to it. Under ``seqpar`` the terms
    that every rank of the model group computes whole (the CE and z-loss
    over the gathered tokens, the aux loss) count ``1 / size`` on each, so
    the loss and every metric are the rank's share of the model group's as
    well."""
    logits, aux = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk,
                          k_chunk=k_chunk, rwkv_chunk=rwkv_chunk)
    labels = batch["labels"].long()
    if cfg.causal:
        logits_s, labels_s = logits[:, :-1], labels[:, 1:]
    else:
        logits_s, labels_s = logits, labels
    mask = (labels_s >= 0).to(F32)
    # a masked label reads any column: its term is multiplied by 0
    if _vocab_split(params):
        ll, lse = tp.current().vocab_stats(logits_s, labels_s.clamp(min=0))
    else:
        logp = torch.log_softmax(logits_s, dim=-1)
        ll = logp.gather(-1, labels_s.clamp(min=0)[..., None])[..., 0]
        lse = torch.logsumexp(logits_s, dim=-1)
    denom = torch.clamp(dp.slot_sum(mask.sum()), min=1.0)
    ce = -(ll * mask).sum() / denom
    # z-loss keeps the softmax normalizer tame (standard at scale).
    zl = 1e-4 * ((lse ** 2) * mask).sum() / denom
    par = tp.current()
    if par is not None and par.seq:
        ce, zl, aux = (v / par.size for v in (ce, zl, aux))
    loss = ce + zl + 0.01 * aux
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux}


# ---------------------------------------------------------------------------
# decode path (serving)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Cache state for serving. Attention caches are ring buffers of size
    min(max_len, swa_window or max_len), one per self-attention layer (the
    vlm's in a list per group) or one per application of the hybrid's shared
    block; Mamba2 and RWKV6 states are O(1) in the length (float32, but the
    Mamba2 conv carry in the model's dtype), one per block. The vlm's
    ``vision`` is ``None`` until a prefill stores the batch's
    ``vision_embeds``. The audio family (an encoder) has none."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    size = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    kv = lambda n: [L.init_kv_cache(batch, size, cfg.n_kv_heads, cfg.hd, dtype, dev)
                    for _ in range(n)]
    if cfg.family in ("dense", "moe"):
        return {"kv": kv(cfg.n_layers), "pos": pos}
    if cfg.family == "vlm":
        g, s = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
        return {"kv": [kv(s) for _ in range(g)], "pos": pos, "vision": None}
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        ssm = lambda: {
            "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=F32, device=dev),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                                device=dev),
        }
        return {"kv": kv(g), "ssm": [[ssm() for _ in range(cfg.attn_every)]
                                     for _ in range(g)], "pos": pos}
    if cfg.family == "ssm":
        h, p = cfg.rwkv_heads, cfg.ssm_head_dim
        zeros = lambda *shape: [torch.zeros(shape, dtype=F32, device=dev)
                                for _ in range(cfg.n_layers)]
        return {"wkv": zeros(batch, h, p, p), "tshift": zeros(batch, cfg.d_model),
                "cshift": zeros(batch, cfg.d_model), "pos": pos}
    raise ValueError(f"{cfg.name}: family {cfg.family} has no decode path")


def step_with_cache(params, batch, state, cfg: ModelConfig, *,
                    q_chunk: int = 1024, k_chunk: int = 1024, rwkv_chunk: int = 1):
    """Run T tokens (T=1 decode, T>1 prefill) against the cache state; the
    KV caches in ``state`` are written in place, the Mamba2 and RWKV6
    states returned anew. A vlm batch carries ``vision_embeds`` at its
    prefill; later steps reuse the stored ones."""
    x = _embed(params, batch, cfg)
    b, t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[:2]
    pos0 = state["pos"]  # int32[B] — lanes advance independently
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    new_state: dict[str, Any] = dict(state)
    new_state["pos"] = pos0 + t

    def attn(p, x, cache):
        y, nc, _ = _attn_block(p, x, cfg, positions, cache, q_chunk, k_chunk, flash=True)
        return y, nc

    if cfg.family in ("dense", "moe"):
        new_kv = []
        for p, cache in zip(params["layers"], state["kv"]):
            x, nc = attn(p, x, cache)
            new_kv.append(nc)
        new_state["kv"] = new_kv
    elif cfg.family == "vlm":
        # Vision tokens are static across decode: captured at prefill,
        # reused from the state for the later steps.
        if "vision_embeds" in batch:
            vision = batch["vision_embeds"].to(_dtype(cfg))
            new_state["vision"] = vision
        elif state["vision"] is None:
            raise ValueError(f"{cfg.name}: the first step (prefill) takes the batch's "
                             "vision_embeds")
        else:
            vision = state["vision"]
        new_kv = []
        for gp, caches in zip(params["groups"], state["kv"]):
            ncs = []
            for p, cache in zip(gp["self"], caches):
                x, nc = attn(p, x, cache)
                ncs.append(nc)
            x = _cross_block(gp["cross"], x, cfg, vision, q_chunk, k_chunk)
            new_kv.append(ncs)
        new_state["kv"] = new_kv
    elif cfg.family == "hybrid":
        new_kv, new_ssm = [], []
        for gp, cache, ssm in zip(params["groups"], state["kv"], state["ssm"]):
            nss = []
            for p, st in zip(gp["mamba"], ssm):
                x, ns = _mamba_block(p, x, cfg, st)
                nss.append(ns)
            x, nc = attn(params["shared_attn"], x, cache)
            new_kv.append(nc)
            new_ssm.append(nss)
        new_state["kv"], new_state["ssm"] = new_kv, new_ssm
    elif cfg.family == "ssm":
        for name in ("tshift", "wkv", "cshift"):
            new_state[name] = []
        for i, p in enumerate(params["layers"]):
            st = {name: state[name][i] for name in ("tshift", "wkv", "cshift")}
            x, ns = _rwkv_block(p, x, cfg, st, rwkv_chunk)
            for name, v in ns.items():
                new_state[name].append(v)
    else:
        raise ValueError(cfg.family)

    par = tp.current()
    last = x[:, -1:, :] if par is None else par.last(x)
    logits = _head_logits(params, last, cfg, whole=True)
    return logits[:, 0], new_state


def prefill(params, batch, state, cfg: ModelConfig, **kw):
    return step_with_cache(params, batch, state, cfg, **kw)


def decode_step(params, tokens, state, cfg: ModelConfig, **kw):
    """tokens: int[B] -> (logits [B, V], new_state)."""
    return step_with_cache(params, {"tokens": tokens[:, None]}, state, cfg, **kw)
