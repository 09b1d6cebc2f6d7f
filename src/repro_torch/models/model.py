"""Model assembly of the port: the dense and moe families' training and
prefill/decode paths.

Port of the JAX package's ``repro/models/model.py`` for the dense and moe
families. Parameters are a plain dict of tensors with one entry per layer in
``params["layers"]`` (a list) where the JAX package stacks the layers on a
leading dim for ``scan``; the layers run in a Python loop. Weights keep the
JAX layout (``x @ W``, W ``[in, out]``), so ``params_from_numpy`` carries the
JAX parameters across with no transposes.

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
kernel. A moe layer's FFN is ``moe.moe_ffn`` (one ``dispatch_plan`` launch
per layer call on the card); ``forward`` sums its aux loss over the layers,
the cached path drops it, as the reference does. The vlm, audio, hybrid and
ssm families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

F32 = torch.float32
_TODO = 'ROADMAP.md queue 1, the item "The other model families"'


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({_TODO})")


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


def _attn_block_init(generator, cfg, dtype, device):
    p = {
        "attn": L.attn_init(generator, cfg, dtype, device),
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.n_layers,
                              dtype, device)
    return p


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn on ``device`` from ``generator`` (a
    ``torch.Generator`` on that device). The draws differ from
    ``jax.random``'s; ``params_from_numpy`` carries JAX weights across."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    return {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model), 1.0, dtype, dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "head": L.dense_init(generator, (cfg.d_model, cfg.vocab), 1.0, dtype, dev),
        "layers": [_attn_block_init(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }


def _tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # owned and writable (JAX leaves are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The JAX ``init_params`` pytree (dense or moe family), taken leaf by
    leaf with ``np.asarray``, as the port's parameters: the stacked
    ``layers`` leaves are split on their leading dim, every leaf becomes a
    tensor of ``cfg.dtype`` on ``device`` but a MoE router, which stays
    float32 as ``moe.moe_init`` draws it. Same layout, so no transposes."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    conv = lambda a: _tensor_from_numpy(a, dtype, dev)

    def layer(node, i, name=None):
        if isinstance(node, dict):
            return {k: layer(v, i, k) for k, v in node.items()}
        return _tensor_from_numpy(np.asarray(node)[i], F32 if name == "router" else dtype,
                                  dev)

    out = {k: conv(np.asarray(tree[k])) for k in ("embed", "ln_f", "head")}
    out["layers"] = [layer(tree["layers"], i) for i in range(cfg.n_layers)]
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a params or decode-state tree (dicts,
    lists, ``KVCache``s), leaf by leaf with the same leaves of ``rest``."""
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
    or 'embeds' [B,T,d] (any precomputed stream)."""
    if "embeds" in batch:
        return batch["embeds"].to(_dtype(cfg))
    return params["embed"][batch["tokens"].long()]


def _head_logits(params, x, cfg):
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    # The JAX package takes f32 logits from bf16 operands
    # (preferred_element_type=f32): each bf16 x bf16 product is exact in f32
    # and the sum is kept in f32. Upcasting both operands to f32 exactly and
    # taking an f32 product computes the same.
    return torch.matmul(x.to(F32), params["head"].to(F32))


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 1024, k_chunk: int = 1024):
    """Full-sequence forward -> (logits [B, T, V] f32, aux loss). ``remat``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` around its scan body does."""
    _check_ported(cfg)
    x = _embed(params, batch, cfg)
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device)[None].expand(b, t)

    zero = torch.zeros((), dtype=F32, device=x.device)

    def body(x, p):
        y, _, aux = _attn_block(p, x, cfg, positions, None, q_chunk, k_chunk)
        return y, (aux["aux_loss"] if aux else zero)

    auxs = []
    for p in params["layers"]:
        x, aux = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
        auxs.append(aux)
    logits = _head_logits(params, x, cfg)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, torch.stack(auxs).sum()


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
               q_chunk: int = 1024, k_chunk: int = 1024):
    """Next-token CE over the labels >= 0 (the ingest's dropped rows carry
    -1), plus z-loss 1e-4 and 0.01 x the aux loss (the moe layers' summed
    load-balance loss; zero for the dense family), as the reference
    computes them."""
    logits, aux = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk,
                          k_chunk=k_chunk)
    labels = batch["labels"].long()
    if cfg.causal:
        logits_s, labels_s = logits[:, :-1], labels[:, 1:]
    else:
        logits_s, labels_s = logits, labels
    mask = (labels_s >= 0).to(F32)
    logp = torch.log_softmax(logits_s, dim=-1)
    # a masked label reads any column: its term is multiplied by 0
    ll = logp.gather(-1, labels_s.clamp(min=0)[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    # z-loss keeps the softmax normalizer tame (standard at scale).
    zl = 1e-4 * ((torch.logsumexp(logits_s, dim=-1) ** 2) * mask).sum() / denom
    loss = ce + zl + 0.01 * aux
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux}


# ---------------------------------------------------------------------------
# decode path (serving)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Cache state for serving: one ring KV cache per layer of size
    min(max_len, swa_window or max_len), and each lane's next position."""
    _check_ported(cfg)
    dev = resolve_device(device)
    size = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    kv = [L.init_kv_cache(batch, size, cfg.n_kv_heads, cfg.hd, _dtype(cfg), dev)
          for _ in range(cfg.n_layers)]
    return {"kv": kv, "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def step_with_cache(params, batch, state, cfg: ModelConfig, *,
                    q_chunk: int = 1024, k_chunk: int = 1024):
    """Run T tokens (T=1 decode, T>1 prefill) against the cache state; the
    caches in ``state`` are written in place."""
    _check_ported(cfg)
    x = _embed(params, batch, cfg)
    b, t, _ = x.shape
    pos0 = state["pos"]  # int32[B] — lanes advance independently
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    new_state: dict[str, Any] = dict(state)
    new_state["pos"] = pos0 + t
    new_kv = []
    for p, cache in zip(params["layers"], state["kv"]):
        x, nc, _ = _attn_block(p, x, cfg, positions, cache, q_chunk, k_chunk, flash=True)
        new_kv.append(nc)
    new_state["kv"] = new_kv
    logits = _head_logits(params, x[:, -1:, :], cfg)
    return logits[:, 0], new_state


def prefill(params, batch, state, cfg: ModelConfig, **kw):
    return step_with_cache(params, batch, state, cfg, **kw)


def decode_step(params, tokens, state, cfg: ModelConfig, **kw):
    """tokens: int[B] -> (logits [B, V], new_state)."""
    return step_with_cache(params, {"tokens": tokens[:, None]}, state, cfg, **kw)
