"""Shared layer primitives: norms, RoPE, MLP, GQA attention (+SWA, cross),
KV caches. Port of the JAX package's ``repro/models/layers.py``: functions over
plain dicts of tensors, with the same names, layouts (``x @ W`` with W
``[in, out]``) and arithmetic.

Attention goes through the plain chunked online-softmax ``attention``, as
the JAX package computes it in jnp (training, decode against a ring cache,
SWA), unless the caller asks ``self_attention_block`` for the hand-written
kernel ``kernels.flash_attention`` (``flash=True``: serving's prefill over a
fresh sequence of no more tokens than the sliding window, if any). The
kernel is forward only, so training never asks for it. The port writes KV
caches in place (the JAX package returns new arrays), so a decode step does
not copy the cache; a caller that needs the old cache clones it first.

Under tensor parallelism (a ``distributed.tp.TP`` current: the training
step or the placed serving step on a mesh whose "model" axis has several
ranks) the MLP is column- then row-parallel on ``d_ff``, and attention runs
this rank's q heads (``_project``): whole-head KV slices stay local, KV
split within a head is gathered and the rank takes the heads its q heads
read (a cache then holds every KV head, and each rank reads its own), and
where the q heads do not split evenly the block runs whole on every rank.
Under ``seqpar`` (``TP.seq``: training and serving's prefill) the MLP and
the attention block take the rank's part of the tokens, gather them
(``TP.full``) and end in a reduce-scatter over the tokens (``TP.exit``), or
keep the rank's part of a block run whole (``TP.part``).
A KV cache whose sequence is split over the data ranks (``TP.kv_seq``) is
written by the rank that holds each token's ring slot (``_write_split``),
and a decode step merges the ranks' partial softmaxes (``attention``'s
``merge``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import dp as _dp
from repro_torch.distributed import tp as _tp
from repro_torch.kernels import flash_attention as _flash

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, scale: float = 1.0,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Truncated normal (cut at +-2 standard units) times ``scale/sqrt(fan_in)``,
    drawn in fp32 on ``device`` from ``generator`` (on the same device)."""
    w = torch.empty(shape, dtype=F32, device=resolve_device(device))
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    return w.mul_(scale / (shape[0] ** 0.5)).to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (fractional: chatglm applies rotary to half the head dims)
# ---------------------------------------------------------------------------

def rope_tables(positions, rot_dim: int, theta: float):
    """positions int[...] -> (cos, sin) f32[..., rot_dim/2]."""
    exps = torch.arange(0, rot_dim, 2, dtype=F32, device=positions.device) / rot_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(F32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, *, fraction: float = 1.0, theta: float = 1e4):
    """x: [..., T, H, hd]; positions broadcastable to [..., T]. Rotates the
    interleaved pairs (0::2, 1::2) of the first ``fraction`` of the dims."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    cos, sin = rope_tables(positions, rot, theta)  # [..., T, rot/2]
    cos = cos[..., None, :]  # add head dim
    sin = sin[..., None, :]
    xr = x[..., :rot].to(F32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model: int, d_ff: int, act: str, n_layers: int, dtype,
             device="cuda"):
    out_scale = 1.0 / (2 * n_layers) ** 0.5
    init = lambda shape, scale=1.0: dense_init(generator, shape, scale, dtype, device)
    if act == "swiglu":
        return {
            "w_gate": init((d_model, d_ff)),
            "w_up": init((d_model, d_ff)),
            "w_down": init((d_ff, d_model), out_scale),
        }
    return {
        "w_up": init((d_model, d_ff)),
        "w_down": init((d_ff, d_model), out_scale),
    }


def mlp(params, x, act: str):
    par = _tp.current()
    kind = None if par is None else par.kind(params["w_up"])
    if par is not None:
        x = par.full(x)
    if kind:  # column-parallel in, row-parallel out
        x = par.enter(params["w_up"], x)
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")  # jax.nn.gelu's default
    y = h @ params["w_down"]
    if kind:
        return par.exit(params["w_up"], y)
    return y if par is None else par.part(y)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (the plain path: decode, SWA)
# ---------------------------------------------------------------------------

def _attn_chunk_scan(q, k, v, qpos, kpos, kvalid, *, causal, window, k_chunk, scale,
                     merge=None):
    """Online softmax over k chunks.

    q: [B, Hkv, G, Tq, hd]; k/v: [B, Tk, Hkv, hd]; qpos [B, Tq]; kpos [B, Tk];
    kvalid bool[B, Tk]. Returns [B, Hkv, G, Tq, hd] (f32). ``merge``: a
    process group whose ranks hold the other parts of the keys; their
    partial softmaxes are merged (the max, then the rescaled sums and
    weighted outputs, one ``all_reduce`` each) before the division.
    """
    b, hkv, g, tq, hd = q.shape
    tk = k.shape[1]
    qf = q.to(F32)
    m = torch.full((b, hkv, g, tq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, hkv, g, tq), dtype=F32, device=q.device)
    acc = torch.zeros((b, hkv, g, tq, hd), dtype=F32, device=q.device)
    for c0 in range(0, tk, k_chunk):
        # the last chunk is short instead of padded: padded keys were masked
        kb, vb = k[:, c0:c0 + k_chunk], v[:, c0:c0 + k_chunk]
        pb, vb_mask = kpos[:, c0:c0 + k_chunk], kvalid[:, c0:c0 + k_chunk]
        logits = torch.einsum("bhgqd,bchd->bhgqc", qf, kb.to(F32)) * scale
        mask = vb_mask[:, None, None, None, :]
        if causal:
            ok = pb[:, None, :] <= qpos[:, :, None]  # [B, Tq, C]
            if window is not None:
                ok &= qpos[:, :, None] - pb[:, None, :] < window
            mask = mask & ok[:, None, None, :, :]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqc,bchd->bhgqd", p, vb.to(F32))
        m = m_new
    if merge is not None:
        m_all = _dp.all_reduce(m.clone(), merge, op=torch.distributed.ReduceOp.MAX)
        c = torch.exp(m - m_all)
        sums = _dp.all_reduce(torch.cat([acc * c[..., None], (l * c)[..., None]], dim=-1), merge)
        acc, l = sums[..., :-1], sums[..., -1]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.where(l[..., None] > 0, out, torch.zeros_like(out))


def attention(q, k, v, *, qpos, kpos, kvalid=None, causal: bool = True,
              window: Optional[int] = None, q_chunk: int = 1024, k_chunk: int = 1024,
              merge=None):
    """GQA attention. q: [B, Tq, Hq, hd]; k/v: [B, Tk, Hkv, hd].

    qpos/kpos: int[B, Tq]/[B, Tk] absolute positions (ring caches pass
    per-slot positions; invalid slots masked by kvalid). Returns [B, Tq, Hq, hd].
    ``merge``: the process group over which the keys are split (a
    sequence-split cache); see ``_attn_chunk_scan``.
    """
    b, tq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    if kvalid is None:
        kvalid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    qg = q.permute(0, 2, 1, 3).reshape(b, hkv, g, tq, hd)
    outs = [_attn_chunk_scan(qg[..., s:s + q_chunk, :], k, v, qpos[:, s:s + q_chunk],
                             kpos, kvalid, causal=causal, window=window,
                             k_chunk=k_chunk, scale=scale, merge=merge)
            for s in range(0, tq, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.reshape(b, hq, tq, hd).permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block + KV cache
# ---------------------------------------------------------------------------

def attn_init(generator, cfg, dtype, device="cuda", cross: bool = False):
    """Projections ``wq``/``wk``/``wv``/``wo``; ``cross`` adds ``kv_norm``,
    the RMS-norm scale of the attended (vision) tokens."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    init = lambda shape, scale=1.0: dense_init(generator, shape, scale, dtype, device)
    p = {
        "wq": init((d, hq * hd)),
        "wk": init((d, hkv * hd)),
        "wv": init((d, hkv * hd)),
        "wo": init((hq * hd, d), out_scale),
    }
    if cross:
        p["kv_norm"] = torch.ones((d,), dtype=dtype, device=resolve_device(device))
    return p


@dataclasses.dataclass
class KVCache:
    """Ring-capable KV cache. ``pos[b, s]`` = absolute position in slot s
    (-1 invalid). Full cache: size >= max_len; SWA: size == window."""

    k: torch.Tensor       # [B, S, Hkv, hd]
    v: torch.Tensor       # [B, S, Hkv, hd]
    pos: torch.Tensor     # int32[B, S]
    length: torch.Tensor  # int32 scalar — tokens seen so far


def init_kv_cache(batch, size, n_kv, hd, dtype, device="cuda") -> KVCache:
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, size, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, size, n_kv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, size), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _kv_heads(lo: int, hi: int, group: int) -> list:
    """The KV heads that q heads [lo, hi) read (``group`` q heads a KV
    head), each once where the q heads split evenly over them, else one per
    q head."""
    idx = [h // group for h in range(lo, hi)]
    uniq = sorted(set(idx))
    per = (hi - lo) // len(uniq)
    return uniq if idx == [u for u in uniq for _ in range(per)] else idx


def _project(params, x, src, cfg, all_kv: bool = False):
    """q ``[B, T, H, hd]`` from ``x``, k and v ``[B, Nk, Hk, hd]`` from
    ``src``, the output projection ``o [B, T, H * hd] -> [B, T, d]`` and
    ``sel``, as this rank runs them: every head with no tensor parallelism
    (``sel`` None); under it (``distributed.tp``) the rank's q heads and
    the KV heads they read (``_kv_heads``), the output summed over the
    ranks. ``all_kv`` (a cache that holds every KV head: GQA's KV heads do
    not split over the ranks) gives every KV head, and ``sel`` names the
    ones the rank's q heads read. Where the q heads do not split over the
    ranks, the block runs whole on every rank. Under ``seq`` the block
    takes the stream's tokens whole and its output is the rank's part."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    par = _tp.current()
    if par is not None:
        whole_x = par.full(x)
        src = whole_x if src is x else src
        x = whole_x
    t, nk = x.shape[1], src.shape[1]
    if par is None or par.dim(params["wq"]) is None or hq % par.size:
        w = {n: params[n] if par is None else par.whole(params[n])
             for n in ("wq", "wk", "wv", "wo")}
        q = (x @ w["wq"]).reshape(b, t, hq, hd)
        k = (src @ w["wk"]).reshape(b, nk, hkv, hd)
        v = (src @ w["wv"]).reshape(b, nk, hkv, hd)
        if par is None:
            return q, k, v, lambda o: o @ w["wo"], None
        return q, k, v, lambda o: par.part(o @ w["wo"]), None
    lo, hi = par.span(hq)
    xp = par.to_parallel(x)
    sp = xp if src is x else par.to_parallel(src)
    q = (xp @ params["wq"]).reshape(b, t, hi - lo, hd)
    local = par.dim(params["wk"]) is not None and hkv % par.size == 0  # whole heads
    heads = None if local else _kv_heads(lo, hi, hq // hkv)

    def kv(name):
        w = params[name]
        if local:
            return (sp @ w).reshape(b, nk, hkv // par.size, hd)
        if all_kv:
            return (sp @ par.whole(w)).reshape(b, nk, hkv, hd)
        w = par.gather_to_parallel(w)
        w = torch.cat([w[:, h * hd:(h + 1) * hd] for h in heads], dim=-1)
        return (sp @ w).reshape(b, nk, len(heads), hd)

    sel = heads if all_kv else None
    return q, kv("wk"), kv("wv"), lambda o: par.exit(params["wo"], o @ params["wo"]), sel


def _write_split(cache: "KVCache", k, v, positions, kv_seq) -> None:
    """The tail of ``k``/``v`` ``[B, T, H, hd]`` (``positions`` ``[B, T]``,
    consecutive along each row) written into a ring cache whose slots are
    split over the data ranks ``kv_seq``: this rank holds slots
    ``[rank * n, (rank + 1) * n)`` of the ring's ``n * size``, and writes
    only the tokens that land there (each slot takes at most one of the
    last ``size`` tokens). Dense in the slots: no data-dependent shape."""
    b, n = cache.k.shape[:2]
    size = n * kv_seq.size
    t = k.shape[1]
    keep = min(t, size)
    start = positions[:, t - keep].long()
    slots = kv_seq.rank * n + torch.arange(n, device=k.device)
    off = (slots[None, :] - start[:, None]) % size  # [B, n]: the tail token that lands there
    hit = off < keep
    src = (t - keep) + off.clamp(max=keep - 1)
    idx = src[..., None, None].expand(b, n, *k.shape[2:])
    for dst, new in ((cache.k, k), (cache.v, v)):
        dst.copy_(torch.where(hit[..., None, None], new.gather(1, idx), dst))
    cache.pos.copy_(torch.where(hit, positions.gather(1, src).to(torch.int32), cache.pos))


def self_attention_block(params, x, cfg, *, positions, cache: Optional[KVCache] = None,
                         q_chunk: int = 1024, k_chunk: int = 1024, flash: bool = False):
    """x: [B, T, d]. Returns (out [B, T, d], new_cache); ``cache`` is
    written in place.

    ``flash``: the caller's choice of ``kernels.flash_attention`` (forward
    only, one launch per call that takes it) for T > 1 when there is no
    sliding window or T <= ``cfg.swa_window``. There the keys are the fresh
    sequence (all valid, positions increasing along each row, as
    ``model.step_with_cache`` makes them), and no query-key pair of T
    tokens lies a window apart, so the window masks nothing: exactly the
    kernel's function. A longer prompt, a decode step and ``flash=False``
    run the plain windowed ``attention`` (the kernel has no window, as the
    Pallas kernel has none).
    """
    q, k, v, out, sel = _project(params, x, x, cfg, all_kv=cache is not None)
    b, t = q.shape[:2]
    q = apply_rope(q, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)

    par = _tp.current()
    kv_seq = None if par is None else par.kv_seq
    new_cache = None
    bidx = torch.arange(b, device=x.device)[:, None]
    if cache is None:
        kk, vv = k, v
        kpos, kvalid = positions, None
    elif kv_seq is not None:
        # the cache's sequence split over the data ranks: each writes the
        # tokens that land on its slots; a decode step attends over them
        # and the ranks merge their partial softmaxes
        _write_split(cache, k, v, positions, kv_seq)
        new_cache = dataclasses.replace(cache, length=cache.length + t)
        kk, vv = (k, v) if t > 1 else (cache.k, cache.v)
        kpos, kvalid = (positions, None) if t > 1 else (cache.pos, cache.pos >= 0)
    elif t > 1:
        # Prefill: attend over the fresh sequence (a ring cache smaller than
        # T would otherwise evict keys that early queries still need), then
        # write only the last `size` positions into the cache.
        size = cache.k.shape[1]
        keep = min(t, size)
        tail_pos = positions[:, t - keep:].to(torch.int32)
        slots = (tail_pos % size).long()
        cache.k[bidx, slots] = k[:, t - keep:]
        cache.v[bidx, slots] = v[:, t - keep:]
        cache.pos[bidx, slots] = tail_pos
        new_cache = dataclasses.replace(cache, length=cache.length + t)
        kk, vv = k, v
        kpos, kvalid = positions, None
    else:
        # Decode: single token -> distinct ring slot.
        size = cache.k.shape[1]
        slots = (positions % size).long()  # [B, 1]
        cache.k[bidx, slots] = k
        cache.v[bidx, slots] = v
        cache.pos[bidx, slots] = positions.to(torch.int32)
        new_cache = dataclasses.replace(cache, length=cache.length + t)
        kk, vv = cache.k, cache.v
        kpos, kvalid = cache.pos, cache.pos >= 0
    if sel is not None:  # every KV head cached; the rank's q heads read these
        idx = torch.tensor(sel, device=x.device)
        kk, vv = kk.index_select(2, idx), vv.index_select(2, idx)

    if flash and t > 1 and (cfg.swa_window is None or t <= cfg.swa_window):
        o = _flash.flash_attention(q, kk, vv, causal=cfg.causal)
    else:
        merge = kv_seq.group if kv_seq is not None and cache is not None and t == 1 else None
        o = attention(q, kk, vv, qpos=positions, kpos=kpos, kvalid=kvalid,
                      causal=cfg.causal, window=cfg.swa_window,
                      q_chunk=q_chunk, k_chunk=k_chunk, merge=merge)
    return out(o.flatten(2)), new_cache


def cross_attention_block(params, x, kv_src, cfg, *, q_chunk=1024, k_chunk=1024):
    """Cross-attention to (vision) tokens. kv_src: [B, Nv, d]. No RoPE, no
    mask: the keys are the RMS-normed ``kv_src`` at position 0, attended
    non-causally through the plain ``attention`` (the kernel takes one T for
    queries and keys; here they are T and Nv)."""
    nv = kv_src.shape[1]
    src = rms_norm(kv_src, params["kv_norm"], cfg.norm_eps)
    q, k, v, out, _sel = _project(params, x, src, cfg)
    b, t = q.shape[:2]
    zeros_q = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((b, nv), dtype=torch.int32, device=x.device)
    o = attention(q, k, v, qpos=zeros_q, kpos=zeros_k, causal=False,
                  q_chunk=q_chunk, k_chunk=k_chunk)
    return out(o.flatten(2))
