"""RWKV-6 "Finch" block for rwkv6-7b: attention-free time-mix with a
data-dependent decay, and channel-mix.

Port of the JAX package's ``repro/models/rwkv6.py``. Per head (head_dim P),
a state S in R^{P x P}:

    w_t = exp(-exp(w0 + lora_w(x~_t)))          (data-dependent decay)
    o_t = r_t . (S_{t-1} + (u (x) 1) * k_t^T v_t)
    S_t = S_{t-1} * diag(w_t) + k_t^T v_t

``chunk_size`` 1 runs the exact per-token scan (a Python loop over the
tokens, as the reference's ``lax.scan``); ``chunk_size > 1`` the chunked
WKV (exp-rescaled products per chunk), which matches the scan to float32
tolerance.

Under tensor parallelism (``distributed.tp``) the channel-mix is column-
then row-parallel on ``d_ff`` (``ck``, ``cv``); the time-mix runs whole on
every rank, its ``wr``/``wk``/``wv``/``wg``/``wo`` gathered over "model"
(``tp.whole``): the reference splits ``wo`` on its output dim, which no
local product of the rank's heads can use, and the ``ln_x`` norm spans
every head. Under ``seqpar`` both mixes take the rank's part of the
tokens, gather them (the token shift and the WKV state cross the split)
and keep the rank's part of their output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import tp
from repro_torch.models.layers import dense_init, rms_norm

F32 = torch.float32
LORA = 64


def rwkv6_init(generator: torch.Generator, cfg, dtype, device="cuda"):
    """``mu``, ``w0``, ``w_lora_a``, ``w_lora_b``, ``bonus_u`` and ``mu_c``
    are float32 whatever ``dtype`` is, as the reference draws them."""
    dev = resolve_device(device)
    d, ff = cfg.d_model, cfg.d_ff
    h, p = cfg.rwkv_heads, cfg.ssm_head_dim
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    init = lambda shape, scale=1.0, dt=dtype: dense_init(generator, shape, scale, dt, dev)
    return {
        # time-mix
        "mu": torch.full((5, d), 0.5, dtype=F32, device=dev),  # token-shift lerp r,k,v,g,w
        "wr": init((d, d)),
        "wk": init((d, d)),
        "wv": init((d, d)),
        "wg": init((d, d)),
        "w0": torch.full((d,), -6.0, dtype=F32, device=dev),
        "w_lora_a": init((d, LORA), dt=F32),
        "w_lora_b": init((LORA, d), dt=F32),
        "bonus_u": torch.zeros((h, p), dtype=F32, device=dev),
        "ln_x": torch.ones((d,), dtype=dtype, device=dev),
        "wo": init((d, d), out_scale),
        # channel-mix
        "mu_c": torch.full((2, d), 0.5, dtype=F32, device=dev),
        "ck": init((d, ff)),
        "cv": init((ff, d), out_scale),
        "cr": init((d, d)),
    }


def _token_shift(x, prev):
    """x: [B, T, d]; prev: [B, d] (last token of the previous segment)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    """x + mu (xs - x), the difference taken in float32 and the step cast
    back to x's dtype before the add, as the reference does."""
    return x + (mu * (xs.to(F32) - x.to(F32))).to(x.dtype)


def rwkv6_time_mix(params, x, cfg, *, state=None, chunk_size: int = 1):
    """x: [B, T, d]. state: dict(shift [B,d], wkv [B,H,P,P]) or None."""
    par = tp.current()
    if par is not None:
        x = par.full(x)
    b, t, d = x.shape
    h, p = cfg.rwkv_heads, cfg.ssm_head_dim
    if state is None:
        prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    else:
        prev = state["shift"].to(x.dtype)
    xs = _token_shift(x, prev)
    mu = params["mu"]
    xr, xk, xv, xg, xw = (_lerp(x, xs, mu[i]) for i in range(5))
    r = (xr @ tp.whole(params["wr"])).reshape(b, t, h, p).to(F32)
    k = (xk @ tp.whole(params["wk"])).reshape(b, t, h, p).to(F32)
    v = (xv @ tp.whole(params["wv"])).reshape(b, t, h, p).to(F32)
    g = xg @ tp.whole(params["wg"])
    lora = torch.tanh(xw.to(F32) @ params["w_lora_a"]) @ params["w_lora_b"]
    w = torch.exp(-torch.exp(params["w0"] + lora))  # [B, T, d] in (0, 1)
    w = w.reshape(b, t, h, p)

    s0 = None if state is None else state["wkv"]
    if s0 is None:
        s0 = torch.zeros((b, h, p, p), dtype=F32, device=x.device)
    if chunk_size > 1:
        o, s_fin = _wkv_chunked_carry(r, k, v, w, params["bonus_u"], chunk_size, s0.to(F32))
    else:
        o, s_fin = _wkv_scan_with_state(r, k, v, w, params["bonus_u"], s0)

    o = o.reshape(b, t, d).to(x.dtype)
    o = rms_norm(o, params["ln_x"], cfg.norm_eps)
    o = (o * F.silu(g)) @ tp.whole(params["wo"])
    if par is not None:
        o = par.part(o)
    return o, {"shift": x[:, -1, :].to(F32), "wkv": s_fin}


def _wkv_scan_with_state(r, k, v, w, u, s0):
    """The exact recurrence, one token at a time. r, k, v, w: [B, T, H, P];
    u: [H, P]; s0: [B, H, P, P]."""
    s = s0.to(F32)
    uu = u[None, :, :, None]
    os = []
    for i in range(r.shape[1]):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        os.append(torch.einsum("bhp,bhpq->bhq", r[:, i], s + uu * kv))
        s = s * w[:, i, :, :, None] + kv
    return torch.stack(os, dim=1), s


def _wkv_chunked_carry(r, k, v, w, u, chunk, s0):
    """Chunked WKV: per chunk, products of exp-rescaled r and k (the
    running log-decay ``cum`` taken from its in-chunk maximum) for the
    strictly-lower part, the bonus term on the diagonal, and the carried
    state's read and update."""
    b, t, h, p = r.shape
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    logw = torch.log(torch.clamp(w, min=1e-30))
    li = torch.arange(chunk, device=r.device)
    strict = (li[:, None] > li[None, :]).to(F32)
    s, os = s0, []
    for c0 in range(0, n_chunks * chunk, chunk):
        rt, kt, vt, lw = (a[:, c0:c0 + chunk] for a in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=1)
        cum_im1 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
        m = torch.amax(cum, dim=1, keepdim=True)
        r_t = rt * torch.exp(cum_im1 - m)
        k_t = kt * torch.exp(m - cum)
        scores = torch.einsum("bihp,bjhp->bhij", r_t, k_t)
        scores = scores * strict[None, None]
        o_intra = torch.einsum("bhij,bjhq->bihq", scores, vt)
        diag = torch.einsum("bihp,bihp->bih", rt, u[None, None] * kt)
        o_intra = o_intra + diag[..., None] * vt
        o_inter = torch.einsum("bihp,bhpq->bihq", rt * torch.exp(cum_im1), s)
        suffix = torch.exp(cum[:, -1:] - cum)
        s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bjhp,bjhq->bhpq", kt * suffix, vt)
        os.append(o_intra + o_inter)
    o = torch.cat(os, dim=1)[:, :t]
    return o, s


def rwkv6_channel_mix(params, x, cfg, *, state=None):
    """Channel-mix (relu^2 FFN with token shift). state: [B, d] prev token."""
    par = tp.current()
    if par is not None:
        x = par.full(x)
    b, t, d = x.shape
    if state is None:
        prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    else:
        prev = state.to(x.dtype)
    xs = _token_shift(x, prev)
    mu = params["mu_c"]
    xk = _lerp(x, xs, mu[0])
    xr = _lerp(x, xs, mu[1])
    if par is not None and par.kind(params["ck"]) is not None:
        kk = torch.square(torch.relu(par.enter(params["ck"], xk) @ params["ck"]))
        kv = par.exit(params["ck"], kk @ params["cv"])
    else:
        kk = torch.square(torch.relu(xk @ params["ck"]))
        kv = kk @ params["cv"] if par is None else par.part(kk @ params["cv"])
    if par is not None:
        xr = par.part(xr)
    out = torch.sigmoid(xr @ params["cr"]) * kv
    return out, x[:, -1, :].to(F32)
