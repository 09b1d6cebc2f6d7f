"""Mamba2 (SSD) block for zamba2-2.7b: a chunked state-space recurrence.

Port of the JAX package's ``repro/models/mamba2.py``. Within a chunk of
length L the output is an (L x L) decay-masked product; across chunks a
state h ``[B, H, N, P]`` is carried:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D x_t

with a per-head scalar A < 0, B_t/C_t in R^N (one group), x_t in R^{H x P}.
A depthwise causal conv (kernel 4) precedes the SSM; z-gating and an RMSNorm
follow it.

The reference scans the chunks one by one. Here every term that does not
read the carried state (the L x L products, each chunk's contribution to
the state) is computed for all chunks at once, and only the recurrence
``h <- h * exp(cum_last) + S_c`` and the carried state's read run per chunk:
the same products on the same operands, in fewer launches. A sequence of T
tokens runs in chunks of ``min(chunk, T)`` (the reference pads a decode
token to a whole chunk; its padded rows add exact zeros).

Under tensor parallelism (``distributed.tp``) the block runs whole on every
rank: ``w_in`` and ``w_out`` are gathered over "model" (``tp.whole``). The
reference splits ``w_in`` on its output dim, where z, x, B, C and dt lie
side by side, so no rank's slice is a block of its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import tp
from repro_torch.models.layers import dense_init, rms_norm

F32 = torch.float32


def mamba2_init(generator: torch.Generator, cfg, dtype, device="cuda"):
    """``a_log``, ``d_skip`` and ``dt_bias`` are float32 whatever ``dtype``
    is, as the reference draws them."""
    dev = resolve_device(device)
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ck = cfg.conv_kernel
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    init = lambda shape, scale=1.0: dense_init(generator, shape, scale, dtype, dev)
    return {
        "w_in": init((d, 2 * di + 2 * n + h)),  # z, x, B, C, dt
        "conv_w": init((ck, di + 2 * n), ck ** 0.5),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=dev),
        "a_log": torch.zeros((h,), dtype=F32, device=dev),       # A = -exp(a_log)
        "d_skip": torch.ones((h,), dtype=F32, device=dev),
        "dt_bias": torch.full((h,), -2.0, dtype=F32, device=dev),  # softplus ~ 0.12
        "ssm_norm": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": init((di, d), out_scale),
    }


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc, conv_w, conv_b, state=None):
    """Depthwise causal conv. xbc: [B, T, C]; state: [B, K-1, C] carry.

    Returns (out [B, T, C], new_state [B, K-1, C]).
    """
    k = conv_w.shape[0]
    b, t, c = xbc.shape
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)  # [B, T+K-1, C]
    out = torch.zeros((b, t, c), dtype=F32, device=xbc.device)
    for i in range(k):
        out = out + full[:, i:i + t, :].to(F32) * conv_w[i].to(F32)
    out = F.silu(out + conv_b.to(F32)).to(xbc.dtype)
    return out, full[:, t:, :]


def _ssd_chunks(h0, xdt, bmat, cmat, log_a):
    """The SSD recurrence over chunks. h0: [B, H, N, P]; xdt: [B, C, L, H, P];
    bmat, cmat: [B, C, L, N]; log_a: [B, C, L, H]. Returns (h_final,
    y [B, C, L, H, P])."""
    cum = torch.cumsum(log_a, dim=2)  # [B, C, L, H]
    # Intra-chunk: decay-masked (L x L) attention-like product. The upper
    # triangle is masked before the exp, where the reference zeroes it after:
    # the same values, but its exponents (a sum of dt over up to a chunk)
    # pass float32's range at published width, and exp's inf times the
    # mask's zero gradient is NaN.
    scores = torch.einsum("bcin,bcjn->bcij", cmat, bmat)  # [B, C, L, L]
    li = torch.arange(xdt.shape[2], device=xdt.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, C, L, L, H]
    decay = torch.exp(torch.where(causal, diff, torch.full_like(diff, float("-inf"))))
    w = scores[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)
    # each chunk's own contribution to the state it hands on
    suffix = torch.exp(cum[:, :, -1:, :] - cum)  # [B, C, L, H]
    contrib = torch.einsum("bcjn,bcjhp->bchnp", bmat, xdt * suffix[..., None])
    chunk_decay = torch.exp(cum[:, :, -1])  # [B, C, H]
    h, carried = h0, []
    for c in range(xdt.shape[1]):
        carried.append(h)
        h = h * chunk_decay[:, c, :, None, None] + contrib[:, c]
    # Inter-chunk: the contribution of the state carried into each chunk.
    y_inter = torch.einsum("bcin,bchnp->bcihp", cmat, torch.stack(carried, dim=1))
    return h, y_intra + y_inter * torch.exp(cum)[..., None]


def mamba2_block(params, x, cfg, *, state=None, chunk: int = 128):
    """x: [B, T, d]. state: dict(h [B,H,N,P] f32, conv [B,K-1,C]) or None.

    Returns (out [B, T, d], new_state). Under ``seqpar``
    (``distributed.tp``) ``x`` and ``out`` are the rank's part of the
    tokens: the scan runs over them gathered.
    """
    par = tp.current()
    if par is not None:
        x = par.full(x)
    b, t, d = x.shape
    di, n, h_heads, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ tp.whole(params["w_in"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + n].to(F32)
    cmat = xbc[..., di + n:].to(F32)
    # F.softplus is x past 20, where jax.nn.softplus (logaddexp(x, 0)) is
    # x + log1p(exp(-x)): the same float32 value there
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])  # [B, T, H]
    a = -torch.exp(params["a_log"])  # [H]
    log_a = dt * a  # [B, T, H]
    xh = xs.reshape(b, t, h_heads, p).to(F32)
    xdt = xh * dt[..., None]

    if state is None:
        h0 = torch.zeros((b, h_heads, n, p), dtype=F32, device=x.device)
    else:
        h0 = state["h"].to(F32)
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:  # zero rows: no input, no decay
        xdt, bmat, cmat, log_a = (F.pad(a_, (0, 0) * (a_.ndim - 2) + (0, pad))
                                  for a_ in (xdt, bmat, cmat, log_a))
    to_chunks = lambda a_: a_.reshape((b, n_chunks, chunk) + a_.shape[2:])
    h_final, ys = _ssd_chunks(h0, to_chunks(xdt), to_chunks(bmat), to_chunks(cmat),
                              to_chunks(log_a))
    y = ys.reshape(b, n_chunks * chunk, h_heads, p)[:, :t]
    y = y + xh * params["d_skip"][None, None, :, None]
    y = y.reshape(b, t, di).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["ssm_norm"], cfg.norm_eps)
    out = y @ tp.whole(params["w_out"])
    if par is not None:
        out = par.part(out)
    return out, {"h": h_final.to(F32), "conv": new_conv}
