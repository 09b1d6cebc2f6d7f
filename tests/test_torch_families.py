"""The port's vlm, audio, hybrid and ssm families (Llama-3.2-Vision, HuBERT,
Zamba2, RWKV6) on the CPU against the JAX package's, from the same numpy
inputs and the same weights (carried across by ``params_from_numpy``):
cross-attention, the Mamba2 and RWKV6 blocks, the forward, the loss and its
gradients, prefill then decode, and the float32 leaves of bf16 models."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.models import rwkv6 as JR6
from repro_torch import configs as t_configs
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TR6
from repro_torch.tree import leaves, tree_map
from torch_helpers import to_np

FAMILIES = ["llama_3_2_vision_90b", "hubert_xlarge", "zamba2_2_7b", "rwkv6_7b"]
DECODERS = ["llama_3_2_vision_90b", "zamba2_2_7b", "rwkv6_7b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), cfg))


def _as_jax(tree):
    """The port's tree in the reference's layout: each list stacked on a
    leading dim (numpy float32)."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return jax.tree.map(lambda *xs: np.stack(xs), *[_as_jax(v) for v in tree])
    return tree.detach().float().numpy()


def _assert_tree_close(got, want, **tol):
    gl, gd = jax.tree.flatten(got)
    wl, wd = jax.tree.flatten(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **tol)


def _batch(cfg, b=2, t=16, seed=0):
    """tests/test_models.py's batch: frame embeddings for audio, tokens
    otherwise, vision embeddings for the vlm; numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "audio":
        batch["embeds"] = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    else:
        toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
        batch["tokens"], batch["labels"] = toks, toks.copy()
        batch["labels"][-1, 3:6] = -1  # masked rows
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# -- cross-attention -------------------------------------------------------------

def test_cross_attention_block_equals_jax():
    cfg = j_configs.get_smoke_config("llama_3_2_vision_90b")
    jp = jax.tree.map(np.asarray, JL.attn_init(jax.random.PRNGKey(1), cfg, jnp.float32,
                                               cross=True))
    assert set(jp) == {"wq", "wk", "wv", "wo", "kv_norm"}
    rng = np.random.default_rng(1)
    jp["kv_norm"] = rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    vision = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32) * 3.0
    want = JL.cross_attention_block(jp, x, vision, cfg, q_chunk=4, k_chunk=8)
    got = TL.cross_attention_block({k: _t(v) for k, v in jp.items()}, _t(x), _t(vision), cfg,
                                   q_chunk=4, k_chunk=8)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- Mamba2 ----------------------------------------------------------------------

def _mamba_case(seed=2, t=29):
    cfg = j_configs.get_smoke_config("zamba2_2_7b")
    jp = jax.tree.map(np.asarray, JM2.mamba2_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    # non-trivial A, D and dt bias (the init's are constants)
    jp["a_log"] = rng.uniform(-1.0, 1.0, jp["a_log"].shape).astype(np.float32)
    jp["d_skip"] = rng.uniform(0.5, 1.5, jp["d_skip"].shape).astype(np.float32)
    jp["dt_bias"] = rng.uniform(-3.0, 0.0, jp["dt_bias"].shape).astype(np.float32)
    x = (rng.normal(size=(2, t, cfg.d_model)) * 0.1).astype(np.float32)
    return cfg, jp, {k: _t(v) for k, v in jp.items()}, x


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [128, 4])
def test_mamba2_block_equals_jax(with_state, chunk):
    cfg, jp, tp, x = _mamba_case()
    js = ts = None
    if with_state:
        rng = np.random.default_rng(3)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        h = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)) * 0.1
        conv = rng.normal(size=(2, cfg.conv_kernel - 1, conv_dim)) * 0.1
        js = {"h": h.astype(np.float32), "conv": conv.astype(np.float32)}
        ts = {k: _t(v) for k, v in js.items()}
    jy, jst = JM2.mamba2_block(jp, x, cfg, state=js, chunk=chunk)
    ty, tst = TM2.mamba2_block(tp, _t(x), cfg, state=ts, chunk=chunk)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(to_np(tst[k]), np.asarray(jst[k]), rtol=1e-5, atol=1e-5)
    assert tst["h"].dtype == torch.float32


def test_mamba2_chunk_invariance_and_recurrence():
    """tests/test_models.py's check through the port: chunk 29 == chunk 4,
    and both == the per-token recurrence (29 one-token calls), atol 1e-5."""
    cfg, _, tp, x = _mamba_case()
    y1, s1 = TM2.mamba2_block(tp, _t(x), cfg, chunk=29)
    y2, s2 = TM2.mamba2_block(tp, _t(x), cfg, chunk=4)
    np.testing.assert_allclose(to_np(y1), to_np(y2), atol=1e-5)
    np.testing.assert_allclose(to_np(s1["h"]), to_np(s2["h"]), atol=1e-5)
    state, ys = None, []
    for i in range(29):
        y, state = TM2.mamba2_block(tp, _t(x[:, i:i + 1]), cfg, state=state, chunk=1)
        ys.append(y)
    np.testing.assert_allclose(to_np(y1), to_np(torch.cat(ys, 1)), atol=1e-5)
    np.testing.assert_allclose(to_np(s1["h"]), to_np(state["h"]), atol=1e-5)


def test_mamba2_decay_is_zero_above_the_diagonal():
    """A strongly decaying head (dt ~ 20, A = -e), its upper triangle
    masked to zero (its exponent to -inf before the exp; the reference
    zeroes exp's value after it): the block stays finite and equals the
    reference (a mask to exp(0) = 1 would leave ones there; exp(+large)
    unmasked would overflow)."""
    cfg, jp, tp, x = _mamba_case()
    tp["dt_bias"] = torch.full_like(tp["dt_bias"], 20.0)
    tp["a_log"] = torch.ones_like(tp["a_log"])
    jp = dict(jp, dt_bias=np.full_like(jp["dt_bias"], 20.0), a_log=np.ones_like(jp["a_log"]))
    ty, _ = TM2.mamba2_block(tp, _t(x), cfg, chunk=16)
    jy, _ = JM2.mamba2_block(jp, x, cfg, chunk=16)
    assert bool(torch.isfinite(ty).all())
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)


# -- RWKV6 -------------------------------------------------------------------------

def _rwkv_case(seed=4, t=21):
    cfg = j_configs.get_smoke_config("rwkv6_7b")
    jp = jax.tree.map(np.asarray, JR6.rwkv6_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    jp["mu"] = rng.uniform(0.0, 1.0, jp["mu"].shape).astype(np.float32)
    jp["mu_c"] = rng.uniform(0.0, 1.0, jp["mu_c"].shape).astype(np.float32)
    jp["w0"] = rng.uniform(-3.0, 0.5, jp["w0"].shape).astype(np.float32)  # fast decays too
    jp["bonus_u"] = rng.normal(size=jp["bonus_u"].shape).astype(np.float32)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    return cfg, jp, {k: _t(v) for k, v in jp.items()}, x


def _rwkv_state(cfg, seed=5):
    rng = np.random.default_rng(seed)
    h, p = cfg.rwkv_heads, cfg.ssm_head_dim
    return {"shift": rng.normal(size=(2, cfg.d_model)).astype(np.float32),
            "wkv": (rng.normal(size=(2, h, p, p)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk_size", [1, 8])
def test_rwkv6_time_mix_equals_jax(chunk_size, with_state):
    cfg, jp, tp, x = _rwkv_case()
    js = _rwkv_state(cfg) if with_state else None
    ts = {k: _t(v) for k, v in js.items()} if with_state else None
    jo, jst = JR6.rwkv6_time_mix(jp, x, cfg, state=js, chunk_size=chunk_size)
    to, tst = TR6.rwkv6_time_mix(tp, _t(x), cfg, state=ts, chunk_size=chunk_size)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tst["wkv"]), np.asarray(jst["wkv"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to_np(tst["shift"]), np.asarray(jst["shift"]))


def test_rwkv6_chunked_time_mix_equals_the_scan():
    cfg, _, tp, x = _rwkv_case()
    ts = {k: _t(v) for k, v in _rwkv_state(cfg).items()}
    o1, s1 = TR6.rwkv6_time_mix(tp, _t(x), cfg, state=ts, chunk_size=1)
    for chunk in (4, 8, 32):
        o2, s2 = TR6.rwkv6_time_mix(tp, _t(x), cfg, state=ts, chunk_size=chunk)
        np.testing.assert_allclose(to_np(o2), to_np(o1), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(s2["wkv"]), to_np(s1["wkv"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_equals_jax(with_state):
    cfg, jp, tp, x = _rwkv_case()
    js = _rwkv_state(cfg)["shift"] if with_state else None
    jo, jst = JR6.rwkv6_channel_mix(jp, x, cfg, state=js)
    to, tst = TR6.rwkv6_channel_mix(tp, _t(x), cfg, state=None if js is None else _t(js))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to_np(tst), np.asarray(jst))


# -- the models ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_equal_jax(arch):
    cfg = j_configs.get_smoke_config(arch)
    tree = _jax_tree(cfg)
    jb, tb = _both(_batch(cfg))
    want, _ = JM.forward(tree, jb, cfg, remat=False, q_chunk=8, k_chunk=8)
    got, aux = TM.forward(TM.params_from_numpy(tree, cfg, "cpu"), tb, cfg, remat=False,
                          q_chunk=8, k_chunk=8)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_every_gradient_equal_jax(arch, remat):
    cfg = j_configs.get_smoke_config(arch)
    tree = _jax_tree(cfg)
    jb, tb = _both(_batch(cfg))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(p, jb, cfg, remat=False, q_chunk=8, k_chunk=8),
        has_aux=True)(tree)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, met = TM.train_loss(params, tb, cfg, remat=remat, q_chunk=8, k_chunk=8)
    # the audio family reads frame embeddings: its token table gets no
    # gradient (the reference's is zero)
    grads = iter(torch.autograd.grad(loss, ps, allow_unused=True))
    tg = tree_map(lambda p, stacked: (lambda g: torch.zeros_like(p) if g is None else g)(
        next(grads)), params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(met[k].detach()), float(jm[k]), **TOL)
    _assert_tree_close(_as_jax(tg), jax.tree.map(np.asarray, jg), **TOL)
    assert sum(float(g.abs().sum()) for g in leaves(tg)) > 0


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_logits_equal_jax(arch):
    """tests/test_models.py's decode consistency through both packages: a
    prefill of 11 tokens (the vlm with its vision tokens), then 4 decode
    steps; every step's logits equal the reference's at 2e-4, and the last
    the port's own full forward."""
    cfg = j_configs.get_smoke_config(arch)
    tree = _jax_tree(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    b, t = 2, 11
    batch = _batch(cfg, b, t + 4, seed=7)
    pre = {k: (v[:, :t] if k == "tokens" else v) for k, v in batch.items() if k != "labels"}
    jpre, tpre = _both(pre)
    js = JM.init_decode_state(cfg, b, max_len=32)
    ts = TM.init_decode_state(cfg, b, max_len=32, device="cpu")
    jl, js = JM.prefill(tree, jpre, js, cfg, q_chunk=8, k_chunk=8)
    tl, ts = TM.prefill(params, tpre, ts, cfg, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    for i in range(t, t + 4):
        jl, js = JM.decode_step(tree, jnp.asarray(batch["tokens"][:, i]), js, cfg)
        tl, ts = TM.decode_step(params, _t(batch["tokens"][:, i]), ts, cfg)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(to_np(ts["pos"]), np.asarray(js["pos"]))
    full, _ = TM.forward(params, {k: _t(v) for k, v in batch.items()}, cfg, remat=False,
                         q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(to_np(tl), to_np(full[:, -1]), **TOL)


def test_ssm_decode_state_equals_jax():
    """RWKV6's per-layer float32 state after a prefill and a decode step
    equals the reference's stacked state."""
    cfg = j_configs.get_smoke_config("rwkv6_7b")
    tree = _jax_tree(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    js = JM.init_decode_state(cfg, 2, max_len=16)
    ts = TM.init_decode_state(cfg, 2, max_len=16, device="cpu")
    _, js = JM.prefill(tree, {"tokens": jnp.asarray(toks[:, :8])}, js, cfg)
    _, ts = TM.prefill(params, {"tokens": _t(toks[:, :8])}, ts, cfg)
    _, js = JM.decode_step(tree, jnp.asarray(toks[:, 8]), js, cfg)
    _, ts = TM.decode_step(params, _t(toks[:, 8]), ts, cfg)
    for k in ("wkv", "tshift", "cshift"):
        assert len(ts[k]) == cfg.n_layers and ts[k][0].dtype == torch.float32
        np.testing.assert_allclose(np.stack([to_np(s) for s in ts[k]]), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-5)


def test_hybrid_decode_state_equals_jax():
    """Zamba2's state: one KV cache per shared-block application, an f32
    ``h`` and a model-dtype conv carry per Mamba2 block."""
    cfg = j_configs.get_smoke_config("zamba2_2_7b")
    tree = _jax_tree(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    js = JM.init_decode_state(cfg, 2, max_len=16)
    ts = TM.init_decode_state(cfg, 2, max_len=16, device="cpu")
    _, js = JM.prefill(tree, {"tokens": jnp.asarray(toks)}, js, cfg)
    _, ts = TM.prefill(params, {"tokens": _t(toks)}, ts, cfg)
    g = cfg.n_layers // cfg.attn_every
    assert len(ts["kv"]) == g and [len(s) for s in ts["ssm"]] == [cfg.attn_every] * g
    got = _as_jax(ts["ssm"])
    for k in ("h", "conv"):
        np.testing.assert_allclose(got[k], np.asarray(js["ssm"][k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.stack([to_np(c.pos) for c in ts["kv"]]),
                                  np.asarray(js["kv"].pos))


@pytest.mark.parametrize("rwkv_chunk", [1, 8])
def test_rwkv_chunk_reaches_prefill(rwkv_chunk):
    """``rwkv_chunk`` of the cached path, as in the reference: a 20-token
    prefill at chunk 1 and 8 equals the reference's at the same chunk."""
    cfg = j_configs.get_smoke_config("rwkv6_7b")
    tree = _jax_tree(cfg)
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    jl, _ = JM.prefill(tree, {"tokens": jnp.asarray(toks)}, JM.init_decode_state(cfg, 2, 32),
                       cfg, rwkv_chunk=rwkv_chunk)
    tl, _ = TM.prefill(TM.params_from_numpy(tree, cfg, "cpu"), {"tokens": _t(toks)},
                       TM.init_decode_state(cfg, 2, 32, device="cpu"), cfg,
                       rwkv_chunk=rwkv_chunk)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)


def test_rwkv_chunked_forward_equals_the_scan():
    """tests/test_models.py's chunked-vs-scan check: T = 33 at chunk 8
    (a ragged last chunk) against chunk 1, at 1e-3."""
    cfg = j_configs.get_smoke_config("rwkv6_7b")
    params = TM.params_from_numpy(_jax_tree(cfg), cfg, "cpu")
    tb = {k: _t(v) for k, v in _batch(cfg, 2, 33).items()}
    l1, _ = TM.forward(params, tb, cfg, remat=False, rwkv_chunk=1)
    l2, _ = TM.forward(params, tb, cfg, remat=False, rwkv_chunk=8)
    np.testing.assert_allclose(to_np(l1), to_np(l2), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch,per_prefill", [("llama_3_2_vision_90b", 2),
                                              ("zamba2_2_7b", 2), ("rwkv6_7b", 0)])
def test_prefill_asks_for_flash_once_per_attention_layer(monkeypatch, arch, per_prefill):
    """The vlm's self layers (2 at 4 layers, cross every 2nd) and each of
    the hybrid's shared-block applications (4 / 2) ask for flash_attention
    at a prefill, cross-attention and RWKV6 never; a decode step never."""
    from repro_torch.kernels import flash_attention as fa

    cfg = j_configs.get_smoke_config(arch)
    params = TM.params_from_numpy(_jax_tree(cfg), cfg, "cpu")
    calls = []
    orig = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, **kw: calls.append(q.shape) or orig(q, k, v, **kw))
    batch = _batch(cfg, 1, 9)
    pre = {k: _t(v) for k, v in batch.items() if k != "labels"}
    state = TM.init_decode_state(cfg, 1, 16, device="cpu")
    _, state = TM.prefill(params, pre, state, cfg)
    assert len(calls) == per_prefill
    assert all(s == (1, 9, cfg.n_heads, cfg.hd) for s in calls)
    TM.decode_step(params, _t(batch["tokens"][:, 0]), state, cfg)
    assert len(calls) == per_prefill


def test_vlm_decode_reuses_the_stored_vision():
    """The vision tokens are stored at the prefill (``vision`` is None
    before) and reused by the decode steps; a first step without them
    raises."""
    cfg = t_configs.get_smoke_config("llama_3_2_vision_90b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TM.init_decode_state(cfg, 1, 16, device="cpu")
    assert state["vision"] is None
    with pytest.raises(ValueError, match="vision_embeds"):
        TM.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, state, cfg)
    vision = torch.randn(1, cfg.n_vision_tokens, cfg.d_model)
    _, state = TM.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                                   "vision_embeds": vision}, state, cfg)
    assert torch.equal(state["vision"], vision)
    _, state2 = TM.decode_step(params, torch.zeros(1, dtype=torch.int32), state, cfg)
    assert state2["vision"] is state["vision"]


def test_audio_has_no_decode_path():
    cfg = t_configs.get_smoke_config("hubert_xlarge")
    with pytest.raises(ValueError, match="family audio has no decode path"):
        TM.init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="family audio has no decode path"):
        JM.init_decode_state(cfg, 1, 8)


def test_tree_map_and_to_device_pass_none():
    cfg = t_configs.get_smoke_config("llama_3_2_vision_90b")
    state = TM.init_decode_state(cfg, 2, 8, device="cpu")
    moved = TM.to_device(state, "cpu")
    assert moved["vision"] is None and len(moved["kv"]) == 2
    n = []
    TM.tree_map(lambda t: n.append(t), state)
    assert len(n) == 1 + 2 * (cfg.cross_attn_every - 1) * 4  # pos, then k, v, pos, length


# -- weights carried across ---------------------------------------------------------

F32_LEAVES = {"rwkv6_7b": ("mu", "w0", "w_lora_a", "w_lora_b", "bonus_u", "mu_c"),
              "zamba2_2_7b": ("a_log", "d_skip", "dt_bias")}


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2_7b"])
def test_params_from_numpy_keeps_f32_leaves_of_a_bf16_tree(arch):
    """A bf16 tree: the leaves the reference draws in float32 stay float32,
    bit for bit, and the rest carry their bf16 bits."""
    cfg = j_configs.get_smoke_config(arch).with_(dtype="bfloat16")
    tree = _jax_tree(cfg, seed=3)
    if arch == "rwkv6_7b":
        jblock, path, idx = tree["layers"]["rwkv"], ("layers", 2, "rwkv"), (2,)
        name = "w0"
    else:
        jblock, path, idx = tree["groups"]["mamba"]["mamba"], ("groups", 1, "mamba", 1,
                                                               "mamba"), (1, 1)
        name = "dt_bias"
    # a constant at init: offsets that bf16 would round make the bits tell
    jblock[name] = jblock[name] + np.float32(1e-3) * np.arange(
        jblock[name].size, dtype=np.float32).reshape(jblock[name].shape)
    tblock = TM.params_from_numpy(tree, cfg, "cpu")
    for k in path:
        tblock = tblock[k]
    for name, leaf in jblock.items():
        want, got = np.asarray(leaf)[idx], tblock[name]
        if name in F32_LEAVES[arch]:
            assert want.dtype == np.float32 and got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert want.dtype.name == "bfloat16" and got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def _layout(tree):
    """(shape, dtype name) per leaf, a list stacked on a leading dim."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        def stack(xs):
            if isinstance(xs[0], dict):
                return {k: stack([x[k] for x in xs]) for k in xs[0]}
            assert len(set(xs)) == 1
            return ((len(xs),) + xs[0][0], xs[0][1])
        return stack([_layout(v) for v in tree])
    if hasattr(tree, "shape") and not isinstance(tree, torch.Tensor):  # ShapeDtypeStruct
        return (tuple(tree.shape), str(tree.dtype))
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_jax_layout_and_dtypes(arch):
    """The port's random parameters of a bf16 model: the reference's tree
    (lists stacked) with its shapes and its dtypes leaf for leaf."""
    cfg = t_configs.get_smoke_config(arch).with_(dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    assert _layout(params) == _layout(want)
