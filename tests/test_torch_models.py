"""The port's model substrate (configs, layers, dense and moe prefill/decode)
on the CPU against the JAX package's, from the same numpy inputs and the
same weights (carried across by ``params_from_numpy``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as t_configs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_helpers import to_np

DENSE = ["yi_6b", "stablelm_3b", "granite_20b", "chatglm3_6b"]
MOE = ["mixtral_8x22b", "arctic_480b"]


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_configs_equal_the_jax_package(arch):
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(j_configs, get)(arch))
        assert dataclasses.asdict(getattr(t_configs, get)(arch)) == want


def test_port_registers_the_ten_archs_of_the_jax_package():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS and len(t_configs.ARCH_IDS) == 10
    with pytest.raises(ValueError, match="unknown arch"):
        t_configs.get_config("gpt-2")


def test_unknown_family_raises_value_error():
    """A family outside the six raises ``ValueError(family)`` at every
    entry point, as the reference's ``init_params`` does."""
    cfg = j_configs.get_smoke_config("yi_6b").with_(family="conv")
    with pytest.raises(ValueError, match="conv"):
        JM.init_params(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="conv"):
        TM.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="conv"):
        TM.init_decode_state(cfg, 1, 8, "cpu")
    params = TM.init_params(j_configs.get_smoke_config("yi_6b"), torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="conv"):
        TM.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, cfg)
    state = TM.init_decode_state(j_configs.get_smoke_config("yi_6b"), 1, 8, "cpu")
    with pytest.raises(ValueError, match="conv"):
        TM.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, state, cfg)


@pytest.mark.parametrize("arch,reason", [("llama_3_2_vision_90b", "vision_embeds"),
                                         ("hubert_xlarge", "no decode path")])
def test_engine_refuses_vlm_and_audio(arch, reason):
    """The engine takes token prompts: a vlm (whose prefill needs vision
    embeddings) and the audio encoder are refused at construction with the
    reason, where the reference engine fails later (an AttributeError at the
    vlm's first prefill, a ValueError at audio's decode state)."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = t_configs.get_smoke_config(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=reason):
        ServingEngine(cfg, ServeConfig(device="cpu"), params)


# -- layers --------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 2, 5, 32), _rand(rng, 32)
    np.testing.assert_allclose(to_np(TL.rms_norm(_t(x), _t(s))),
                               np.asarray(JL.rms_norm(x, s)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_apply_rope(fraction):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    want = JL.apply_rope(x, pos, fraction=fraction, theta=5e6)
    got = TL.apply_rope(_t(x), _t(pos), fraction=fraction, theta=5e6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    names = ["w_gate", "w_up", "w_down"] if act == "swiglu" else ["w_up", "w_down"]
    p = {n: _rand(rng, *((48, 32) if n == "w_down" else (32, 48)), scale=0.2)
         for n in names}
    x = _rand(rng, 2, 5, 32)
    got = TL.mlp({n: _t(w) for n, w in p.items()}, _t(x), act)
    np.testing.assert_allclose(to_np(got), np.asarray(JL.mlp(p, x, act)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_with_ring_masks(window):
    """Decode-shaped GQA attention over a ring cache: slots hold scattered
    positions, some invalid (-1)."""
    rng = np.random.default_rng(3)
    b, tq, hq, hkv, hd, s = 2, 3, 4, 2, 16, 24
    q, k, v = _rand(rng, b, tq, hq, hd), _rand(rng, b, s, hkv, hd), _rand(rng, b, s, hkv, hd)
    qpos = np.array([[20, 21, 22], [9, 10, 11]], np.int32)
    kpos = np.stack([rng.permutation(s) for _ in range(b)]).astype(np.int32)
    kpos[:, ::5] = -1
    kvalid = kpos >= 0
    kw = dict(causal=True, window=window, q_chunk=2, k_chunk=7)
    want = JL.attention(q, k, v, qpos=qpos, kpos=kpos, kvalid=kvalid, **kw)
    got = TL.attention(_t(q), _t(k), _t(v), qpos=_t(qpos), kpos=_t(kpos),
                       kvalid=_t(kvalid), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def _attn_params(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    return {"wq": _rand(rng, d, cfg.n_heads * hd, scale=0.15),
            "wk": _rand(rng, d, cfg.n_kv_heads * hd, scale=0.15),
            "wv": _rand(rng, d, cfg.n_kv_heads * hd, scale=0.15),
            "wo": _rand(rng, cfg.n_heads * hd, d, scale=0.1)}


def _cache_np(c):
    return [np.asarray(to_np(getattr(c, f))) for f in ("k", "v", "pos", "length")]


@pytest.mark.parametrize("size", [32, 6])
def test_self_attention_block_prefill_then_decode(size):
    """Prefill (through flash_attention) then decode (plain attention over
    the ring): outputs and caches equal, positions exact. ``size`` 6 is a
    ring smaller than the prompt."""
    cfg = j_configs.get_smoke_config("chatglm3_6b")
    rng = np.random.default_rng(4)
    p = _attn_params(rng, cfg)
    tp = {n: _t(w) for n, w in p.items()}
    b, t = 2, 9
    x = _rand(rng, b, t + 2, cfg.d_model)
    jc = JL.init_kv_cache(b, size, cfg.n_kv_heads, cfg.hd, jnp.float32)
    tc = TL.init_kv_cache(b, size, cfg.n_kv_heads, cfg.hd, torch.float32, device="cpu")
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    jo, jc = JL.self_attention_block(p, x[:, :t], cfg, positions=pos, cache=jc)
    to, tc = TL.self_attention_block(tp, _t(x[:, :t]), cfg, positions=_t(pos.copy()),
                                     cache=tc)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=2e-5, atol=2e-5)
    for i in (t, t + 1):
        dpos = np.full((b, 1), i, np.int32)
        jo, jc = JL.self_attention_block(p, x[:, i:i + 1], cfg, positions=dpos, cache=jc)
        to, tc = TL.self_attention_block(tp, _t(x[:, i:i + 1]), cfg,
                                         positions=_t(dpos), cache=tc)
        np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=2e-5, atol=2e-5)
        for g, w in zip(_cache_np(tc)[:2], _cache_np(jc)[:2]):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(_cache_np(tc)[2], _cache_np(jc)[2])
        assert int(tc.length) == int(jc.length) == i + 1


# -- the dense models ------------------------------------------------------------

def jax_params_np(cfg, seed=0):
    tree = JM.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_then_decode_logits_equal_jax(arch):
    cfg = j_configs.get_smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.with_(capacity_factor=100.0)  # drop-free, as the reference's test
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, t_configs.get_smoke_config(arch), "cpu")
    rng = np.random.default_rng(5)
    b, t = 2, 11
    toks = rng.integers(0, cfg.vocab, (b, t + 3)).astype(np.int32)
    js = JM.init_decode_state(cfg, b, max_len=32)
    ts = TM.init_decode_state(cfg, b, max_len=32, device="cpu")
    jl, js = JM.prefill(tree, {"tokens": jnp.asarray(toks[:, :t])}, js, cfg)
    tl, ts = TM.prefill(params, {"tokens": _t(toks[:, :t])}, ts, cfg)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)
    for i in range(t, t + 3):
        jl, js = JM.decode_step(tree, jnp.asarray(toks[:, i]), js, cfg)
        tl, ts = TM.decode_step(params, _t(toks[:, i]), ts, cfg)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(to_np(ts["pos"]), np.asarray(js["pos"]))


def test_params_from_numpy_carries_bf16_exactly():
    cfg = j_configs.get_smoke_config("yi_6b").with_(dtype="bfloat16")
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    w = params["layers"][1]["attn"]["wk"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  tree["layers"]["attn"]["wk"][1].astype(np.float32))


def test_params_from_numpy_keeps_the_moe_router_f32():
    """A bf16 moe tree: the router stays float32 (as both packages draw it),
    every other leaf is bf16, and both carry their bits exactly."""
    cfg = j_configs.get_smoke_config("mixtral_8x22b").with_(dtype="bfloat16")
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    moe = params["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tree["layers"]["moe"]["router"].dtype == np.float32
    np.testing.assert_array_equal(moe["router"].numpy(), tree["layers"]["moe"]["router"][1])
    assert moe["w_up"].dtype == torch.bfloat16 and params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["w_up"].float().numpy(),
                                  tree["layers"]["moe"]["w_up"][1].astype(np.float32))


def test_mixtral_swa_ring_decode_past_the_window_equals_jax():
    """tests/test_models.py's ring test through the port: a 30-token
    prefill (past the 16-token window: the plain windowed attention) and 10
    decode steps over the 16-slot ring; each step's logits equal the JAX
    package's, and the last equals the port's full forward at position 39."""
    cfg = j_configs.get_smoke_config("mixtral_8x22b").with_(capacity_factor=100.0)
    assert cfg.swa_window == 16
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 40)).astype(np.int32)
    js = JM.init_decode_state(cfg, 1, max_len=64)
    ts = TM.init_decode_state(cfg, 1, max_len=64, device="cpu")
    assert ts["kv"][0].k.shape[1] == 16
    _, js = JM.prefill(tree, {"tokens": jnp.asarray(toks[:, :30])}, js, cfg,
                       q_chunk=8, k_chunk=8)
    _, ts = TM.prefill(params, {"tokens": _t(toks[:, :30])}, ts, cfg, q_chunk=8, k_chunk=8)
    for i in range(30, 40):
        jl, js = JM.decode_step(tree, jnp.asarray(toks[:, i]), js, cfg)
        tl, ts = TM.decode_step(params, _t(toks[:, i]), ts, cfg)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(to_np(ts["kv"][1].pos), np.asarray(js["kv"].pos[1]))
    full, _ = TM.forward(params, {"tokens": _t(toks)}, cfg, remat=False, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(to_np(tl), to_np(full[:, 39]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t,flash", [(16, True), (17, False)])
def test_prefill_asks_for_flash_only_within_the_window(monkeypatch, t, flash):
    """Mixtral's window is 16 in its smoke config: a prefill of 16 tokens
    asks for flash_attention once per layer, one of 17 never (the kernel
    has no window), and both equal the JAX package's prefill."""
    from repro_torch.kernels import flash_attention as fa

    cfg = j_configs.get_smoke_config("mixtral_8x22b").with_(capacity_factor=100.0)
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    calls = []
    orig = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[1])
        return orig(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (1, t)).astype(np.int32)
    tl, _ = TM.prefill(params, {"tokens": _t(toks)},
                       TM.init_decode_state(cfg, 1, max_len=64, device="cpu"), cfg)
    jl, _ = JM.prefill(tree, {"tokens": jnp.asarray(toks)},
                       JM.init_decode_state(cfg, 1, max_len=64), cfg)
    assert calls == ([t] * cfg.n_layers if flash else [])
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)


def test_bf16_logits_are_f32_like_jax():
    """bf16 weights and activations, f32 logits (preferred_element_type)."""
    cfg = j_configs.get_smoke_config("yi_6b").with_(dtype="bfloat16")
    tree = jax_params_np(cfg)
    params = TM.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, 7)).astype(np.int32)
    jl, _ = JM.prefill(tree, {"tokens": jnp.asarray(toks)},
                       JM.init_decode_state(cfg, 1, max_len=16), cfg)
    tl, _ = TM.prefill(params, {"tokens": _t(toks)},
                       TM.init_decode_state(cfg, 1, max_len=16, device="cpu"), cfg)
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    # bf16 rounds at other places in the two frameworks (after each matmul,
    # norm and RoPE); logits of magnitude ~2 agree to ~0.024 at this seed
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=5e-2, atol=5e-2)


def test_init_params_shapes_and_scale():
    cfg = t_configs.get_smoke_config("granite_20b")
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j = jax_params_np(cfg)
    assert p["embed"].shape == j["embed"].shape and p["head"].shape == j["head"].shape
    for name, w in p["layers"][0]["attn"].items():
        assert tuple(w.shape) == j["layers"]["attn"][name].shape[1:]
        assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    again = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["layers"][2]["mlp"]["w_down"], again["layers"][2]["mlp"]["w_down"])


def test_device_defaults_to_cuda():
    cfg = t_configs.get_smoke_config("yi_6b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_decode_state(cfg, 1, 8)


def test_layer_helpers_default_to_cuda():
    """The public init helpers of ``models/layers.py`` take the card unless
    the caller asks for the CPU: without CUDA the default raises."""
    cfg = t_configs.get_smoke_config("yi_6b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TL.init_kv_cache(1, 8, cfg.n_kv_heads, cfg.hd, torch.float32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TL.dense_init(gen, (4, 4))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TL.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.n_layers, torch.float32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TL.attn_init(gen, cfg, torch.float32)
    assert TL.init_kv_cache(1, 8, cfg.n_kv_heads, cfg.hd, torch.float32,
                            device="cpu").k.device.type == "cpu"
