"""The port's flash_attention on the CPU (its plain PyTorch version,
``kernels/ref.flash_attention_ref``) against the Pallas kernel in interpret
mode and the JAX oracle ``repro.kernels.ref.flash_attention_ref``. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import (HEAD_DIMS, WGMMA_HEAD_DIMS, _design,
                                                  flash_attention)
from repro_torch.kernels.ref import flash_attention_ref

TORCH_DTYPE = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _qkv(t, h, d, seed=0, hkv=None):
    rng = np.random.default_rng(seed)
    mk = lambda heads: (rng.normal(size=(1, t, heads, d)) * 0.3).astype(np.float32)
    return mk(h), mk(hkv or h), mk(hkv or h)


def _port(arrays, dtype=np.float32, causal=True):
    ts = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays]
    return flash_attention(*ts, causal=causal).float().numpy()


def _jax_ref(q, k, v, causal):
    return np.asarray(jax.vmap(lambda qq, kk, vv: j_flash_ref(
        qq, kk, vv, causal=causal))(q, k, v), np.float32)


@pytest.mark.parametrize("t,h,d", [(32, 2, 16), (64, 1, 32), (96, 2, 8),
                                   (130, 1, 16), (256, 1, 64), (130, 2, 80)])
def test_causal_sweep_equals_pallas(t, h, d):
    q, k, v = _qkv(t, h, d, seed=t + d)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   block_q=32, block_k=32, interpret=True)
    got = _port((q, k, v))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, True), rtol=2e-5, atol=2e-5)


def test_bf16_equals_pallas():
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(64, 2, 32, seed=9))
    want = j_flash(q, k, v, causal=True, block_q=32, block_k=32, interpret=True)
    got = _port([np.asarray(a, np.float32) for a in (q, k, v)], jnp.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_bf16_head_dim_80_equals_pallas():
    # d = 80 (StableLM-3B, Zamba2's shared block): one wide and one narrow
    # box per tile on the card's wgmma design
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(96, 2, 80, seed=80))
    want = j_flash(q, k, v, causal=True, block_q=32, block_k=32, interpret=True)
    got = _port([np.asarray(a, np.float32) for a in (q, k, v)], jnp.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_non_causal_equals_pallas():
    q, k, v = _qkv(64, 2, 16)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                   block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(_port((q, k, v), causal=False), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_equals_pallas_on_repeated_heads(causal):
    q, k, v = _qkv(48, 4, 16, seed=4, hkv=2)
    rep = lambda a: jnp.repeat(jnp.asarray(a), 2, axis=2)
    want = j_flash(jnp.asarray(q), rep(k), rep(v), causal=causal, block_q=16,
                   block_k=16, interpret=True)
    np.testing.assert_allclose(_port((q, k, v), causal=causal), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_non_causal_head_dim_80_equals_pallas():
    # T a multiple of the block: the Pallas kernel pads nothing
    q, k, v = _qkv(64, 2, 80, seed=81)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                   block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_port((q, k, v), causal=False), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_port((q, k, v), causal=False), _jax_ref(q, k, v, False),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_head_dim_80_equals_pallas_on_repeated_heads(causal):
    q, k, v = _qkv(64, 4, 80, seed=82, hkv=2)
    rep = lambda a: jnp.repeat(jnp.asarray(a), 2, axis=2)
    want = j_flash(jnp.asarray(q), rep(k), rep(v), causal=causal, block_q=32,
                   block_k=32, interpret=True)
    np.testing.assert_allclose(_port((q, k, v), causal=causal), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_non_causal_ragged_tail_equals_oracle():
    # Against the oracle only: the Pallas kernel pads K/V with zero rows to a
    # block multiple and masks key positions only when causal, so at T=40,
    # block 32 its non-causal output lets 24 padded keys (score 0) into the
    # softmax (max error ~0.04 against the oracle). The port masks keys >= T
    # always and computes the oracle's function.
    q, k, v = _qkv(40, 2, 16, seed=1)
    np.testing.assert_allclose(_port((q, k, v), causal=False),
                               _jax_ref(q, k, v, False), rtol=2e-5, atol=2e-5)


def test_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 2, 16))
    before = dict(_lib.LAUNCHES)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_bf16_at_a_wgmma_shape_takes_the_plain_version(causal):
    # bf16 at d=128 is the wgmma design's shape on the card; on the CPU it is
    # the plain version, and neither design's launch count moves
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(40, 4, 128, seed=2, hkv=2))
    before = dict(_lib.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=causal),
                               rtol=0, atol=0)
    assert got.dtype == torch.bfloat16
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_design_by_dtype_and_head_dim(d, dtype):
    # bf16 at d = 64, 80 or 128 takes the wgmma kernel; fp32 and bf16 at
    # d = 16 and 32 keep the mma.sync kernel
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 80, 128) else "mma"
    assert _design(dtype, d) == want
    assert set(WGMMA_HEAD_DIMS) <= set(HEAD_DIMS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ported_configs_select_wgmma(arch):
    # every config with attention, at d = 80 too (StableLM-3B's layers,
    # Zamba2's shared block, HuBERT's, whose forward attends through the
    # plain attention: an encoder has no cached prefill), takes the wgmma
    # design
    cfg = get_config(arch)
    dtype = getattr(torch, cfg.dtype)
    assert dtype == torch.bfloat16
    if cfg.family == "ssm":  # RWKV6: no attention layer
        assert cfg.n_heads == 0 and arch == "rwkv6_7b"
        return
    assert cfg.hd in HEAD_DIMS
    assert _design(dtype, cfg.hd) == "wgmma"


def test_shape_checks():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))
