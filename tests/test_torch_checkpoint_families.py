"""Checkpoints of the grouped parameter trees between the packages: the
vlm's ``groups[*].self`` (a list of layers within the list of groups,
beside each group's ``cross`` block) and the hybrid's ``shared_attn`` beside
``groups[*].mamba``. A state saved by either package restores in the other
bit for bit (bf16 params, float32 and 8-bit moments, the step), the port's
nested lists as the reference's stacked leaves."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_smoke_config
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.tree import flat_paths, leaves, tree_map

ARCHS = ["llama_3_2_vision_90b", "zamba2_2_7b"]


def _cfg(arch):
    return get_smoke_config(arch).with_(dtype="bfloat16")


@functools.lru_cache(maxsize=None)  # its arrays are immutable
def _ref_state(arch, eight_bit, seed=0):
    st = JTS.init_train_state(jax.random.PRNGKey(seed), _cfg(arch),
                              JTS.TrainConfig(adamw=JO.AdamWConfig(eight_bit=eight_bit)))
    return {"params": st["params"], "opt": st["opt"], "step": jnp.asarray(7, jnp.int32)}


def _port_state(arch, eight_bit, seed=3):
    """Fresh params and moments that are not zero, so that a comparison
    sees their values."""
    params = TM.init_params(_cfg(arch), torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    draw = lambda p: torch.randn(p.shape, generator=g)
    mu = tree_map(lambda p, m, stacked: {k: TO._q_state(draw(p)) if eight_bit else draw(p)
                                         for k in m},
                  params, TO.init(params, TO.AdamWConfig(eight_bit=eight_bit))["mu"])
    return {"params": params, "opt": {"mu": mu, "count": torch.tensor(5, dtype=torch.int32)},
            "step": torch.tensor(11, dtype=torch.int32)}


def _assert_same(port, ref):
    """Every leaf of the two trees, by the checkpoint's flat paths: equal
    shapes and values (bf16 widened to float32, as both packages save it)."""
    widen = lambda a: a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    fa = t_ckpt.host_arrays(port)
    fb = {k: widen(np.asarray(v)) for k, v in j_ckpt._flatten(ref).items()}
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _grouped_leaves(arch, flat):
    """The paths of the tree's grouped leaves, which must be there."""
    want = ("params/groups/self/", "params/groups/cross/") if arch.startswith("llama") else (
        "params/groups/mamba/", "params/shared_attn/")
    return [p for p in want if not any(k.startswith(p) for k in flat)]


@pytest.mark.parametrize("eight_bit", [False, True], ids=["f32_moments", "8bit_moments"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch, eight_bit):
    st = _port_state(arch, eight_bit)
    t_ckpt.save(str(tmp_path), 11, st)
    restored, step = j_ckpt.restore(str(tmp_path), _ref_state(arch, eight_bit))
    assert step == 11
    assert _grouped_leaves(arch, t_ckpt.host_arrays(st)) == []
    _assert_same(st, restored)


@pytest.mark.parametrize("eight_bit", [False, True], ids=["f32_moments", "8bit_moments"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch, eight_bit):
    st = _ref_state(arch, eight_bit)
    j_ckpt.save(str(tmp_path), 7, st)
    like = _port_state(arch, eight_bit, seed=99)
    restored, step = t_ckpt.restore(str(tmp_path), like)
    assert step == 7 and int(restored["step"]) == 7
    _assert_same(restored, st)
    # the restored weights are the reference's: params_from_numpy's, dtypes too
    cfg = _cfg(arch)
    want = TM.params_from_numpy(jax.tree.map(np.asarray, st["params"]), cfg, "cpu")
    got, exp = flat_paths(restored["params"]), flat_paths(want)
    assert sorted(got) == sorted(exp)
    for k in got:
        a, b = leaves(got[k]), leaves(exp[k])
        assert len(a) == len(b), k
        assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_through_the_reference_is_exact(tmp_path, arch):
    """Port -> reference -> port: the port's own state back bit for bit,
    in place (the trainer's ``restore_into``), every tensor keeping its
    identity."""
    st = _port_state(arch, False)
    t_ckpt.save(str(tmp_path / "a"), 2, st)
    ref, _ = j_ckpt.restore(str(tmp_path / "a"), _ref_state(arch, False))
    j_ckpt.save(str(tmp_path / "b"), 3, ref)
    into = _port_state(arch, False, seed=42)
    ids = [id(x) for x in leaves(into)]
    assert t_ckpt.restore_into(str(tmp_path / "b"), into) == 3
    assert [id(x) for x in leaves(into)] == ids
    for a, b in zip(leaves(st["params"]) + leaves(st["opt"]),
                    leaves(into["params"]) + leaves(into["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
