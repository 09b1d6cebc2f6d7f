"""The port's checkpoints against the JAX package's: one on-disk format, so a
checkpoint saved by either package restores in the other (bf16 leaves and
8-bit moments included, the port's per-layer lists as the reference's
stacked leaves), plus the reference's own checkpoint contract on the port
(atomic ``.tmp`` dirs ignored, ``latest_step``, missing leaves refused,
the same step overwritten, the async saver). Every comparison is exact."""
import json
import os

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
from repro_torch.tree import leaves, tree_map


def _cfg():
    return get_smoke_config("yi_6b").with_(dtype="bfloat16")


def _ref_state(eight_bit=False, seed=0):
    cfg = _cfg()
    st = JTS.init_train_state(jax.random.PRNGKey(seed), cfg,
                              JTS.TrainConfig(adamw=JO.AdamWConfig(eight_bit=eight_bit)))
    return cfg, {"params": st["params"], "opt": st["opt"], "step": jnp.asarray(7, jnp.int32)}


def _port_state(eight_bit=False, seed=3):
    cfg = _cfg()
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    opt = TO.init(params, TO.AdamWConfig(eight_bit=eight_bit))
    # moments that are not all zero, so the comparison sees their values
    g = torch.Generator().manual_seed(seed + 1)
    opt = {"mu": tree_map(
        lambda p, mu, stacked: {k: (torch.randn(p.shape, generator=g) if not eight_bit else
                                    TO._q_state(torch.randn(p.shape, generator=g)))
                                for k in mu}, params, opt["mu"]),
           "count": torch.tensor(5, dtype=torch.int32)}
    return cfg, {"params": params, "opt": opt, "step": torch.tensor(11, dtype=torch.int32)}


def _port_like(cfg, eight_bit=False):
    _, st = _port_state(eight_bit, seed=99)
    return st


def _ref_flat(tree):
    """The reference's flat path -> array view of its tree, bf16 widened as
    the port's ``host_arrays`` widens it."""
    widen = lambda a: a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return {k: widen(np.asarray(v)) for k, v in j_ckpt._flatten(tree).items()}


def _assert_same(port, ref):
    fa, fb = t_ckpt.host_arrays(port), _ref_flat(ref)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, eight_bit):
    cfg, st = _port_state(eight_bit)
    t_ckpt.save(str(tmp_path), 11, st)
    _, like = _ref_state(eight_bit)
    restored, step = j_ckpt.restore(str(tmp_path), like)
    assert step == 11
    _assert_same(st, restored)
    assert restored["params"]["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    assert restored["params"]["layers"]["attn"]["wq"].shape[0] == cfg.n_layers
    if eight_bit:
        assert restored["opt"]["mu"]["head"]["m"]["q"].dtype == jnp.int8


@pytest.mark.parametrize("eight_bit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, eight_bit):
    cfg, st = _ref_state(eight_bit)
    j_ckpt.save(str(tmp_path), 7, st)
    restored, step = t_ckpt.restore(str(tmp_path), _port_like(cfg, eight_bit))
    assert step == 7
    _assert_same(restored, st)
    assert restored["params"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert len(restored["params"]["layers"]) == cfg.n_layers
    assert restored["step"].shape == () and int(restored["step"]) == 7
    # the restored weights are the reference's: the same as params_from_numpy
    want = TM.params_from_numpy(jax.tree.map(np.asarray, st["params"]), cfg, "cpu")
    same = []
    TM.tree_map(lambda a, b: same.append(a.dtype == b.dtype and torch.equal(a, b)),
                restored["params"], want)
    assert len(same) == 3 + 9 * cfg.n_layers and all(same)


def test_manifests_agree(tmp_path):
    """The same state saved by each package: the same leaves, shapes and
    dtypes in manifest.json (bf16 widened to float32 by both)."""
    cfg, st = _ref_state()
    j_ckpt.save(str(tmp_path / "ref"), 1, st)
    port = t_ckpt.restore(str(tmp_path / "ref"), _port_like(cfg))[0]
    t_ckpt.save(str(tmp_path / "port"), 1, port)
    read = lambda d: json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())
    assert read("port")["leaves"] == read("ref")["leaves"]
    assert read("port")["leaves"]["params/embed"]["dtype"] == "float32"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
                   "stack": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
                   .to(torch.bfloat16)},
        "opt": {"count": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    t = _tree()
    t_ckpt.save(str(tmp_path), 3, t)
    like = tree_map(lambda x, stacked: torch.zeros_like(x), t)
    restored, step = t_ckpt.restore(str(tmp_path), like)
    assert step == 3
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_tmp_dirs_ignored(tmp_path):
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    for s in (1, 5, 12):
        t_ckpt.save(str(tmp_path), s, _tree(s))
    os.makedirs(tmp_path / "step_00000099.tmp")  # torn save
    assert t_ckpt.latest_step(str(tmp_path)) == 12
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"), _tree())


def test_missing_leaf_raises(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        t_ckpt.restore(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_overwrite_same_step(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    t_ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    restored, _ = t_ckpt.restore(str(tmp_path), {"a": torch.zeros(3)})
    assert torch.equal(restored["a"], torch.ones(3))


def test_async_saver_saves_the_state_of_its_step(tmp_path):
    """The next step updates the tensors in place at once: the checkpoint
    still holds the values at the save, per-layer lists included."""
    t = {"layers": [{"w": torch.full((64, 64), float(i))} for i in range(3)],
         "b": torch.ones(1000, dtype=torch.bfloat16)}
    want = tree_map(lambda x, stacked: x.clone(), t)
    saver = t_ckpt.AsyncSaver()
    saver.save(str(tmp_path), 4, t)
    for x in leaves(t):  # the next step, in place, while the thread writes
        x.add_(100)
    saver.wait()
    restored, step = t_ckpt.restore(str(tmp_path), want)
    assert step == 4
    for a, b in zip(leaves(want), leaves(restored)):
        assert torch.equal(a, b)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as z:
        assert z["layers/w"].shape == (3, 64, 64)


def test_async_saver_reports_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    saver = t_ckpt.AsyncSaver()
    saver.save(str(tmp_path / "file"), 1, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # reported once


def test_restore_into_fills_the_tree_in_place(tmp_path):
    """The trainer's restore: every tensor of the tree keeps its identity
    and takes the saved values (bf16 and per-layer lists included)."""
    t = {"layers": [{"w": torch.full((4, 6), float(i)).to(torch.bfloat16)} for i in range(3)],
         **_tree(1)}
    t_ckpt.save(str(tmp_path), 2, t)
    into = tree_map(lambda x, stacked: torch.zeros_like(x), t)
    ids = [id(x) for x in leaves(into)]
    assert t_ckpt.restore_into(str(tmp_path), into) == 2
    assert [id(x) for x in leaves(into)] == ids
    for a, b in zip(leaves(t), leaves(into)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_reads_a_compressed_npz(tmp_path):
    """Members that ``np.savez`` stores are mapped from the file; a
    checkpoint rewritten with ``np.savez_compressed`` restores the same."""
    t = _tree(2)
    t_ckpt.save(str(tmp_path), 1, t)
    npz = tmp_path / "step_00000001" / "arrays.npz"
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    np.savez_compressed(npz, **arrays)
    restored, _ = t_ckpt.restore(str(tmp_path), t)
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("like", [{"a": torch.zeros(4)}, {"a": [torch.zeros(3)] * 2},
                                  {"a": [torch.zeros(2)] * 3}])
def test_restore_refuses_another_shape(tmp_path, like):
    t_ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore(str(tmp_path), like)
