"""Training of the moe, vlm, hybrid, ssm and audio families through both
packages on the CPU: the port's Trainer with LB ingest against the
reference's, from the reference's own weights (``params_from_numpy``); one
``make_train_step`` step with the vlm's vision embeddings and one with an
encoder's frames through the ingest; Mamba2's gradients, equal to the
reference's where those are finite, and finite where its decay passes
float32's range.

Neither package's Trainer draws vision embeddings: both trainers of the vlm
get them from ``repro_torch.testing.batches.with_vision`` (it wraps either
package's ``synthetic_batch``). float32 smoke configs compare at rtol/atol
2e-4 (float32 reassociation between XLA and PyTorch), as
``tests/test_torch_train.py`` does; the ingest's occupancy is exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.epoch import EpochManager as JEpochManager
from repro.core.tables import MemberSpec as JMemberSpec
from repro.models import mamba2 as JM2
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core.epoch import EpochManager as TEpochManager
from repro_torch.core.tables import MemberSpec as TMemberSpec
from repro_torch.distributed.sharding import Mesh
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.testing.batches import with_frames, with_vision
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from test_torch_families import _as_jax, _assert_tree_close

TOL = dict(rtol=2e-4, atol=2e-4)
#: the non-dense smoke configs, RWKV6 at the reference's chunk of 1 and at 4
CASES = [("mixtral_8x22b", {}), ("arctic_480b", {}), ("llama_3_2_vision_90b", {}),
         ("zamba2_2_7b", {}), ("rwkv6_7b", {}), ("rwkv6_7b", {"rwkv_chunk": 4}),
         ("hubert_xlarge", {})]


def _train_cfgs(**kw):
    common = dict(remat=True, lb_ingest=True, q_chunk=8, k_chunk=8, **kw)
    return (JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3), **common),
            TTS.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3), **common))


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[a + "".join(f"-{k}{v}" for k, v in kw.items()) for a, kw in CASES])
def test_trainer_with_lb_ingest_equals_reference(tmp_path, arch, kw):
    """Two steps of each trainer on a one-rank mesh (4 LB members): every
    metric within rtol/atol 2e-4, the occupancy exact, and every param
    after the steps within 2e-4 of the reference's."""
    cfg = get_smoke_config(arch)
    jt, tt = _train_cfgs(**kw)
    jtr = JTrainer(cfg, jt, JTrainerConfig(ckpt_dir=str(tmp_path / "ref")),
                   mesh=jax.make_mesh((1,), ("data",)))
    jtr.init_or_restore(jax.random.PRNGKey(0))
    ttr = TTrainer(cfg, tt, TTrainerConfig(ckpt_dir=str(tmp_path / "port"), device="cpu"),
                   mesh=Mesh(("data",), (1,)))
    ttr.init_or_restore(torch.Generator().manual_seed(7))
    ttr.state["params"] = TM.params_from_numpy(jax.tree.map(np.asarray, jtr.state["params"]),
                                               cfg, "cpu")
    ttr.state["opt"] = TO.init(ttr.state["params"], tt.adamw)
    if cfg.family == "vlm":
        with_vision(jtr), with_vision(ttr)
    hj, ht = jtr.run(2, batch=8, seq=16), ttr.run(2, batch=8, seq=16)
    assert [sorted(h) for h in ht] == [sorted(h) for h in hj]
    for a, b in zip(ht, hj):
        assert a["ingest_occupancy"] == b["ingest_occupancy"] > 0
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    _assert_tree_close(_as_jax(ttr.state["params"]),
                       jax.tree.map(np.asarray, jtr.state["params"]), **TOL)


def _tables(n_members=4):
    """One LB instance programmed the same way in both packages: the
    trainer's members (node i, no lanes), even weights."""
    out = []
    for em, spec in ((JEpochManager(max_members=64), JMemberSpec),
                     (TEpochManager(max_members=64), TMemberSpec)):
        em.initialize({i: spec(node_id=i) for i in range(n_members)},
                      {i: 1.0 for i in range(n_members)})
        out.append(em)
    return out[0].device_tables(), out[1].device_tables("cpu")


@pytest.mark.parametrize("feed", ["vision", "frames"])
def test_make_train_step_with_embeddings_through_the_ingest_equals_reference(feed):
    """One step of ``make_train_step`` with LB ingest on a batch that
    carries embeddings the ingest scatters with their rows: the vlm's
    ``vision_embeds`` beside its tokens, and the encoder's frame
    ``embeds`` in place of them (as the full-width runs on the card feed
    HuBERT): loss, metrics and params within 2e-4 of the reference's."""
    cfg = get_smoke_config("llama_3_2_vision_90b" if feed == "vision" else "hubert_xlarge")
    jt, tt = _train_cfgs()
    js = JTS.init_train_state(jax.random.PRNGKey(1), cfg, jt)
    ts = {"params": TM.params_from_numpy(jax.tree.map(np.asarray, js["params"]), cfg, "cpu"),
          "efb": None, "step": torch.zeros((), dtype=torch.int32)}
    ts["opt"] = TO.init(ts["params"], tt.adamw)

    # the trainer's draws through the wrapper that the runs on the card use
    draws = TTrainer(cfg, tt, TTrainerConfig(device="cpu"), mesh=Mesh(("data",), (1,)))
    batch = (with_vision if feed == "vision" else with_frames)(draws).synthetic_batch(
        8, 16, np.random.default_rng(4))
    jtab, ttab = _tables()
    jstep = JTS.make_train_step(cfg, jt, jax.make_mesh((1,), ("data",)))
    js, jm = jax.jit(jstep)(js, jax.tree.map(jnp.asarray, batch), jtab)
    ts, tm = TTS.make_train_step(cfg, tt, Mesh(("data",), (1,)))(ts, batch, ttab)
    assert float(tm["ingest_occupancy"]) == float(jm["ingest_occupancy"]) > 0
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
    _assert_tree_close(_as_jax(ts["params"]), jax.tree.map(np.asarray, js["params"]), **TOL)


@functools.lru_cache(maxsize=None)
def _reference_block(chunk):
    """The reference's Mamba2 block of the hybrid's smoke config, jitted
    once for both Mamba2 tests: (output, gradients of its sum over the
    params and the input)."""
    cfg = get_smoke_config("zamba2_2_7b")
    out = lambda p, x: JM2.mamba2_block(p, x, cfg, chunk=chunk)[0]
    return jax.jit(lambda p, x: (out(p, x), jax.grad(lambda p, x: out(p, x).sum(),
                                                      argnums=(0, 1))(p, x)))


def _mamba_grads(dt_bias, a_log, chunk=16, seed=2):
    """A Mamba2 block of the hybrid's smoke config: (port output, port
    gradients, reference output, reference gradients) of the output's sum
    over every float param and the input, at the given dt bias and log A."""
    cfg = get_smoke_config("zamba2_2_7b")
    jp = jax.tree.map(np.asarray, JM2.mamba2_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    jp = dict(jp, dt_bias=np.full_like(jp["dt_bias"], dt_bias),
              a_log=np.full_like(jp["a_log"], a_log))
    x = (np.random.default_rng(seed).normal(size=(2, 29, cfg.d_model)) * 0.1).astype(np.float32)
    jy, jg = _reference_block(chunk)(jp, x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = TM2.mamba2_block(tp, tx, cfg, chunk=chunk)[0]
    tg = torch.autograd.grad(ty.sum(), [tp[k] for k in sorted(tp)] + [tx])
    want = [np.asarray(jg[0][k]) for k in sorted(tp)] + [np.asarray(jg[1])]
    return ty.detach().numpy(), [g.numpy() for g in tg], np.asarray(jy), want


def test_mamba2_gradients_equal_reference():
    """A moderate decay (dt ~ 0.13, A = -1, the init's): the block's output
    and every gradient equal the reference's."""
    ty, tg, jy, jg = _mamba_grads(-2.0, 0.0)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_mamba2_gradient_is_finite_where_the_decay_passes_float32():
    """A strong decay (dt ~ 20, A = -e: exponents past float32's range over
    a chunk of 16, as Zamba2's reach at published width): the port's
    output equals the reference's, and its gradients are finite where the
    reference's, which zeroes exp's inf after the exp, are NaN."""
    ty, tg, jy, jg = _mamba_grads(20.0, 1.0)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    assert all(np.isfinite(g).all() for g in tg)
    assert not all(np.isfinite(w).all() for w in jg)
