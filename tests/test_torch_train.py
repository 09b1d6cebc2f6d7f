"""The port's training path on the CPU against the JAX package's: the model's
``forward``/``train_loss`` and every gradient, AdamW (float32 and 8-bit
moments), the schedule and the clip, gradient accumulation and
compression, the trainer (embedded and controld, LB ingest on and off)
from the reference's own checkpointed weights, its failure re-calendar and
straggler weights, and ``launch.train``.

Inputs come from numpy seeds; params cross over from the reference
(``params_from_numpy``, or a reference checkpoint restored by the port).
float32 smoke configs compare at rtol/atol 2e-4, as
``tests/test_torch_models.py`` does for logits (float32 reassociation
between XLA and PyTorch); integer outputs (occupancy, calendars, int8
states except at exact halves) are exact. The trainers' reported step times
are pinned, as the serving tests pin decode times: they are wall time and
reach the control plane.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_smoke_config
from repro.core.calendar import calendar_counts
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import train as t_launch
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.tree import leaves, tree_map
from repro_torch.train import train_step as TTS
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig

DENSE = ["yi_6b", "stablelm_3b", "granite_20b", "chatglm3_6b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _j_params(cfg, seed=0):
    return JM.init_params(jax.random.PRNGKey(seed), cfg)


def _cross(jp, cfg):
    return TM.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _batch(cfg, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    labels = toks.copy()
    labels[-1, 3:7] = -1  # the ingest's dropped rows carry -1
    return {"tokens": toks, "labels": labels}


def _stacked(port_tree, n_layers):
    """The port's per-layer list as the reference's stacked leaves (numpy)."""
    host = lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    out = jax.tree.map(host, {k: v for k, v in port_tree.items() if k != "layers"})
    out["layers"] = jax.tree.map(lambda *xs: np.stack([host(x) for x in xs]),
                                 *port_tree["layers"])
    return out


def _assert_tree_close(got, want, **tol):
    gl, gd = jax.tree.flatten(got)
    wl, wd = jax.tree.flatten(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **tol)


# -- model ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_equal_reference(arch):
    cfg = get_smoke_config(arch)
    jp = _j_params(cfg)
    b = _batch(cfg)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(b["tokens"])}, cfg, remat=False,
                         q_chunk=8, k_chunk=8)
    got, aux = TM.forward(_cross(jp, cfg), {"tokens": torch.from_numpy(b["tokens"])}, cfg,
                          remat=False, q_chunk=8, k_chunk=8)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _port_loss_and_grads(params, batch, cfg, remat):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, met = TM.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                              remat=remat, q_chunk=8, k_chunk=8)
    grads = iter(torch.autograd.grad(loss, ps))
    return loss, met, tree_map(lambda p, stacked: next(grads), params)


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_every_gradient_equal_reference(arch):
    cfg = get_smoke_config(arch)
    jp = _j_params(cfg)
    b = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(p, {k: jnp.asarray(v) for k, v in b.items()}, cfg,
                                remat=False, q_chunk=8, k_chunk=8), has_aux=True)(jp)
    loss, met, grads = _port_loss_and_grads(_cross(jp, cfg), b, cfg, remat=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for k in ("ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(met[k]), float(jm[k]), **TOL)
    _assert_tree_close(_stacked(grads, cfg.n_layers), jax.tree.map(np.asarray, jg), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_remat_equals_no_remat(arch):
    """Recomputing each layer in the backward repeats the same float32
    arithmetic on the CPU: loss and gradients are equal bit for bit."""
    cfg = get_smoke_config(arch)
    params = _cross(_j_params(cfg), cfg)
    b = _batch(cfg, seed=1)
    l0, _, g0 = _port_loss_and_grads(params, b, cfg, remat=False)
    l1, _, g1 = _port_loss_and_grads(params, b, cfg, remat=True)
    assert torch.equal(l0, l1)
    for a, c in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, c)


def test_forward_never_calls_the_flash_kernel(monkeypatch):
    """Training attends through layers.attention: the forward-only kernel's
    wrapper is called by no forward or backward, and by every layer of a
    prefill (which shows the count works)."""
    calls = []
    orig = flash_mod.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention", counted)
    cfg = get_smoke_config("yi_6b")
    params = _cross(_j_params(cfg), cfg)
    b = _batch(cfg, b=2, t=12)
    for remat in (False, True):
        _port_loss_and_grads(params, b, cfg, remat)
        TM.forward(params, {"tokens": torch.from_numpy(b["tokens"])}, cfg, remat=remat)
    assert calls == []
    with torch.no_grad():
        st = TM.init_decode_state(cfg, 2, 32, device="cpu")
        TM.prefill(params, {"tokens": torch.from_numpy(b["tokens"])}, st, cfg)
    assert len(calls) == cfg.n_layers


def test_flash_attention_refuses_autograd():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_mod.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_mod.flash_attention(k, q, k)
    with torch.no_grad():
        flash_mod.flash_attention(q, k, k)
    flash_mod.flash_attention(q.detach(), k, k)


# -- optimizer -----------------------------------------------------------------

def test_schedule_equals_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    jc, tc = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        want = float(JO.schedule(jc, jnp.asarray(s, jnp.int32)))
        got = float(TO.schedule(tc, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_case(eight_bit, seed=0):
    cfg = get_smoke_config("yi_6b")
    jp = _j_params(cfg, seed)
    rng = np.random.default_rng(seed)
    jg = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jp)
    return cfg, jp, jg, dict(lr=1e-2, warmup_steps=1, decay_steps=50, eight_bit=eight_bit)


def _port_grads(jg, cfg):
    return TM.params_from_numpy(jax.tree.map(np.asarray, jg), cfg, "cpu")


def _assert_int8_states_close(got, want):
    """int8 moments: equal, or within 1 where the port's pre-round value
    sits at an exact half (round half to even on a value one ulp apart)."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.int8:
            diff = np.abs(g.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_update_equals_reference(eight_bit):
    """Two updates from the same params and gradients: params within 1e-6
    relative, the clip's norm and lr likewise, float32 moments within 1e-5,
    int8 moments as _assert_int8_states_close says."""
    cfg, jp, jg, kw = _opt_case(eight_bit)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    js = JO.init(jp, jc)
    tp = _cross(jp, cfg)
    ts = TO.init(tp, tc)
    tg = _port_grads(jg, cfg)
    for _ in range(2):
        jp, js, jmet = JO.update(jg, js, jp, jc)
        tp, ts, tmet = TO.update(tg, ts, tp, tc)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)
    _assert_tree_close(_stacked(tp, cfg.n_layers), jax.tree.map(np.asarray, jp),
                       rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 2
    got_mu = _stacked(ts["mu"], cfg.n_layers)
    want_mu = jax.tree.map(np.asarray, js["mu"])
    assert jax.tree.structure(got_mu) == jax.tree.structure(want_mu)
    if eight_bit:
        # keep int8 as int8 for the comparison
        got_mu = jax.tree.map(lambda t: t.numpy(),
                              {k: v for k, v in ts["mu"].items() if k != "layers"})
        got_mu["layers"] = jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]),
                                        *ts["mu"]["layers"])
        _assert_int8_states_close(got_mu, want_mu)
        assert ts["mu"]["embed"]["m"]["q"].dtype == torch.int8
    else:
        _assert_tree_close(got_mu, want_mu, rtol=1e-5, atol=1e-12)


def test_weight_decay_takes_the_stacked_rank():
    """A layer's norm scale is a matrix in the reference's stacked layout
    ([L, d]): it is decayed; ``ln_f`` ([d]) is not. Zero gradients leave
    only the decay."""
    cfg = get_smoke_config("yi_6b")
    tp = _cross(_j_params(cfg), cfg)
    tc = TO.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    zeros = tree_map(lambda p, stacked: torch.zeros_like(p), tp)
    TO.update(zeros, TO.init(tp, tc), tp, tc)
    assert float(tp["ln_f"].min()) == 1.0
    assert float(tp["layers"][0]["ln1"].max()) < 1.0


def test_grad_clip_equals_reference():
    cfg = dict(lr=1e-3, grad_clip=1.0)
    params = {"w": np.zeros((4, 3), np.float32), "b": np.zeros((3,), np.float32)}
    grads = {"w": np.full((4, 3), 1e6, np.float32), "b": np.full((3,), -2e5, np.float32)}
    jp, _, jm = JO.update(jax.tree.map(jnp.asarray, grads),
                          JO.init(jax.tree.map(jnp.asarray, params), JO.AdamWConfig(**cfg)),
                          jax.tree.map(jnp.asarray, params), JO.AdamWConfig(**cfg))
    tp = jax.tree.map(torch.from_numpy, params)
    tp, _, tm = TO.update(jax.tree.map(torch.from_numpy, grads),
                          TO.init(tp, TO.AdamWConfig(**cfg)), tp, TO.AdamWConfig(**cfg))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert float(tm["grad_norm"]) > 1e5 and float(tp["w"].abs().max()) < 1.0
    _assert_tree_close(jax.tree.map(lambda t: t.numpy(), tp), jax.tree.map(np.asarray, jp),
                       rtol=1e-6, atol=1e-9)


# -- the step ------------------------------------------------------------------

def _steps(accum, compress=False, seed=0):
    cfg = get_smoke_config("yi_6b")
    kw = dict(remat=False, lb_ingest=False, accum_steps=accum, grad_compress=compress,
              q_chunk=8, k_chunk=8)
    jt = JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3), **kw)
    tt = TTS.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3), **kw)
    js = JTS.init_train_state(jax.random.PRNGKey(seed), cfg, jt)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), cfg, tt, "cpu")
    ts["params"] = _cross(js["params"], cfg)
    ts["opt"] = TO.init(ts["params"], tt.adamw)
    return cfg, jt, tt, js, ts


def test_accum_steps_equal_reference_and_full_batch():
    """accum_steps=2 against the reference's accum_steps=2 (rtol/atol 2e-4)
    and against the port's full batch (the reference's own 2e-3 / 2e-5)."""
    cfg, jt, tt, js, ts = _steps(accum=2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    js, jm = JTS.make_train_step(cfg, jt)(js, jax.tree.map(jnp.asarray, batch), None)
    ts, tm = TTS.make_train_step(cfg, tt)(ts, batch, None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    assert sorted(tm) == sorted(jm)
    _assert_tree_close(_stacked(ts["params"], cfg.n_layers),
                       jax.tree.map(np.asarray, js["params"]), **TOL)
    _, _, tt1, _, full = _steps(accum=1)
    full, _ = TTS.make_train_step(cfg, tt1)(full, batch, None)
    for a, b in zip(leaves(ts["params"]), leaves(full["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3,
                                   atol=2e-5)


def test_grad_compress_steps_equal_reference():
    """Two steps with int8 compression and error feedback: loss and params
    within rtol/atol 2e-4 of the reference's, the residual too but for
    rounding flips."""
    cfg, jt, tt, js, ts = _steps(accum=1, compress=True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    jstep, tstep = JTS.make_train_step(cfg, jt), TTS.make_train_step(cfg, tt)
    for _ in range(2):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch), None)
        ts, tm = tstep(ts, batch, None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    _assert_tree_close(_stacked(ts["params"], cfg.n_layers),
                       jax.tree.map(np.asarray, js["params"]), **TOL)
    # a residual element moves by one quantization step (its block's scale;
    # a residual is within half a step, so a step is under 2.5x the largest
    # residual) where the int8 rounding of a value one ulp apart flips: at
    # most 1 in 1000 elements
    got, want = jax.tree.leaves(_stacked(ts["efb"], cfg.n_layers)), jax.tree.leaves(js["efb"])
    flips = 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        flips += int((~np.isclose(g, w, **TOL)).sum())
        assert np.abs(g - w).max() <= 2.5 * np.abs(w).max()
    assert flips <= sum(np.size(w) for w in want) // 1000
    assert int(ts["step"]) == 2


@pytest.mark.parametrize("arch,kw", [("hubert_xlarge", {}), ("rwkv6_7b", {"rwkv_chunk": 4})])
def test_step_equals_reference_for_the_encoder_and_chunked_rwkv(arch, kw):
    """Two steps of the encoder (frame embeddings: the token embedding gets
    a zero gradient, so weight decay alone moves it, as in the reference)
    and of RWKV6 at the reference's ``TrainConfig.rwkv_chunk``: loss and
    params within rtol/atol 2e-4 of the reference's."""
    cfg = get_smoke_config(arch)
    common = dict(remat=True, lb_ingest=False, q_chunk=8, k_chunk=8, **kw)
    jt = JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3), **common)
    tt = TTS.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3), **common)
    js = JTS.init_train_state(jax.random.PRNGKey(0), cfg, jt)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), cfg, tt, "cpu")
    ts["params"] = _cross(js["params"], cfg)
    ts["opt"] = TO.init(ts["params"], tt.adamw)
    rng = np.random.default_rng(3)
    batch = _batch(cfg)
    if cfg.family == "audio":
        batch = {"embeds": rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    embed0 = ts["params"]["embed"].clone()
    jstep, tstep = JTS.make_train_step(cfg, jt), TTS.make_train_step(cfg, tt)
    for _ in range(2):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch), None)
        ts, tm = tstep(ts, batch, None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    _assert_tree_close(_stacked(ts["params"], cfg.n_layers),
                       jax.tree.map(np.asarray, js["params"]), **TOL)
    if cfg.family == "audio":
        assert not torch.equal(ts["params"]["embed"], embed0)  # decayed


def test_step_refuses_a_mesh_of_several_ranks():
    """Several data ranks need the mesh bound to their process group
    (``launch.mesh``), and several model ranks their groups too."""
    cfg = get_smoke_config("yi_6b")
    with pytest.raises(ValueError, match="process group"):
        TTS.make_train_step(cfg, TTS.TrainConfig(), Mesh(("data",), (2,)))
    with pytest.raises(ValueError, match="process groups"):
        TTS.make_train_step(cfg, TTS.TrainConfig(), Mesh(("data", "model"), (1, 2)))


# -- the trainer -----------------------------------------------------------------

def _pin(tr, slow=None):
    """Report a fixed step time per member (member ``slow`` 3x)."""
    orig = tr.hub.report_step

    def pinned(m, dt, **kw):
        return orig(m, 0.01 * (1 + 0.01 * m) * (3.0 if m == slow else 1.0), **kw)
    tr.hub.report_step = pinned


def _trainers(tmp_path, *, ingest, controld, slow=None, steps_kw=None):
    """The reference's Trainer on a one-device mesh and the port's, started
    from the reference's initial state through its checkpoint."""
    cfg = get_smoke_config("yi_6b")
    adamw = dict(lr=1e-2, warmup_steps=2, decay_steps=100)
    kw = dict(remat=False, lb_ingest=ingest, q_chunk=8, k_chunk=8)
    tkw = dict(n_members=4, ckpt_every=5, recalendar_every=4, use_controld=controld)
    jtr = JTrainer(cfg, JTS.TrainConfig(adamw=JO.AdamWConfig(**adamw), **kw),
                   JTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tkw),
                   mesh=jax.make_mesh((1,), ("data",)))
    jtr.init_or_restore(jax.random.PRNGKey(0))
    j_ckpt.save(str(tmp_path / "port"), 0, {"params": jtr.state["params"],
                                            "opt": jtr.state["opt"],
                                            "step": jtr.state["step"]})
    ttr = TTrainer(cfg, TTS.TrainConfig(adamw=TO.AdamWConfig(**adamw), **kw),
                   TTrainerConfig(ckpt_dir=str(tmp_path / "port"), device="cpu", **tkw),
                   mesh=Mesh(("data",), (1,)))
    assert ttr.init_or_restore(torch.Generator().manual_seed(7)) == 0
    _pin(jtr, slow)
    _pin(ttr, slow)
    return jtr, ttr


def _calendar(tr):
    return np.asarray(tr.manager.state.calendars[tr.manager.current_epoch])


@pytest.mark.parametrize("controld", [False, True], ids=["embedded", "controld"])
@pytest.mark.parametrize("ingest", [True, False], ids=["lb_ingest", "no_ingest"])
def test_trainer_history_equals_reference(tmp_path, ingest, controld):
    """12 steps, a re-calendar every 4, checkpoints at 5 and 10: every
    metric of every step within rtol/atol 2e-4 (ingest occupancy exact),
    the calendars and the checkpoint steps equal."""
    jtr, ttr = _trainers(tmp_path, ingest=ingest, controld=controld)
    hj, ht = jtr.run(12, batch=4, seq=16), ttr.run(12, batch=4, seq=16)
    assert [sorted(h) for h in ht] == [sorted(h) for h in hj]
    for a, b in zip(ht, hj):
        for k in a:
            if k == "ingest_occupancy":
                assert a[k] == b[k] == 0.25
            else:
                np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    np.testing.assert_array_equal(_calendar(ttr), _calendar(jtr))
    assert ttr.manager.current_epoch == jtr.manager.current_epoch
    assert j_ckpt.latest_step(str(tmp_path / "port")) == 10
    assert ttr.next_event == jtr.next_event == 48


@pytest.mark.parametrize("controld", [False, True], ids=["embedded", "controld"])
def test_failure_recalendar_and_added_member_equal_reference(tmp_path, controld):
    jtr, ttr = _trainers(tmp_path, ingest=True, controld=controld)
    for tr in (jtr, ttr):
        tr.run(6, batch=4, seq=16, failure_at={2: [3]})
    cal = _calendar(ttr)
    np.testing.assert_array_equal(cal, _calendar(jtr))
    assert 3 not in set(np.unique(cal)) and calendar_counts(cal, 4).sum() == 512
    for tr in (jtr, ttr):
        tr.add_members([5])
        tr.run(4, batch=4, seq=16)
    np.testing.assert_array_equal(_calendar(ttr), _calendar(jtr))
    assert ttr.manager.current_epoch == jtr.manager.current_epoch
    assert 5 in ttr.cp.members
    if not controld:  # the daemon's session has not switched epochs yet, in both packages
        assert 5 in set(np.unique(_calendar(ttr)))


@pytest.mark.parametrize("controld", [False, True], ids=["embedded", "controld"])
def test_straggler_weights_equal_reference(tmp_path, controld):
    """Member 2 reports 3x the step time: its share shrinks, and the
    control plane's weights are the reference's to the bit."""
    jtr, ttr = _trainers(tmp_path, ingest=False, controld=controld, slow=2)
    jtr.run(12, batch=4, seq=16)
    ttr.run(12, batch=4, seq=16)
    assert ttr.cp.weights == jtr.cp.weights
    counts = calendar_counts(_calendar(ttr), 4)
    np.testing.assert_array_equal(counts, calendar_counts(_calendar(jtr), 4))
    assert counts[2] < counts[0]


def test_checkpoint_resume_is_exact(tmp_path):
    """A fresh trainer (another seed) restores the latest checkpoint and
    holds the saved params bit for bit."""
    _, tr1 = _trainers(tmp_path, ingest=False, controld=False)
    tr1.run(10, batch=4, seq=16)
    want = [p.detach().clone() for p in leaves(tr1.state["params"])]
    cfg = get_smoke_config("yi_6b")
    tr2 = TTrainer(cfg, tr1.train_cfg, TTrainerConfig(ckpt_dir=str(tmp_path / "port"),
                                                      device="cpu"))
    assert tr2.init_or_restore(torch.Generator().manual_seed(1)) == 10
    for a, b in zip(want, leaves(tr2.state["params"])):
        assert torch.equal(a, b)
    assert int(tr2.state["step"]) == 10 and tr2.state["step"].shape == ()


# -- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("controld", [False, True], ids=["embedded", "controld"])
def test_launch_train_demo_prints_reference_lines(tmp_path, capsys, controld):
    """From one starting checkpoint (the reference's initial state), the two
    launchers print the same two lines: the first exactly, the losses of
    the second within 1e-4 (printed to 4 decimals)."""
    from repro.launch import train as j_launch

    cfg = get_smoke_config("yi_6b")
    st = JTS.init_train_state(jax.random.PRNGKey(0), cfg, JTS.TrainConfig())
    args = ["--arch", "yi-6b", "--demo", "--steps", "12", "--batch", "2", "--seq", "16"]
    args += ["--controld"] if controld else []
    lines = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        j_ckpt.save(d, 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
        if name == "ref":
            import sys
            argv = sys.argv
            sys.argv = ["train"] + args + ["--ckpt-dir", d]
            try:
                j_launch.main()
            finally:
                sys.argv = argv
        else:
            tr = t_launch.main(args + ["--ckpt-dir", d, "--device", "cpu"])
            assert not tr.train_cfg.lb_ingest and tr.device.type == "cpu"
        lines[name] = capsys.readouterr().out.splitlines()
    assert len(lines["port"]) == 2 and lines["port"][0] == lines["ref"][0]
    head = lambda s: s.split(" loss ")[0]
    nums = lambda s: [float(x) for x in s.split(" loss ")[1].split(" -> ")]
    assert head(lines["port"][1]) == head(lines["ref"][1]) == "steps=12"
    np.testing.assert_allclose(nums(lines["port"][1]), nums(lines["ref"][1]), atol=1.01e-4)


def test_launch_train_lb_ingest_routes_every_step(tmp_path, capsys):
    tr = t_launch.main(["--arch", "yi-6b", "--demo", "--steps", "3", "--batch", "8", "--seq",
                        "8", "--lb-ingest", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=yi-smoke params=0.1M resume_step=0")
    assert tr.train_cfg.lb_ingest and len(tr.history) == 3
    assert all(h["ingest_occupancy"] == 0.25 for h in tr.history)


def test_checkpoint_dirs_default_to_the_ports_own_under_tmpdir(tmp_path, monkeypatch, capsys):
    """Neither default names a fixed path or the reference's directories:
    both lie under ``tempfile.gettempdir()`` ($TMPDIR), under the port's
    names, so a default run never resumes from the reference's checkpoints."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert TTrainerConfig().ckpt_dir == str(tmp_path / "repro_torch_ckpt")
    assert JTrainerConfig().ckpt_dir != TTrainerConfig().ckpt_dir
    tr = t_launch.main(["--arch", "yi-6b", "--demo", "--steps", "1", "--batch", "2", "--seq",
                        "8", "--device", "cpu"])
    capsys.readouterr()
    assert tr.cfg.ckpt_dir == str(tmp_path / "repro_torch_train_ckpt")


def test_launch_train_eight_bit_and_grad_compress(tmp_path, capsys):
    tr = t_launch.main(["--arch", "stablelm-3b", "--demo", "--steps", "2", "--batch", "2",
                        "--seq", "8", "--eight-bit", "--grad-compress", "--ckpt-dir",
                        str(tmp_path), "--device", "cpu"])
    capsys.readouterr()
    assert tr.state["opt"]["mu"]["head"]["m"]["q"].dtype == torch.int8
    assert tr.state["efb"] is not None and np.isfinite(tr.history[-1]["loss"])


def test_trainer_saves_its_steps_while_running(tmp_path):
    """ckpt_every=2 over 5 steps: steps 2 and 4 on disk, each the state of
    its own step (the async saver copies before the next step runs)."""
    _, tr = _trainers(tmp_path, ingest=False, controld=False)
    tr.cfg.ckpt_every = 2
    snaps = {}
    step_fn = tr.step_fn

    def recording(state, batch, tables):
        out = step_fn(state, batch, tables)
        snaps[int(out[0]["step"])] = [p.detach().clone() for p in leaves(out[0]["params"])]
        return out

    tr.step_fn = recording
    tr.run(5, batch=4, seq=16)
    from repro_torch.checkpoint import ckpt as t_ckpt

    for s in (2, 4):
        restored, step = t_ckpt.restore(str(tmp_path / "port"), tr._checkpointed(), step=s)
        assert step == s
        for a, b in zip(snaps[s], leaves(restored["params"])):
            assert torch.equal(a, b)
    shutil.rmtree(tmp_path / "port")
