"""The port's MoE family (``repro_torch.models.moe`` and the moe branches of
``models/model.py``) on the CPU against the JAX package's, from the same
numpy inputs and weights: ``moe_ffn`` with drops, dispatch groups and tied
router probabilities; the pack's positions; the Mixtral and Arctic smoke
models' ``train_loss`` and every gradient; one trainer step and a
checkpoint round trip on the moe tree.

float32 smoke configs compare at rtol/atol 1e-5 for a layer and 2e-4 for
logits, losses and gradients (float32 reassociation between XLA and
PyTorch, as ``tests/test_torch_models.py`` states); positions, keeps, drop
counts and expert choices are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_smoke_config
from repro.core.router import member_positions
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import _lib
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.tree import leaves, tree_map
from torch_helpers import to_np

MOE = ["mixtral_8x22b", "arctic_480b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
#: the capacity cases: the published factor, a tight one over 4 dispatch
#: groups, and a drop-free one
CASES = {"cf1.25": dict(capacity_factor=1.25),
         "cf0.5_g4": dict(capacity_factor=0.5, moe_dispatch_groups=4),
         "cf100": dict(capacity_factor=100.0)}


def _moe_params(cfg, seed=0, router_scale=0.5):
    """numpy weights of one MoE FFN (float32); a router of ``router_scale``
    skews the experts' loads enough for capacity to bind."""
    rng = np.random.default_rng(seed)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    nrm = lambda *s, scale: (rng.normal(size=s) * scale).astype(np.float32)
    p = {"router": nrm(d, e, scale=router_scale),
         "w_gate": nrm(e, d, ff, scale=0.15), "w_up": nrm(e, d, ff, scale=0.15),
         "w_down": nrm(e, ff, d, scale=0.1)}
    if cfg.moe_dense_residual:
        p["dense"] = {"w_gate": nrm(d, ff, scale=0.15), "w_up": nrm(d, ff, scale=0.15),
                      "w_down": nrm(ff, d, scale=0.1)}
    return p


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).normal(size=(b, t, cfg.d_model)).astype(np.float32)


def _both(p, x, cfg):
    """moe_ffn of both packages -> (port y, port aux, reference y, reference aux)."""
    jy, jaux = JMOE.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    ty, taux = TMOE.moe_ffn(_torch_tree(p), torch.from_numpy(x), cfg)
    return ty, taux, jy, jaux


def _assert_layer_equal(ty, taux, jy, jaux):
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(taux["aux_loss"]), float(jaux["aux_loss"]), **LAYER_TOL)
    assert int(taux["dropped"]) == int(jaux["dropped"])


# -- moe_ffn -------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_equals_reference(arch, case):
    """y and aux_loss within 1e-5, the drop count exact; cf 0.5 over 4
    groups must drop and cf 100 must not."""
    cfg = get_smoke_config(arch).with_(**CASES[case])
    ty, taux, jy, jaux = _both(_moe_params(cfg), _x(cfg, 4, 16), cfg)
    _assert_layer_equal(ty, taux, jy, jaux)
    if case == "cf0.5_g4":
        assert int(jaux["dropped"]) > 0
    if case == "cf100":
        assert int(jaux["dropped"]) == 0


def test_published_capacity_factor_drops_in_some_case():
    """At cf 1.25 (the configs' own) the skewed router overflows an expert
    in at least one arch, so the drop path is held, not only the free one."""
    drops = {}
    for arch in MOE:
        cfg = get_smoke_config(arch)
        ty, taux, jy, jaux = _both(_moe_params(cfg), _x(cfg, 4, 16), cfg)
        drops[arch] = (int(taux["dropped"]), int(jaux["dropped"]))
    assert all(a == b for a, b in drops.values()), drops
    assert any(a > 0 for a, _ in drops.values()), drops


def test_indivisible_group_count_falls_back_to_one_group():
    """30 tokens over 7 groups: both packages take one group."""
    cfg = get_smoke_config("mixtral_8x22b").with_(moe_dispatch_groups=7,
                                                  capacity_factor=0.5)
    ty, taux, jy, jaux = _both(_moe_params(cfg), _x(cfg, 2, 15), cfg)
    _assert_layer_equal(ty, taux, jy, jaux)
    one = TMOE.moe_ffn(_torch_tree(_moe_params(cfg)), torch.from_numpy(_x(cfg, 2, 15)),
                       cfg.with_(moe_dispatch_groups=1))
    assert torch.equal(one[0], ty) and int(one[1]["dropped"]) == int(taux["dropped"]) > 0


# -- ties ----------------------------------------------------------------------

def test_top_k_takes_lax_tie_order():
    """Equal probabilities: the lowest indices win, as in ``lax.top_k``,
    where ``torch.topk`` picks others (so it would route elsewhere)."""
    for probs in (np.full((3, 8), 0.125, np.float32),
                  np.array([[0.1, 0.3, 0.3, 0.3, 0, 0, 0, 0]], np.float32)):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
        tv, ti = TMOE.top_k(torch.from_numpy(probs), 2)
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
        assert not np.array_equal(torch.topk(torch.from_numpy(probs), 2).indices.numpy(),
                                  np.asarray(ji))


@pytest.mark.parametrize("arch", MOE)
def test_zero_router_ties_equal_reference(arch):
    """A zero router ties every expert for every token: both packages send
    all first choices to expert 0 and second choices to expert 1, and drop
    the same packets past capacity."""
    cfg = get_smoke_config(arch)
    p = _moe_params(cfg)
    p["router"] = np.zeros_like(p["router"])
    ty, taux, jy, jaux = _both(p, _x(cfg, 4, 16), cfg)
    _assert_layer_equal(ty, taux, jy, jaux)
    n, k, e = 64, cfg.top_k, cfg.n_experts
    cap = min(n * k, max(int(cfg.capacity_factor * n * k / e) + 1, 8))
    assert int(taux["dropped"]) == k * (n - cap) > 0


# -- the pack ------------------------------------------------------------------

@pytest.mark.parametrize("g,p,e,capacity", [(1, 128, 8, 40), (4, 48, 4, 9), (3, 20, 128, 8)])
def test_pack_positions_equal_member_positions(g, p, e, capacity):
    """The plain ``dispatch_plan`` over the members ``group * E + expert``
    gives each group's ``member_positions`` (pos and keep, exact)."""
    rng = np.random.default_rng(g * p)
    member_g = rng.integers(0, e, (g, p)).astype(np.int32)
    member_g[0, : p // 2] = 0  # one expert overflows
    _lib.reset_launches()
    pos = TMOE.pack_positions(torch.from_numpy(member_g), e)
    assert pos.dtype == torch.int32 and pos.shape == (g, p)
    assert _lib.LAUNCHES["dispatch_plan"] == 0  # a CPU tensor takes the plain version
    jpos, jkeep, _ = jax.vmap(lambda m: member_positions(m, e, capacity))(
        jnp.asarray(member_g))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal((pos < capacity).numpy(), np.asarray(jkeep))


# -- init ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_init_shapes_dtypes_and_scale(arch):
    """The reference's shapes; the router float32 in a bf16 tree; the
    expert stacks' fan-in is their first dim (E), as the reference's
    ``dense_init`` takes it."""
    cfg = get_smoke_config(arch).with_(dtype="bfloat16")
    p = TMOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    j = jax.tree.map(np.asarray, JMOE.moe_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16))
    assert sorted(p) == sorted(j)
    for name, w in p.items():
        if isinstance(w, dict):
            assert {k: tuple(v.shape) for k, v in w.items()} == \
                {k: v.shape for k, v in j[name].items()}
            continue
        assert tuple(w.shape) == j[name].shape
        assert w.dtype == (torch.float32 if name == "router" else torch.bfloat16)
        assert str(j[name].dtype) == ("float32" if name == "router" else "bfloat16")
    e = cfg.n_experts
    assert float(p["w_up"].float().abs().max()) <= 2.0 / e ** 0.5 + 1e-2
    assert float(p["w_up"].float().std()) > 0.5 / e ** 0.5
    assert float(p["router"].abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


def test_moe_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    cfg = get_smoke_config("mixtral_8x22b")
    with pytest.raises(RuntimeError, match="cuda"):
        TMOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)


# -- the models ----------------------------------------------------------------

def _cross(jp, cfg):
    return TM.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _batch(cfg, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    labels = toks.copy()
    labels[-1, 3:7] = -1
    return {"tokens": toks, "labels": labels}


def _stacked(port_tree):
    host = lambda t: t.detach().float().numpy()
    out = jax.tree.map(host, {k: v for k, v in port_tree.items() if k != "layers"})
    out["layers"] = jax.tree.map(lambda *xs: np.stack([host(x) for x in xs]),
                                 *port_tree["layers"])
    return out


@pytest.mark.parametrize("arch", MOE)
def test_forward_aux_equals_reference(arch):
    """Logits and the layers' summed aux loss, at the published capacity
    factor (drops included)."""
    cfg = get_smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg)
    want, jaux = JM.forward(jp, {"tokens": jnp.asarray(b["tokens"])}, cfg, remat=False,
                            q_chunk=8, k_chunk=8)
    got, aux = TM.forward(_cross(jp, cfg), {"tokens": torch.from_numpy(b["tokens"])}, cfg,
                          remat=False, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_train_loss_and_every_gradient_equal_reference(arch):
    """loss, ce, z_loss, moe_aux and the gradient of every leaf (the f32
    router's too), the port with remat, the reference without."""
    cfg = get_smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(p, {k: jnp.asarray(v) for k, v in b.items()}, cfg,
                                remat=False, q_chunk=8, k_chunk=8), has_aux=True)(jp)
    params = _cross(jp, cfg)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, met = TM.train_loss(params, {k: torch.from_numpy(v) for k, v in b.items()}, cfg,
                              remat=True, q_chunk=8, k_chunk=8)
    grads = iter(torch.autograd.grad(loss, ps))
    grads = tree_map(lambda p, stacked: next(grads), params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for k in ("ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(met[k].detach()), float(jm[k]), **TOL)
    assert float(met["moe_aux"].detach()) > 0
    gl, gd = jax.tree.flatten(_stacked(grads))
    wl, wd = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    assert gd == wd
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **TOL)
    assert float(grads["layers"][0]["moe"]["router"].abs().sum()) > 0


def test_trainer_steps_on_the_moe_tree_equal_reference(tmp_path):
    """The Mixtral smoke config: the port's trainer restores the
    reference's initial state from its checkpoint, and 3 steps give the
    reference's metrics (2e-4); the port's checkpoint of step 3 restores
    into a fresh trainer bit for bit."""
    cfg = get_smoke_config("mixtral_8x22b")
    adamw = dict(lr=1e-2, warmup_steps=2, decay_steps=100)
    kw = dict(remat=False, lb_ingest=False, q_chunk=8, k_chunk=8)
    tkw = dict(n_members=4, ckpt_every=3)
    jtr = JTrainer(cfg, JTS.TrainConfig(adamw=JO.AdamWConfig(**adamw), **kw),
                   JTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tkw),
                   mesh=jax.make_mesh((1,), ("data",)))
    jtr.init_or_restore(jax.random.PRNGKey(0))
    j_ckpt.save(str(tmp_path / "port"), 0, {"params": jtr.state["params"],
                                            "opt": jtr.state["opt"],
                                            "step": jtr.state["step"]})
    make = lambda: TTrainer(cfg, TTS.TrainConfig(adamw=TO.AdamWConfig(**adamw), **kw),
                            TTrainerConfig(ckpt_dir=str(tmp_path / "port"), device="cpu",
                                           **tkw), mesh=Mesh(("data",), (1,)))
    ttr = make()
    assert ttr.init_or_restore(torch.Generator().manual_seed(7)) == 0
    for tr in (jtr, ttr):
        orig = tr.hub.report_step
        tr.hub.report_step = lambda m, dt, _o=orig, **k: _o(m, 0.01 * (1 + 0.01 * m), **k)
    hj, ht = jtr.run(3, batch=4, seq=16), ttr.run(3, batch=4, seq=16)
    for a, b in zip(ht, hj):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    ttr.saver.wait()
    fresh = make()
    assert fresh.init_or_restore(torch.Generator().manual_seed(1)) == 3
    for a, b in zip(leaves(ttr.state["params"]), leaves(fresh.state["params"])):
        assert torch.equal(a, b)


def test_bf16_moe_tree_keeps_its_f32_router_through_update_and_checkpoint(tmp_path):
    """An AdamW step and a checkpoint round trip leave the router float32
    and every other leaf bfloat16; the restore is bit-exact."""
    cfg = get_smoke_config("arctic_480b").with_(dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = TO.init(params, TO.AdamWConfig())
    grads = tree_map(lambda p, stacked: torch.ones_like(p), params)
    params, state, _ = TO.update(grads, state, params, TO.AdamWConfig(lr=1e-2,
                                                                      warmup_steps=1))
    router = params["layers"][1]["moe"]["router"]
    assert router.dtype == torch.float32
    assert params["layers"][1]["moe"]["w_down"].dtype == torch.bfloat16
    t_ckpt.save(str(tmp_path), 1, {"params": params})
    back, step = t_ckpt.restore(str(tmp_path), {"params": params})
    assert step == 1
    for a, b in zip(leaves(params), leaves(back["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    j = j_ckpt.restore(str(tmp_path), {"params": jax.tree.map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))})[0]
    np.testing.assert_array_equal(np.asarray(j["params"]["layers"]["moe"]["router"][1]),
                                  router.numpy())
