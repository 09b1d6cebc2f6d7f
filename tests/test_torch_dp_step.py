"""The port's training step over W data-parallel ranks (gloo, W = 1, 2, 4)
against the JAX package's.

Each case (an arch's smoke config × the default step, ``accum_steps=2``,
8-bit moments, ``grad_compress``; and ``EXTRA``'s: three microbatches that
straddle the ranks' rows, Mixtral's dispatch groups that span ranks, an
8-bit state placed at ``min_fsdp_size`` 1, whose norm scales lie on the
layer list) runs two steps with LB ingest on each rank of one spawned world
(``tests/torch_dp_worker.py``: one spawn per W runs every case), params and
moments placed by ``param_sharding`` and split across the ranks. The same
worlds run one MoE layer over unequal rows of one slot (``MOE_LAYOUTS``,
against the reference's layer) and, at W = 2, a round trip of a state
placed on the layer list. The oracle is the reference's eager
``make_train_step`` with ``AbstractMesh((W,), ("data",))`` on the
concatenated batch: under GSPMD its sharded step computes that function,
and its own multi-device tests fail in this environment
(``tests/test_distributed.py::TestMultiDevice``).

Each step is held against the reference's step from the same state: the
first from the initial state, the second from the port's own state after
the first (gathered, fed to the reference's step), so that an int8 value
that rounds the other way in one step is not carried into the next.

Tolerances (float32 smoke configs; XLA and PyTorch sum in other orders, and
the ranks' shares add in rank order):
  * loss, ce, z-loss, aux loss, grad norm, lr of both steps (the second
    from the reference's own first step): rtol 1e-5;
  * ``ingest_occupancy``, the steps and the moments' count: exact;
  * the gathered params, moments and error-feedback residual after each
    step: rtol 1e-5, atol 1e-6 in float32 (an 8-bit moment's row scales
    too), but for the elements below, each held to its own bound:
      - a param whose gradient is tiny (float32 moments: the reference's
        sqrt(v) after the step under ``TINY_GRAD`` of its leaf's largest):
        Adam's ratio m/sqrt(v) is then a ratio of reassociation-sized
        numbers. With b1 0.9 and b2 0.95 the ratio stays within +-1.0004,
        so the param stays within ``ADAM_STEP`` lr of the reference's;
      - a param whose int8 gradient (``grad_compress``) rounds the other
        way (below): the same bound;
      - a param that the reference moves by more than ``ADAM_STEP`` lr:
        only an 8-bit v that dequantizes to 0 lets the ratio past 1.0004,
        and it then grows as 1/|g|, so the reassociation difference of a
        small gradient moves it in proportion. The param stays within
        ``UPDATE_RTOL`` of the reference's own update: an element left
        where it was, or moved the other way, fails;
      - with ``grad_compress``, the error-feedback residual: it holds the
        gradient's float32 difference in full, so it is held to
        ``EFB_SHARE`` of its leaf's largest residual; where the gradient's
        int8 value rounds the other way (at most 1 in 1000 elements of a
        leaf, none in a leaf of fewer), the two residuals sit at opposite
        halves of an int8 step instead, and the element's first moment
        then differs by (1 - b1) times that step;
  * an 8-bit moment's int8 values: within 1 of the reference's, and
    different in at most 1 in 1000 elements of a leaf (none in a leaf of
    fewer): a value within float32 reassociation of a rounding half.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core as jcore
from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as JMOE
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.models import model as JM
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import Mesh, param_sharding
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.tree import tree_map
from torch_dp_worker import STEPS, host
from test_torch_moe import LAYER_TOL, _moe_params
from torch_helpers import DIST_MEMBERS, dist_program

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 300
WORLDS = (1, 2, 4)
METRIC_TOL = dict(rtol=1e-5, atol=0)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
#: a gradient under this share of its leaf's largest is tiny (sqrt(v);
#: seen up to 4.1e-7)
TINY_GRAD = 1e-4
#: the most one step's Adam ratio can move a param with float32 moments,
#: in lr: twice the ratio's bound of 1.0004
ADAM_STEP = 2.001
#: a param whose update is wider than that (an 8-bit v of 0): the share of
#: the reference's own update that it may miss by (seen up to 0.10)
UPDATE_RTOL = 0.25
#: ``grad_compress``'s residual carries the gradient's float32 difference
#: in full: within this share of its leaf's largest residual (half its
#: largest int8 step; seen up to 1.3e-3)
EFB_SHARE = 1e-2
B1 = 0.9
B, T = 8, 8

#: arch -> config overrides: Mixtral's capacity is cut so that its experts
#: drop packets (at most 68 and 36 slots for 128 and 64 assignments)
ARCHS = {"yi_6b": {}, "mixtral_8x22b": {"capacity_factor": 0.5}, "rwkv6_7b": {},
         "hubert_xlarge": {}}
VARIANTS = {"default": {}, "accum": {"accum_steps": 2}, "eight_bit": {"eight_bit": True},
            "compress": {"grad_compress": True}}
#: further cases: name -> (step options, config overrides beside ARCHS',
#: global batch rows). Three microbatches of 4 of 12 rows straddle the
#: ranks' rows at W = 2 and 4 (none are dropped); Mixtral's 3 dispatch
#: groups of 32 tokens span ranks and cut within them, and so do 2 groups
#: of a microbatch at W = 4; at ``min_fsdp`` 1 its 8-bit norm scales
#: ``[L, 1]`` lie on the layer dim at W = 2 (whole layers per rank). That
#: case keeps the config's capacity factor: at 0.5 every expert is full,
#: the aux loss's gradient is 0 up to reassociation noise, and an embedding
#: row that only it reaches holds that noise in int8 under the scale's
#: floor of 1e-12, where no rule of int8 rounding holds (both packages').
#: ``accum3_groups3``: 3 groups do not divide a microbatch's 32 tokens, so
#: the layer takes one (the reference's rule), on every rank of a round,
#: those that hold none of it too (W = 4: ranks 0 and 3 in the second)
EXTRA = {"yi_6b/accum3": ({"accum_steps": 3}, {}, 12),
         "mixtral_8x22b/groups3": ({}, {"moe_dispatch_groups": 3}, 12),
         "mixtral_8x22b/accum3": ({"accum_steps": 3}, {"moe_dispatch_groups": 2}, 12),
         "mixtral_8x22b/accum3_groups3": ({"accum_steps": 3}, {"moe_dispatch_groups": 3}, 12),
         "mixtral_8x22b/eight_bit_fsdp1": ({"eight_bit": True, "min_fsdp": 1, "layer_list": True},
                                           {"capacity_factor": 1.25}, B)}
CASES = [f"{a}/{v}" for a in ARCHS for v in VARIANTS] + list(EXTRA)
#: the cases whose stepped state W = 2 saves, and that restore the
#: one-process checkpoint the test writes (the port's, and the
#: reference's for the layer-placed state)
CKPT = ("yi_6b/default", "mixtral_8x22b/eight_bit_fsdp1")
#: MoE layer layouts over one slot of W ranks (each rank's rows of 8
#: tokens, the dispatch groups): groups that span ranks and cut within
#: them, a rank without rows, one group over the ranks, a group per rank
MOE_LAYOUTS = [((3, 5), 4), ((0, 4), 2), ((1, 3, 2, 2), 2), ((3, 0, 1, 4), 4),
               ((2, 2, 2, 2), 1), ((2, 2, 2, 2), 8)]


def _case(name: str) -> dict:
    arch, variant = name.split("/")
    opts, over, rows = EXTRA.get(name, (VARIANTS.get(variant), {}, B))
    over = {**ARCHS[arch], **over}
    cfg = j_smoke(arch).with_(**over)
    rng = np.random.default_rng(len(name))
    from repro_torch.core.protocol import encode_headers

    labels = rng.integers(0, cfg.vocab, (rows, T)).astype(np.int32)
    batch = {"labels": labels, "headers": encode_headers(
        rng.integers(0, 1 << 40, rows).astype(np.uint64),
        rng.integers(0, 1 << 16, rows).astype(np.uint32))}
    if cfg.family == "audio":
        batch["embeds"] = rng.standard_normal((rows, T, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = labels.copy()
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    return dict(arch=arch, cfg=over, opts=opts, batch=batch, params=params,
                weights=np.r_[4.0, rng.uniform(0.5, 2.0, DIST_MEMBERS - 1)],
                ckpt=(2, 1) if name in CKPT else None)


def _flat_state(state) -> dict:
    """The reference's state as ``torch_dp_worker.host`` flattens the port's."""
    parts = {k: state[k] for k in ("params", "opt", "efb") if state.get(k) is not None}
    out = {"/".join(str(p.key) for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(parts)[0]}
    out["step"] = np.asarray(state["step"])
    return out


def _reference(case: dict, world: int):
    """Two steps of the reference's step on the whole batch (its
    ``make_train_step``, compiled by ``jax.jit``): the metrics and the state
    after each step (``state<s>/...``), and a function that takes one more
    step from a flat state (the port's after its first step)."""
    cfg = j_smoke(case["arch"]).with_(**case["cfg"])
    o = case["opts"]
    jt = JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3, eight_bit=o.get("eight_bit", False)),
                         remat=True, lb_ingest=True, accum_steps=o.get("accum_steps", 1),
                         grad_compress=o.get("grad_compress", False), q_chunk=8, k_chunk=8)
    params = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": params, "opt": JO.init(params, jt.adamw), "efb": None,
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(JTS.make_train_step(cfg, jt, AbstractMesh((world,), ("data",)),
                                       len(case["batch"]["labels"])))
    tables = dist_program(jcore, case["weights"]).device_tables()
    batch = jax.tree.map(jnp.asarray, case["batch"])
    out = {}
    for s in range(STEPS):
        state, met = step(state, batch, tables)
        out.update({f"{s}/{k}": np.asarray(v) for k, v in met.items()})
        out.update({f"state{s}/{k}": v for k, v in _flat_state(state).items()})
    like = state

    def step_from(flat: dict) -> dict:
        parts = {k: like[k] for k in ("params", "opt", "efb") if like[k] is not None}
        paths, tdef = jax.tree_util.tree_flatten_with_path(parts)
        keys = ["/".join(str(p.key) for p in path) for path, _ in paths]
        start = dict(jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(flat[k], v.dtype) for k, (_, v) in zip(keys, paths)]))
        start = dict({"efb": None}, **start, step=jnp.asarray(flat["step"], jnp.int32))
        return _flat_state(step(start, batch, tables)[0])

    return out, step_from


def _spawn(world: int, out_dir: Path) -> list:
    """Start the ranks of one gloo world (``_join`` waits for them)."""
    env = {"PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}", "PATH": os.environ["PATH"],
           "HOME": str(out_dir), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_worker.py"), str(r), str(world),
         str(out_dir / "init"), str(out_dir)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs: list, out_dir: Path) -> list:
    try:
        outs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]


def _one_process_ckpt_state(case: dict) -> dict:
    """A one-process state unlike a fresh one: the params scaled, the
    moments drawn from a seed, step 7."""
    cfg = get_smoke_config(case["arch"])
    params = TM.params_from_numpy(jax.tree.map(lambda x: x * 1.5, case["params"]), cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    opt = TO.init(params, TO.AdamWConfig())
    opt["mu"] = tree_map(lambda x, stacked: torch.randn(x.shape, generator=gen), opt["mu"])
    return {"params": params, "opt": opt, "step": torch.tensor(7, dtype=torch.int32)}


def _reference_ckpt_state(case: dict) -> dict:
    """The reference's 8-bit state, unlike a fresh one: the params scaled,
    the int8 moments and their row scales drawn from a seed, step 7."""
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda x: jnp.asarray(x * 1.5), case["params"])
    opt = JO.init(params, JO.AdamWConfig(eight_bit=True))
    draw = lambda x: jnp.asarray(
        rng.integers(-127, 128, x.shape) if x.dtype == jnp.int8 else rng.uniform(0.5, 1.5, x.shape),
        x.dtype)
    return {"params": params, "opt": dict(opt, mu=jax.tree.map(draw, opt["mu"])),
            "step": jnp.asarray(7, jnp.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> the ranks' results, and per case the reference's two steps
    (``ref``), its step from the port's first (``resync``) and the initial
    params (``init``); and the one-process checkpoint that the W = 2 world
    restored."""
    cases = {name: _case(name) for name in CASES}
    out = {}
    for world in WORLDS:  # the worlds run while the references are computed
        d = tmp_path_factory.mktemp(f"dp{world}")
        (d / "cases.pkl").write_bytes(pickle.dumps(cases))
        (d / "moe_layers.pkl").write_bytes(pickle.dumps(_moe_layouts()))
        saved = {}
        if world == 2:
            saved = {"yi_6b/default": _one_process_ckpt_state(cases["yi_6b/default"]),
                     CKPT[1]: _reference_ckpt_state(cases[CKPT[1]])}
            ckpt.save(str(d / "ckpt_one_yi_6b_default"), 7, saved["yi_6b/default"])
            j_ckpt.save(str(d / f"ckpt_one_{CKPT[1].replace('/', '_')}"), 7, saved[CKPT[1]])
        out[world] = dict(procs=_spawn(world, d), dir=d, saved=saved)
    for world in WORLDS:
        out[world]["ref"] = {name: _reference(c, world) for name, c in cases.items()
                             if world > 1 or name.endswith("/default")}
    for world in WORLDS:
        run = out[world]
        run["ranks"] = _join(run["procs"], run["dir"])
        run["init"] = {name: _init(cases[name]) for name in run["ref"]}
        run["resync"] = {name: step_from(_states(run["ranks"][0], f"{name}/state0/"))
                         for name, (_, step_from) in run["ref"].items()}
        run["ref"] = {name: want for name, (want, _) in run["ref"].items()}
    return out


def _moe_layouts() -> list:
    """``MOE_LAYOUTS`` as ``torch_dp_worker.moe_layers`` takes them: each
    with the Mixtral smoke layer's numpy params (a router that skews the
    experts' loads) at capacity factor 0.5, and its tokens."""
    out = []
    for i, (rows_of, g) in enumerate(MOE_LAYOUTS):
        over = dict(capacity_factor=0.5, moe_dispatch_groups=g)
        cfg = j_smoke("mixtral_8x22b").with_(**over)
        x = np.random.default_rng(i).normal(size=(sum(rows_of), T, cfg.d_model))
        out.append(dict(rows_of=rows_of, cfg=over, params=_moe_params(cfg),
                        x=x.astype(np.float32)))
    return out


def _states(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _dequant(state: dict, path: str, moment: str) -> np.ndarray:
    """A param's moment (``m``/``v``) in float64, dequantized when 8-bit."""
    base = path.replace("params/", "opt/mu/", 1) + "/" + moment
    if base in state:
        return state[base].astype(np.float64)
    return state[base + "/q"].astype(np.float64) * state[base + "/s"]


def _check_state(got: dict, want: dict, start: dict, lr: float, what: str) -> None:
    """One step's state (flat) against the reference's step from ``start``
    by the module's rules."""
    assert sorted(got) == sorted(want), what
    tight = lambda g, w: np.abs(g - w) <= STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w)
    flipped = {}
    for k in sorted(want, key=lambda k: not k.startswith("efb/")):  # residuals first
        g, w = got[k], want[k]
        msg = f"{what} {k}"
        if k.endswith("/q"):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, msg
            assert int((g != w).sum()) <= w.size // 1000, msg
            continue
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=msg)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        off = ~tight(g, w)
        if k.startswith("efb/"):
            tol = STATE_TOL["atol"] + EFB_SHARE * np.abs(w).max()
            same = np.abs(g - w) <= tol
            flip = ~same & (np.abs(g + w) <= tol)  # opposite: rounded the other way
            assert (same | flip).all(), msg
            assert int(flip.sum()) <= w.size // 1000, msg
            flipped[k[len("efb/"):]] = np.where(flip, np.abs(g - w) + tol, 0.0)
        elif k.startswith("params/"):
            path = k[len("params/"):]
            update = np.abs(w - start[k])
            wide = update > ADAM_STEP * lr  # Adam's ratio past 1.0004: an 8-bit v of 0
            excused = wide | (flipped.get(path, 0) > 0)
            v = want.get(f"opt/mu/{path}/v")  # float32 moments
            if v is not None:
                excused |= np.sqrt(v) < TINY_GRAD * np.sqrt(v).max()
            assert not (off & ~excused).any(), msg
            bound = np.where(wide, UPDATE_RTOL * update, ADAM_STEP * lr)
            assert (np.abs(g - w)[off] <= bound[off]).all(), msg
        elif k.startswith("opt/mu/") and k.endswith("/m"):
            step = flipped.get(k[len("opt/mu/"):-len("/m")], np.zeros_like(w))
            bound = (1 - B1) * step + STATE_TOL["atol"]
            assert (np.abs(g - w)[off] <= bound[off]).all(), msg
        else:
            assert not off.any(), msg


def _check_case(got: dict, want: dict, resync: dict, name: str, init: dict) -> None:
    """The case's metrics of both steps against the reference's, its state
    after the first step against the reference's from ``init``, and after
    the second against the reference's step from the port's first
    (``resync``)."""
    for s in range(STEPS):
        keys = sorted(k.split("/")[-1] for k in got if k.startswith(f"{name}/{s}/"))
        assert keys == sorted(k.split("/")[-1] for k in want if k.startswith(f"{s}/"))
        for k in keys:
            g, w = got[f"{name}/{s}/{k}"], want[f"{s}/{k}"]
            if k == "ingest_occupancy":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, err_msg=f"{name} step {s} {k}", **METRIC_TOL)
    first = _states(got, f"{name}/state0/")
    _check_state(first, _states(want, "state0/"), init, float(want["0/lr"]), f"{name} step 0")
    _check_state(_states(got, f"{name}/state1/"), resync, first, float(want["1/lr"]),
                 f"{name} step 1")


def _init(case: dict) -> dict:
    """The case's initial params, flat as ``_flat_state`` gives them."""
    return _flat_state({"params": case["params"], "step": 0})


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_step_over_ranks_equals_single_program_step(runs, world, name):
    run = runs[world]
    ranks = run["ranks"]
    assert int(ranks[0][f"{name}/n_split"]) > 0  # some leaves are split across ranks
    _check_case(ranks[0], run["ref"][name], run["resync"][name], name, run["init"][name])
    for r in ranks[1:]:  # every rank reports the same metrics
        for k in ranks[0]:
            if k.startswith(f"{name}/") and "/state" not in k:
                np.testing.assert_array_equal(r[k], ranks[0][k])


@pytest.mark.parametrize("name", CASES)
def test_one_gloo_rank_equals_one_process_step_bit_for_bit(runs, name):
    got = runs[1]["ranks"][0]
    plain = {k[len(f"{name}/plain/"):]: v for k, v in got.items()
             if k.startswith(f"{name}/plain/")}
    mine = {k[len(f"{name}/"):]: v for k, v in got.items()
            if k.startswith(f"{name}/") and not k.startswith(f"{name}/plain/")
            and k not in (f"{name}/n_split", f"{name}/n_list")}
    assert sorted(plain) == sorted(mine)
    for k in mine:
        np.testing.assert_array_equal(mine[k], plain[k], err_msg=k)
    if name.endswith("/default"):
        _check_case(got, runs[1]["ref"][name], runs[1]["resync"][name], name,
                    runs[1]["init"][name])


def test_checkpoint_of_two_ranks_restores_in_one_process_and_back(runs):
    run = runs[2]
    got = run["ranks"][0]
    cfg = get_smoke_config("yi_6b")
    like = TS.init_train_state(torch.Generator().manual_seed(1), cfg, TS.TrainConfig(), "cpu")
    like = {"params": like["params"], "opt": like["opt"], "step": like["step"]}
    assert ckpt.restore_into(str(run["dir"] / "ckpt_placed_yi_6b_default"), like) == STEPS
    for k, v in host(like).items():
        np.testing.assert_array_equal(v, got[f"yi_6b/default/state1/{k}"], err_msg=k)
    for k, v in host(run["saved"]["yi_6b/default"]).items():  # the one-process save at W = 2
        np.testing.assert_array_equal(got[f"yi_6b/default/restored_one/{k}"], v, err_msg=k)


def test_checkpoint_of_a_layer_placed_state_restores_in_one_process_the_reference_and_back(
        runs):
    """Mixtral's 8-bit state at ``min_fsdp_size`` 1 over 2 ranks (norm row
    scales whole layers per rank) is saved whole after its steps: it
    restores bit for bit in one process of the port and in the reference;
    and the reference's save of such a state restores into the placed
    blocks."""
    run, name = runs[2], CKPT[1]
    got = run["ranks"][0]
    assert int(got[f"{name}/n_list"]) > 0  # the state lies on the layer list
    saved = str(run["dir"] / f"ckpt_placed_{name.replace('/', '_')}")
    tc = TS.TrainConfig(adamw=TO.AdamWConfig(eight_bit=True))
    like = TS.init_train_state(torch.Generator().manual_seed(1),
                               get_smoke_config("mixtral_8x22b"), tc, "cpu")
    like = {"params": like["params"], "opt": like["opt"], "step": like["step"]}
    assert ckpt.restore_into(saved, like) == STEPS
    for k, v in host(like).items():
        np.testing.assert_array_equal(v, got[f"{name}/state1/{k}"], err_msg=k)
    jlike = dict(_reference_ckpt_state(_case(name)))
    restored, step = j_ckpt.restore(saved, jlike)
    assert step == STEPS
    for k, v in _flat_state(restored).items():
        np.testing.assert_array_equal(v, got[f"{name}/state1/{k}"], err_msg=k)
    for k, v in _flat_state(run["saved"][name]).items():  # the reference's save, placed
        np.testing.assert_array_equal(got[f"{name}/restored_one/{k}"], v, err_msg=k)


@pytest.mark.parametrize("i", range(len(MOE_LAYOUTS)),
                         ids=[f"{'-'.join(map(str, r))}/g{g}" for r, g in MOE_LAYOUTS])
def test_moe_layer_over_ranks_equals_the_reference_layer(runs, i):
    """One MoE layer (Mixtral's smoke config, capacity factor 0.5) over one
    slot of W ranks holding ``rows_of`` rows each, against the reference's
    layer on their rows joined: the ranks' outputs joined and their aux
    losses summed within 1e-5, their drop counts summed exactly equal to
    the reference's (some dropped, but where a group's 16 packets may fit),
    and every ``dispatch_plan`` call equal to plain."""
    rows_of, g = MOE_LAYOUTS[i]
    lay = _moe_layouts()[i]
    ranks = runs[len(rows_of)]["ranks"]
    cfg = j_smoke("mixtral_8x22b").with_(**lay["cfg"])
    jy, jaux = JMOE.moe_ffn(jax.tree.map(jnp.asarray, lay["params"]), jnp.asarray(lay["x"]), cfg)
    y = np.concatenate([r[f"moe{i}/y"] for r in ranks])
    np.testing.assert_allclose(y, np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(sum(float(r[f"moe{i}/aux_loss"]) for r in ranks),
                               float(jaux["aux_loss"]), **LAYER_TOL)
    assert sum(int(r[f"moe{i}/dropped"]) for r in ranks) == int(jaux["dropped"])
    if sum(rows_of) * T // g > 8:  # a group of 8 tokens fits the capacity's floor of 8
        assert int(jaux["dropped"]) > 0
    for r, got in enumerate(ranks):
        assert got[f"moe{i}/plans_equal"].tolist() == [True], r


def test_model_extent_above_one_is_refused():
    """A model extent above 1 runs tensor-parallel over the mesh's model
    group (``tests/test_torch_tp_step.py``): a mesh not bound to its
    process groups is refused."""
    cfg = get_smoke_config("yi_6b")
    tc = TS.TrainConfig()
    for mesh in (Mesh(("data", "model"), (1, 2)), Mesh(("data", "model"), (2, 2))):
        with pytest.raises(ValueError, match="process group"):
            TS.jit_train_step(cfg, tc, mesh, TS.state_shapes(cfg, tc), global_batch=8)


def test_a_bound_group_needs_the_placement_specs():
    """Over a process group the step reduces onto this rank's slices, so it
    needs the specs that say where they lie (``jit_train_step`` makes them)."""
    cfg = get_smoke_config("yi_6b")
    with pytest.raises(ValueError, match="placement specs"):
        TS.make_train_step(cfg, TS.TrainConfig(), Mesh(("data", "model"), (1, 1), group=object()))


def test_jit_train_step_without_donation_leaves_the_state_as_it_was():
    """``donate=False`` steps a copy: the caller's state keeps its values,
    and the new state equals the donating step's bit for bit (one process,
    no process group: the specs place nothing)."""
    cfg = get_smoke_config("yi_6b")
    tc = TS.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3), lb_ingest=False, q_chunk=8, k_chunk=8)
    mesh = make_debug_mesh(1, 1)
    assert mesh.group is None
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    state = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    before = host(state)
    steps = {d: TS.jit_train_step(cfg, tc, mesh, TS.state_shapes(cfg, tc), global_batch=B,
                                  donate=d) for d in (False, True)}
    kept, kept_met = steps[False](state, batch, None)
    for k, v in host(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    donated, donated_met = steps[True](state, batch, None)
    assert donated["params"]["embed"] is state["params"]["embed"]  # updated in place
    assert not np.array_equal(host(state)["params/embed"], before["params/embed"])
    for k, v in host(kept).items():
        np.testing.assert_array_equal(v, host(donated)[k], err_msg=k)
    for k, v in kept_met.items():
        np.testing.assert_array_equal(v.numpy(), donated_met[k].numpy(), err_msg=k)


def test_mesh_binds_the_world_and_refuses_another_size(runs):
    for world in WORLDS:
        msg = str(runs[world]["ranks"][0]["other_world_refused"])
        assert f"needs {world + 1} ranks; the process group has {world}" in msg


def test_a_spec_on_the_layer_list_is_refused(runs):
    """At a tiny FSDP threshold the reference's rules place an 8-bit row
    scale of Mixtral's norms (stacked [L, 1]) on its layer dim: whole
    layers per rank, which the port now holds (no longer refused). Over 2
    gloo ranks ``shard_tree``'s block of it is the rank's layer (its
    ``placed_dims`` ``LIST``), and ``gather_tree`` gives back the whole
    state, every leaf bit for bit."""
    cfg = get_smoke_config("mixtral_8x22b")
    params = TM.init_params(cfg, None, "meta")
    opt = TO.init(params, TO.AdamWConfig(eight_bit=True))
    specs = param_sharding(opt, Mesh(("data",), (2,)), cfg, min_fsdp_size=1)
    assert specs["mu"]["layers"]["ln1"]["m"]["s"] == ("data", None)
    ranks = runs[2]["ranks"]
    for r, got in enumerate(ranks):
        assert got["layers/held"].tolist() == [r]  # L = 2 layers over 2 ranks
        assert got["layers/dims"].tolist() == [True, True]
        whole = got["layers/whole/mu/layers/ln1/m/s"]
        np.testing.assert_array_equal(got["layers/mine"], whole[r:r + 1])
        wholes = {k[len("layers/whole/"):] for k in got if k.startswith("layers/whole/")}
        assert wholes == {k[len("layers/back/"):] for k in got if k.startswith("layers/back/")}
        for k in wholes:
            np.testing.assert_array_equal(got[f"layers/back/{k}"], got[f"layers/whole/{k}"],
                                          err_msg=k)


def test_launcher_over_two_ranks_trains_checkpoints_and_resumes(tmp_path):
    """``launch.train`` under ``torch.distributed.run`` (2 gloo ranks; no LB
    ingest, as the reference launcher, so that the step is one function of
    the batch at any W): 20 steps write the step-20 checkpoint (rank 0
    alone prints); 2 more steps resume from it at W = 2 and, in one
    process, at W = 1, to the same losses (printed to 4 decimals; the two
    sum the ranks' shares in other orders)."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"], "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    common = ["-m", "repro_torch.launch.train", "--demo", "--batch", "8",
              "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    two = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]

    def run(cmd, steps):
        res = subprocess.run(cmd + common + ["--steps", str(steps)], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=JOIN_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-3000:]
        return [ln for ln in res.stdout.splitlines() if ln.startswith(("arch=", "steps="))]

    first = run(two, 20)
    assert len(first) == 2 and first[0].endswith("resume_step=0") and first[1].startswith(
        "steps=20 ")
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 20
    resumed_two = run(two, 2)
    resumed_one = run([sys.executable], 2)
    assert resumed_two[0].endswith("resume_step=20") and resumed_one[0].endswith(
        "resume_step=20")
    assert resumed_two[1] == resumed_one[1]
