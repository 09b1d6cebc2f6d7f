"""The port's training step over W data-parallel ranks (gloo, W = 1, 2, 4)
against the JAX package's.

Each case (an arch's smoke config × the default step, ``accum_steps=2``,
8-bit moments, ``grad_compress``) runs two steps with LB ingest on each
rank of one spawned world (``tests/torch_dp_worker.py``: one spawn per W
runs every case), params and moments placed by ``param_sharding`` and
split across the ranks. The oracle is the reference's eager
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
from repro.configs import get_smoke_config as j_smoke
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.models import model as JM
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import Mesh, param_sharding, placed_dims, shard_tree
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.tree import tree_map
from torch_dp_worker import STEPS, host
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
CASES = [f"{a}/{v}" for a in ARCHS for v in VARIANTS]


def _case(name: str) -> dict:
    arch, variant = name.split("/")
    cfg = j_smoke(arch).with_(**ARCHS[arch])
    rng = np.random.default_rng(len(name))
    from repro_torch.core.protocol import encode_headers

    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    batch = {"labels": labels, "headers": encode_headers(
        rng.integers(0, 1 << 40, B).astype(np.uint64),
        rng.integers(0, 1 << 16, B).astype(np.uint32))}
    if cfg.family == "audio":
        batch["embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = labels.copy()
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    return dict(arch=arch, cfg=ARCHS[arch], opts=VARIANTS[variant], batch=batch, params=params,
                weights=np.r_[4.0, rng.uniform(0.5, 2.0, DIST_MEMBERS - 1)])


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
    step = jax.jit(JTS.make_train_step(cfg, jt, AbstractMesh((world,), ("data",)), B))
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
        saved = None
        if world == 2:
            saved = _one_process_ckpt_state(cases["yi_6b/default"])
            ckpt.save(str(d / "ckpt_w1"), 7, saved)
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
            and k != f"{name}/n_split"}
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
    assert ckpt.restore_into(str(run["dir"] / "ckpt_w2"), like) == STEPS
    for k, v in host(like).items():
        np.testing.assert_array_equal(v, got[f"yi_6b/default/state1/{k}"], err_msg=k)
    for k, v in host(run["saved"]).items():  # the one-process save, restored at W = 2
        np.testing.assert_array_equal(got[f"restored_w1/{k}"], v, err_msg=k)


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


def test_a_spec_on_the_layer_list_is_refused():
    """At a tiny FSDP threshold an 8-bit row scale of Mixtral's norms
    (stacked [L, 1]) is placed on its layer dim: whole layers per rank,
    which the port's per-layer list cannot hold; the placement refuses it."""
    cfg = get_smoke_config("mixtral_8x22b")
    params = TM.init_params(cfg, None, "meta")
    opt = TO.init(params, TO.AdamWConfig(eight_bit=True))
    mesh = Mesh(("data",), (2,))
    specs = param_sharding(opt, mesh, cfg, min_fsdp_size=1)
    assert specs["mu"]["layers"]["ln1"]["m"]["s"] == ("data", None)
    with pytest.raises(NotImplementedError, match="whole layers per rank"):
        placed_dims(opt, specs, mesh)
    with pytest.raises(NotImplementedError, match="whole layers per rank"):
        shard_tree(opt, specs, mesh)


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
