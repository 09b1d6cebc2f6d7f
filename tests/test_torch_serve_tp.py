"""The placed serving step (``launch/serve_step.py``): prefill and decode
over (data, model) gloo ranks against the one-process step, and the
one-process step against the JAX package's.

Each case (a family's smoke config, at ``B`` rows of a ``T``-token prompt
then ``STEPS`` decode steps of given tokens) runs on every rank of a
spawned world (``tests/torch_serve_worker.py``; one spawn per world size,
each rank runs all its cases): (1, 2) and (2, 1) in a world of 2, (2, 2) in
a world of 4. The params and the decode state are placed by
``serve_step.placement``; the logits of every row and the decode state,
gathered whole, are held to the one-process ``model.prefill`` and
``decode_step`` of the port on the whole batch, and those to the
reference's on the same numpy-seeded weights (``params_from_numpy``).

Layouts: the dense, moe (baseline and ``moegroup``), hybrid, ssm and vlm
families at every mesh; GQA with one KV head (the cache whole over
"model", each rank reading its q heads' KV head); ``widetp`` for every
family and ``seqpar`` for the dense, moe and vlm families at (2, 2);
``long_500k``'s layout at small size: a batch of one, the cache's sequence
split over 2 data ranks, the decode tokens landing on each rank's slots in
turn (dense, moe's sliding window past its wrap, hybrid).

Tolerance: 2e-4 (rtol and atol) on logits and states, float32 smoke
configs: the ranks add their partial sums (row products, the merged
softmax of a sequence-split decode) in other orders than one process.
"""
import json
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

from repro.analysis import roofline as RR
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro_torch.analysis import roofline as TR
from repro_torch.distributed.sharding import Mesh, gather_tree, param_sharding, placed_dims
from repro_torch.launch import shardspecs
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from torch_serve_worker import case_config, host_state

ROOT = Path(__file__).resolve().parents[1]
#: each world's spawn is waited for this long at most
JOIN_TIMEOUT_S = 240
TOL = dict(rtol=2e-4, atol=2e-4)
B, T, STEPS, MAX_LEN = 4, 8, 3, 16
ALL = ((1, 2), (2, 1), (2, 2))
FAMILIES = {"yi_6b": "dense", "mixtral_8x22b": "moe", "zamba2_2_7b": "hybrid",
            "rwkv6_7b": "ssm", "llama_3_2_vision_90b": "vlm"}
#: name -> (arch, config overrides, layout, meshes, (batch, prompt, cache length))
CASES = {a: (a, {}, {}, ALL, (B, T, MAX_LEN)) for a in FAMILIES}
CASES.update({
    "mixtral_8x22b/moegroup": ("mixtral_8x22b", {}, {"moegroup": True}, ALL, (B, T, MAX_LEN)),
    "yi_6b/mqa": ("yi_6b", {"n_kv_heads": 1}, {}, ((1, 2), (2, 2)), (B, T, MAX_LEN)),
    **{f"{a}/widetp": (a, {}, {"wide": True}, ((2, 2),), (B, T, MAX_LEN)) for a in FAMILIES},
    **{f"{a}/seqpar": (a, {}, {"seqpar": True}, ((2, 2),), (B, T, MAX_LEN))
       for a in ("yi_6b", "mixtral_8x22b", "llama_3_2_vision_90b")},
    # a batch of one: the cache's 16 slots split 8 and 8 over the data ranks
    "yi_6b/long": ("yi_6b", {}, {}, ((2, 1), (2, 2)), (1, 7, 16)),
    # the 16-slot window ring: tokens 14 and 15 on rank 1, 16 wraps to rank 0
    "mixtral_8x22b/long": ("mixtral_8x22b", {}, {}, ((2, 1), (2, 2)), (1, 14, 32)),
    "zamba2_2_7b/long": ("zamba2_2_7b", {}, {}, ((2, 1),), (1, 7, 16)),
})
RUNS = [f"{name}@{d}x{m}" for name, c in CASES.items() for d, m in c[3]]
LONG = [r for r in RUNS if "/long@" in r]


def _case(name: str) -> dict:
    arch, over, layout, meshes, (b, t, max_len) = CASES[name]
    cfg = j_smoke(arch).with_(**over)
    rng = np.random.default_rng(len(arch) * 100 + b * 10 + t)
    case = dict(arch=arch, cfg=over, meshes=list(meshes), max_len=max_len, **layout,
                prompt=rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
                decode=list(rng.integers(0, cfg.vocab, (STEPS, b)).astype(np.int32)),
                params=jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg)))
    if cfg.family == "vlm":
        case["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return case


def _one_process(case: dict, data_ranks: int) -> dict:
    """The port's prefill and decode steps on the whole batch in one
    process: the logits of each step and the final state."""
    cfg = case_config(case, data_ranks)
    params = TM.params_from_numpy(case["params"], cfg, "cpu")
    state = TM.init_decode_state(cfg, len(case["prompt"]), case["max_len"], "cpu")
    batch = {"tokens": torch.from_numpy(case["prompt"])}
    if "vision" in case:
        batch["vision_embeds"] = torch.from_numpy(case["vision"])
    kw = dict(q_chunk=8, k_chunk=8)
    with torch.no_grad():
        logits, state = TM.prefill(params, batch, state, cfg, **kw)
        out = {"logits0": logits.numpy()}
        for s, tok in enumerate(case["decode"]):
            logits, state = TM.decode_step(params, torch.from_numpy(tok), state, cfg, **kw)
            out[f"logits{s + 1}"] = logits.numpy()
    out.update({f"state/{k}": v for k, v in host_state(state).items()})
    return out


def _reference(case: dict, data_ranks: int) -> dict:
    """The reference's prefill and decode steps: the logits of each."""
    cfg = j_smoke(case["arch"]).with_(**case["cfg"])
    if case.get("moegroup"):
        cfg = cfg.with_(moe_dispatch_groups=data_ranks)
    params = jax.tree.map(jnp.asarray, case["params"])
    state = JM.init_decode_state(cfg, len(case["prompt"]), case["max_len"])
    batch = {"tokens": jnp.asarray(case["prompt"])}
    if "vision" in case:
        batch["vision_embeds"] = jnp.asarray(case["vision"])
    logits, state = JM.prefill(params, batch, state, cfg, q_chunk=8, k_chunk=8)
    out = {"logits0": np.asarray(logits)}
    for s, tok in enumerate(case["decode"]):
        logits, state = JM.decode_step(params, jnp.asarray(tok), state, cfg, q_chunk=8,
                                       k_chunk=8)
        out[f"logits{s + 1}"] = np.asarray(logits)
    return out


def _spawn(world: int, out_dir: Path) -> list:
    env = {"PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "PATH": os.environ["PATH"], "HOME": str(out_dir), "TMPDIR": str(out_dir),
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_serve_worker.py"), str(r), str(world),
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


def _key(name: str, data_ranks: int) -> tuple:
    """The one-process computation a run is held to: the moegroup cases'
    config depends on the data extent."""
    return (name, data_ranks if CASES[name][2].get("moegroup") else 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results of both worlds; per key the one-process port's
    steps and the reference's."""
    cases = {name: _case(name) for name in CASES}
    dirs = {}
    procs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"serve{world}")
        (d / "cases.pkl").write_bytes(pickle.dumps(cases))
        dirs[world], procs[world] = d, _spawn(world, d)
    keys = {_key(r.split("@")[0], int(r.split("@")[1][0])) for r in RUNS}
    port = {k: _one_process(cases[k[0]], k[1]) for k in keys}
    ref = {k: _reference(cases[k[0]], k[1]) for k in keys
           if not any(t in k[0] for t in ("/widetp", "/seqpar"))}  # their config is the base's
    ranks = {world: _join(procs[world], dirs[world]) for world in (2, 4)}
    return {"ranks": ranks, "port": port, "ref": ref, "cases": cases}


@pytest.mark.parametrize("key", sorted({_key(r.split("@")[0], int(r.split("@")[1][0]))
                                        for r in RUNS if "/widetp" not in r
                                        and "/seqpar" not in r}))
def test_one_process_step_equals_reference(served, key):
    port, ref = served["port"][key], served["ref"][key]
    for s in range(STEPS + 1):
        np.testing.assert_allclose(port[f"logits{s}"], ref[f"logits{s}"], err_msg=f"step {s}",
                                   **TOL)


@pytest.mark.parametrize("run", RUNS)
def test_placed_step_equals_one_process(served, run):
    name, dm = run.split("@")
    d, m = int(dm[0]), int(dm[2])
    port = served["port"][_key(name, d)]
    got = served["ranks"][d * m][0]
    for s in range(STEPS + 1):
        np.testing.assert_allclose(got[f"{run}/logits{s}"], port[f"logits{s}"],
                                   err_msg=f"{run} step {s}", **TOL)
    states = {k[len(run) + 7:]: v for k, v in got.items() if k.startswith(f"{run}/state/")}
    assert states.keys() == {k[6:] for k in port if k.startswith("state/")}
    for k, v in states.items():
        np.testing.assert_allclose(v, port[f"state/{k}"], err_msg=f"{run} {k}", **TOL)
    for rank in served["ranks"][d * m][1:]:  # every rank gathered the same
        np.testing.assert_array_equal(rank[f"{run}/logits{STEPS}"], got[f"{run}/logits{STEPS}"])


@pytest.mark.parametrize("run", LONG)
def test_sequence_split_decode_lands_on_each_rank_in_turn(served, run):
    """A batch of one: the cache's slots split over 2 data ranks; each
    decode token is written by the one rank that holds its ring slot, and
    the decode merges the ranks' partial softmaxes (all-reduces)."""
    name, dm = run.split("@")
    d, m = int(dm[0]), int(dm[2])
    case = served["cases"][name]
    ranks = served["ranks"][d * m]
    cfg = case_config(case)
    ring = min(case["max_len"], cfg.swa_window or case["max_len"])
    t = case["prompt"].shape[1]
    owners = [((t + s) % ring) // (ring // d) for s in range(STEPS)]
    assert len(set(owners)) == 2  # the steps visit both ranks' slots
    for r, res in enumerate(ranks):
        data_rank = r // m
        for s in range(STEPS):
            assert bool(res[f"{run}/wrote{s + 1}"]) == (owners[s] == data_rank), (r, s)
        assert res[f"{run}/decode/all-reduce"] >= 2  # the max and the sums of the merge


def test_layouts_issue_their_collectives(served):
    """seqpar's prefill reduce-scatters the residual stream; widetp's
    products all-reduce over every rank; a (1, 2) step's collectives lie on
    the model group only, a (2, 1) dense step's on the data group only."""
    r4 = served["ranks"][4][0]
    for a in ("yi_6b", "mixtral_8x22b", "llama_3_2_vision_90b"):
        assert r4[f"{a}/seqpar@2x2/prefill/reduce-scatter"] > 0, a
        assert f"{a}@2x2/prefill/reduce-scatter" not in r4, a
    for a in FAMILIES:
        assert r4[f"{a}/widetp@2x2/prefill/all-reduce"] > 0, a
    r2 = served["ranks"][2][0]
    assert r2["yi_6b@1x2/prefill/all-reduce"] > 0
    assert "yi_6b@2x1/prefill/all-reduce" not in r2  # FSDP gathers; no TP sums
    assert r2["yi_6b@2x1/prefill/all-gather"] > 0


def test_wide_spec_is_cut_data_major_and_gathers_on_both_axes():
    """A ``wide_tp`` spec puts the data axes and "model" on one dim: rank
    (data d, model m) of a (2, 2) mesh keeps block ``2 d + m``; gathering it
    over the data axes alone is refused."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import shard_tree

    cfg = get_smoke_config("yi_6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with fake_world(4):
        mesh = make_debug_mesh(2, 2)
        specs = param_sharding(params, mesh, cfg, wide_tp=True, fsdp=False, min_fsdp_size=1)
        assert specs["embed"] == (("data", "model"), None)
        assert placed_dims(params, specs, mesh, "wide")["embed"] == 0
        assert placed_dims(params, specs, mesh, "data")["embed"] == 0
        block = shard_tree(params, specs, mesh)
        np.testing.assert_array_equal(block["embed"].numpy(), params["embed"][:64].numpy())
        with pytest.raises(NotImplementedError, match="both axes"):
            gather_tree(block, specs, mesh, axes=("data",))
    specs = param_sharding(params, Mesh(("data", "model"), (2, 2)), cfg, wide_tp=True,
                           fsdp=False)
    assert specs["layers"]["mlp"]["w_up"] == (None, None, ("data", "model"))


def test_placed_state_holds_recurrent_leaves_by_batch():
    """The state specs at (2, 2): a KV cache by batch (or, with a batch of
    one, by sequence) and by heads; Mamba2's and RWKV6's states by batch
    only, where the reference's split heads or features on "model"."""
    mesh = Mesh(("data", "model"), (2, 2))
    for arch, b in (("zamba2_2_7b", 4), ("zamba2_2_7b", 1), ("rwkv6_7b", 4)):
        cfg = case_config({"arch": arch, "cfg": {}})
        state = TM.init_decode_state(cfg, b, 16, "meta")
        specs = shardspecs.placed_state_shardings(cfg, mesh, state)
        on = "data" if b > 1 else None
        if cfg.family == "hybrid":
            assert specs["kv"]["k"] == ((None, "data", None, "model", None) if b > 1
                                        else (None, None, "data", "model", None))
            assert specs["ssm"]["h"] == (None, None, on, None, None, None)
            assert specs["ssm"]["conv"] == (None, None, on, None, None)
        else:
            assert specs["wkv"] == (None, on, None, None, None)
            assert specs["tshift"] == specs["cshift"] == (None, on, None)
            assert shardspecs.decode_state_shardings(cfg, mesh, state)["tshift"] == (
                None, "data", "model")


def test_dry_run_serving_cells_on_a_sharded_mesh():
    """The prefill, decode and long_500k cells of the smoke configs on
    ``make_production_mesh()`` (16 x 16) as rank 0 of a fake 256-rank
    world, with the serving variants (Yi: baseline, seqpar, widetp;
    Mixtral: moegroup): each records collectives, its params placed as the
    variant says, and both packages' ``analyze`` read it."""
    code = (
        "import json\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch import dryrun as D\n"
        "arts = []\n"
        "with D.fake_world(256):\n"
        "    for arch, v in (('yi_6b', 'baseline'), ('yi_6b', 'seqpar'),\n"
        "                    ('yi_6b', 'widetp'), ('mixtral_8x22b', 'moegroup')):\n"
        "        for shape in ('prefill_32k', 'decode_32k', 'long_500k'):\n"
        "            arts.append(D.lower_cell(arch, shape, v, mesh='single',\n"
        "                                     cfg=get_smoke_config(arch)))\n"
        "print(json.dumps(arts))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    arts = json.loads(res.stdout.splitlines()[-1])
    done = [a for a in arts if "skipped" not in a]
    assert [(a["arch"], a["shape"]) for a in arts if "skipped" in a] == [
        ("yi_6b", "long_500k")] * 3
    assert len(done) == 9
    for art in done:
        assert (art["chips"], art["dp"], art["tp"]) == (256, 16, 16)
        col = art["collectives"]
        assert col["total_wire_bytes"] > 0 and col["ops"] == {
            k: int(v) for k, v in col["dynamic_ops"].items()}
        assert art["memory"]["argument_size_in_bytes"] > 0 and art["cost"]["flops"] > 0
        for analyze in (RR.analyze, TR.analyze):
            r = analyze(art)
            assert r.chips == 256 and r.wire_bytes_per_device > 0 and r.collective_s > 0
        assert art["rows_split"] == (art["shape"] != "long_500k")
        assert (art["param_leaves_split"]["wide"] > 0) == (art["variant"] == "widetp")
    seq = {a["shape"]: a for a in done if a["variant"] == "seqpar"}
    assert seq["prefill_32k"]["collectives"]["ops"].get("reduce-scatter", 0) > 0
    assert "reduce-scatter" not in seq["decode_32k"]["collectives"]["ops"]
