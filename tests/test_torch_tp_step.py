"""The port's training step with tensor parallelism on the "model" axis
(gloo, one world of 4 ranks, meshes (2, 2) and (1, 4)) against the JAX
package's.

Each case (the smoke config of each family at the default step, and Yi's
with ``accum_steps=2`` and 3 and with 8-bit moments) runs two steps with LB
ingest on every rank of one spawned world (``tests/torch_dp_worker.py``
runs every case on each of its meshes), params placed by ``param_sharding``
on both axes and each moment as its param. The oracle is the reference's
``make_train_step`` with ``AbstractMesh((data, model), ("data", "model"))``
on the concatenated batch: under GSPMD its sharded step computes that
function. The rules and tolerances are ``tests/test_torch_dp_step.py``'s
(``_check_case``).

Each step also runs under ``analysis.collectives.CollectiveRecord``: the
record's counts equal ``distributed.dp.COUNTS`` (every collective of the
step goes through ``dp``, and a group of one issues none), and at (1, 4)
Yi's dense step issues exactly the model-group collectives that
``distributed/tp.py``'s pattern gives (``dense_counts``).

A ``seqpar`` case (the residual stream split by sequence over "model",
Megatron's sequence parallelism) takes its base case's config, batch and
mesh, and so its reference run: the reference's seqpar is a placement of
the same function, so the oracle is the same step.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.core as jcore
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.configs import get_smoke_config
from repro_torch.core.protocol import encode_headers
from test_torch_dp_step import _check_case, _flat_state, _init, _join, _spawn, _states
from torch_dp_worker import STEPS
from torch_helpers import DIST_MEMBERS, dist_program

WORLD = 4
B, T = 8, 8
MESHES = ((2, 2), (1, 4))
#: arch -> config overrides (Mixtral's capacity is cut so that its experts
#: drop packets, as in tests/test_torch_dp_step.py)
ARCHS = {"yi_6b": {}, "mixtral_8x22b": {"capacity_factor": 0.5},
         "llama_3_2_vision_90b": {}, "hubert_xlarge": {}, "zamba2_2_7b": {}, "rwkv6_7b": {}}
#: name -> (step options, meshes, config overrides beside ARCHS')
CASES = {f"{a}/default": ({}, MESHES, {}) for a in ARCHS}
CASES.update({"yi_6b/accum": ({"accum_steps": 2}, ((2, 2),), {}),
              # three microbatches of 4 of 12 rows: the middle one takes 2 rows
              # of each data rank (ROWS)
              "yi_6b/accum3": ({"accum_steps": 3}, ((2, 2),), {}),
              "yi_6b/eight_bit": ({"eight_bit": True}, ((2, 2),), {}),
              # 6 q heads over 4 ranks: the attention runs whole on every rank
              "yi_6b/odd_heads": ({}, ((1, 4),), {"n_heads": 6})})
#: seqpar case -> its base case, whose config, batch and reference run it
#: takes: each family at (1, 4), and Yi's accumulation at (2, 2)
SEQPAR = {f"{a}/seqpar": f"{a}/default" for a in ARCHS} | {"yi_6b/accum+seqpar": "yi_6b/accum"}
CASES.update({f"{a}/seqpar": ({"seqpar": True}, ((1, 4),), {}) for a in ARCHS})
CASES["yi_6b/accum+seqpar"] = ({"accum_steps": 2, "seqpar": True}, ((2, 2),), {})
#: a case's global batch rows, where not B
ROWS = {"yi_6b/accum3": 12}
RUNS = [(name, dm) for name, (_, meshes, _) in CASES.items() for dm in meshes]
SEQ_RUNS = [(name, dm) for name, dm in RUNS if name in SEQPAR]
#: the run whose stepped state is checkpointed and restored on its mesh
CKPT = ("yi_6b/eight_bit", (2, 2))


def _case(name: str) -> dict:
    arch, _variant = name.split("/")
    opts, meshes, over = CASES[name]
    over = {**ARCHS[arch], **over}
    cfg = j_smoke(arch).with_(**over)
    rng = np.random.default_rng(len(SEQPAR.get(name, name)))
    rows = ROWS.get(name, B)
    labels = rng.integers(0, cfg.vocab, (rows, T)).astype(np.int32)
    batch = {"labels": labels, "headers": encode_headers(
        rng.integers(0, 1 << 40, rows).astype(np.uint64),
        rng.integers(0, 1 << 16, rows).astype(np.uint32))}
    if cfg.family == "audio":
        batch["embeds"] = rng.standard_normal((rows, T, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = labels.copy()
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (rows, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    return dict(arch=arch, cfg=over, opts=opts, batch=batch, params=params,
                weights=np.r_[4.0, rng.uniform(0.5, 2.0, DIST_MEMBERS - 1)],
                meshes=list(meshes), ckpt=CKPT[1] if name == CKPT[0] else None)


def _reference(case: dict, dm: tuple):
    """Two steps of the reference's step on the whole batch over
    ``AbstractMesh(dm, ("data", "model"))``, and a function that takes one
    more step from a flat state (the port's after its first step)."""
    cfg = j_smoke(case["arch"]).with_(**case["cfg"])
    o = case["opts"]
    jt = JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3, eight_bit=o.get("eight_bit", False)),
                         remat=True, lb_ingest=True, accum_steps=o.get("accum_steps", 1),
                         q_chunk=8, k_chunk=8)
    params = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": params, "opt": JO.init(params, jt.adamw), "efb": None,
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(JTS.make_train_step(cfg, jt, AbstractMesh(dm, ("data", "model")),
                                       len(case["batch"]["labels"])))
    tables = dist_program(jcore, case["weights"]).device_tables()
    batch = jax.tree.map(jnp.asarray, case["batch"])
    out = {}
    for s in range(STEPS):
        state, met = step(state, batch, tables)
        out.update({f"{s}/{k}": np.asarray(v) for k, v in met.items()})
        out.update({f"state{s}/{k}": v for k, v in _flat_state(state).items()})

    def step_from(flat: dict) -> dict:
        parts = {k: state[k] for k in ("params", "opt") if state[k] is not None}
        paths, tdef = jax.tree_util.tree_flatten_with_path(parts)
        keys = ["/".join(str(p.key) for p in path) for path, _ in paths]
        start = dict(jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(flat[k], v.dtype) for k, (_, v) in zip(keys, paths)]))
        start = dict(start, efb=None, step=jnp.asarray(flat["step"], jnp.int32))
        return _flat_state(step(start, batch, tables)[0])

    return out, step_from


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results, and per run (case, mesh) the reference's two
    steps, its step from the port's first and the initial params."""
    cases = {name: _case(name) for name in CASES}
    d = tmp_path_factory.mktemp("tp")
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    procs = _spawn(WORLD, d)  # the world runs while the references are computed
    refs = {(name, dm): _reference(cases[name], dm) for name, dm in RUNS
            if name not in SEQPAR}
    ranks = _join(procs, d)
    out = {"ranks": ranks, "ref": {}, "resync": {}, "init": {}, "dir": d}
    for name, dm in RUNS:
        want, step_from = refs[(SEQPAR.get(name, name), dm)]
        tag = f"{name}@{dm[0]}x{dm[1]}"
        out["ref"][tag] = want
        out["resync"][tag] = step_from(_states(ranks[0], f"{tag}/state0/"))
        out["init"][tag] = _init(cases[name])
    return out


@pytest.mark.parametrize("name,dm", RUNS, ids=[f"{n}@{d}x{m}" for n, (d, m) in RUNS])
def test_tensor_parallel_step_equals_single_program_step(world, name, dm):
    tag = f"{name}@{dm[0]}x{dm[1]}"
    ranks = world["ranks"]
    _check_case(ranks[0], world["ref"][tag], world["resync"][tag], tag, world["init"][tag])
    for r in ranks[1:]:  # every rank reports the same metrics and collectives
        for k in ranks[0]:
            if k.startswith(f"{tag}/") and "/state" not in k:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    for r, got in enumerate(ranks):  # and holds the same whole state
        for k in got:
            if k.startswith(f"{tag}/state"):
                np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=f"rank {r} {k}")


def test_checkpoint_of_a_two_by_two_mesh_restores_in_one_process_and_back(world):
    """The (2, 2) state (params split on both axes, 8-bit moments as their
    params) is saved whole by the first rank, restores into one process
    and into fresh blocks on the same mesh, equal to the state it saved."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.train import optimizer as TO
    from repro_torch.train import train_step as TS
    from torch_dp_worker import host

    name, dm = CKPT
    tag = f"{name}@{dm[0]}x{dm[1]}"
    got = world["ranks"][0]
    cfg = get_smoke_config("yi_6b")
    tc = TS.TrainConfig(adamw=TO.AdamWConfig(eight_bit=True))
    like = TS.init_train_state(torch.Generator().manual_seed(1), cfg, tc, "cpu")
    like = {"params": like["params"], "opt": like["opt"], "step": like["step"]}
    assert ckpt.restore_into(str(world["dir"] / "ckpt_tp"), like) == STEPS
    for k, v in host(like).items():
        np.testing.assert_array_equal(v, got[f"{tag}/state1/{k}"], err_msg=k)
        for r in world["ranks"]:
            np.testing.assert_array_equal(r[f"{tag}/restored/{k}"], v, err_msg=k)


def _collectives(got: dict, tag: str, s: int, what: str) -> dict:
    pre = f"{tag}/collectives{s}/{what}/"
    return {k[len(pre):]: int(v) for k, v in got.items() if k.startswith(pre)}


@pytest.mark.parametrize("name,dm", RUNS, ids=[f"{n}@{d}x{m}" for n, (d, m) in RUNS])
def test_record_counts_every_collective_of_the_step(world, name, dm):
    tag = f"{name}@{dm[0]}x{dm[1]}"
    got = world["ranks"][0]
    for s in range(STEPS):
        rec = _collectives(got, tag, s, "record")
        assert rec == _collectives(got, tag, s, "counts"), (tag, s)
        assert rec.get("all-reduce", 0) > 0
        # the ingest's exchange over the data ranks (none with one)
        assert (rec.get("all-to-all", 0) > 0) == (dm[0] > 1)


def test_kv_heads_a_rank_reads():
    """The KV heads that a rank's q heads [lo, hi) read (``group`` q heads
    a KV head): each once where the q heads split evenly over them, one per
    q head where they do not."""
    from repro_torch.models.layers import _kv_heads

    assert _kv_heads(2, 4, 8) == [0]  # Yi-6B at 16: 2 q heads of one KV head
    assert _kv_heads(0, 2, 2) == [0] and _kv_heads(2, 4, 2) == [1]  # Yi's smoke at 2
    assert _kv_heads(0, 4, 2) == [0, 1]  # two KV heads, two q heads each
    assert _kv_heads(3, 6, 4) == [0, 1, 1]  # 3 q heads over KV heads 0, 1, 1


def dense_counts(cfg, tp: int) -> dict:
    """The model group's collectives of one step of a dense model (remat,
    no accumulation) on a (1, tp) mesh, as ``distributed/tp.py`` issues
    them. Per layer, under ``torch.utils.checkpoint`` (non-reentrant, which
    recomputes a block in the backward only as far as its last saved
    tensor):
      * forward: one ``all_reduce`` of the attention output and one of the
        MLP output; with KV split within a head, one ``all_gather`` each of
        ``wk`` and ``wv``;
      * the recompute in the backward: the same, but for the MLP output's
        ``all_reduce``: it and the residual add after it save nothing, so
        the recompute stops before them;
      * backward: one ``all_reduce`` of the attention input's gradient and
        one of the MLP input's; with KV split within a head, one
        ``reduce_scatter`` each of ``wk``'s and ``wv``'s gradient.
    Around the layers: the vocab-split embedding's ``all_reduce``; the
    head's input gradient's ``all_reduce``; the loss's max and its
    (sum-exp, label logit) statistics, an ``all_reduce`` each; the
    optimizer's global norm over the model ranks, one ``all_reduce``."""
    within_head = cfg.n_kv_heads % tp != 0
    gathers = 2 if within_head else 0
    per_layer = {"all-reduce": 2 + 1 + 2, "all-gather": 2 * gathers,
                 "reduce-scatter": gathers}
    out = {k: cfg.n_layers * v for k, v in per_layer.items() if v}
    out["all-reduce"] += 1 + 1 + 2 + 1
    return out


def test_dense_step_at_one_by_four_issues_the_tensor_parallel_pattern(world):
    cfg = get_smoke_config("yi_6b")
    assert cfg.n_kv_heads % 4 and cfg.n_kv_heads % 2 == 0  # within a head at 4, whole at 2
    for s in range(STEPS):
        got = _collectives(world["ranks"][0], "yi_6b/default@1x4", s, "record")
        assert got == dense_counts(cfg, 4), s


def test_whole_kv_heads_stay_local_at_two_model_ranks(world):
    """At (2, 2) Yi's 2 KV heads split whole over the 2 model ranks: no
    ``reduce_scatter`` (the within-head KV gather's backward) is issued."""
    for s in range(STEPS):
        got = _collectives(world["ranks"][0], "yi_6b/default@2x2", s, "record")
        assert "reduce-scatter" not in got


@pytest.mark.parametrize("name,dm", SEQ_RUNS, ids=[f"{n}@{d}x{m}" for n, (d, m) in SEQ_RUNS])
def test_seqpar_step_reduce_scatters_the_stream_on_the_model_group(world, name, dm):
    """Under seqpar the row products reduce-scatter the residual stream
    over the model ranks, and every block gathers it: reduce-scatters where
    the base case has few or none (the data ranks issue none: the ingest's
    exchange is an all-to-all, FSDP gathers, the gradients all-reduce), and
    no fewer all-gathers."""
    got = world["ranks"][0]
    base = f"{SEQPAR[name]}@{dm[0]}x{dm[1]}"
    for s in range(STEPS):
        seq = _collectives(got, f"{name}@{dm[0]}x{dm[1]}", s, "record")
        plain = _collectives(got, base, s, "record")
        assert seq.get("reduce-scatter", 0) > plain.get("reduce-scatter", 0), (name, s, seq)
        assert seq.get("all-gather", 0) >= plain.get("all-gather", 0), (name, s, seq)


def test_sequence_collectives_give_the_unsplit_gradients(world):
    """``TP.full`` (all_gather; backward reduce_scatter), ``TP.exit`` under
    ``seq`` (reduce_scatter; backward all_gather) and ``TP.whole`` under
    ``seq`` (backward: the ranks' shares reduce-scattered) on a two-rank
    gloo model group: each rank's gradients of its tokens and of its
    slices equal the unsplit computation's, and the ranks' shares of a
    whole leaf's add up to it (``tests/torch_dp_worker.py``'s
    ``seq_collectives``)."""
    ranks = world["ranks"]
    for r in ranks:
        for name in ("x", "w1", "w2", "w3"):
            np.testing.assert_allclose(r[f"seqcoll/got/{name}"], r[f"seqcoll/want/{name}"],
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    for d in (0, 1):
        group = [r for r in ranks if int(r["seqcoll/data_rank"]) == d]
        assert len(group) == 2
        np.testing.assert_allclose(sum(r["seqcoll/got/s"] for r in group),
                                   group[0]["seqcoll/want/s"], rtol=1e-12, atol=1e-12)


def test_seqpar_refuses_a_sequence_that_does_not_split_over_the_model_ranks():
    """A sequence of 7 tokens over 2 model ranks raises before any
    collective (the mesh's groups are stand-ins, never used)."""
    import torch

    from repro_torch.distributed.sharding import Mesh
    from repro_torch.train import train_step as TS

    cfg = get_smoke_config("yi_6b")
    tc = TS.TrainConfig(lb_ingest=False)
    mesh = Mesh(("data", "model"), (1, 2), group=object(), model_group=object())
    step = TS.make_train_step(cfg, tc, mesh, 2, specs={}, seqpar=True)
    toks = np.zeros((2, 7), np.int32)
    state = {"step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="7 tokens does not split over 2 model ranks"):
        step(state, {"tokens": toks, "labels": toks}, None)
