"""One gloo rank of ``tests/test_torch_dp_step.py`` and
``tests/test_torch_tp_step.py``: every case of the training step over the
ranks, then (W-rank worlds) the checkpoint crossings; its results go to
``<out>/rank<r>.npz``.

    python tests/torch_dp_worker.py RANK WORLD INIT_FILE OUT_DIR

``OUT_DIR/cases.pkl`` (written by the test) holds the cases: the arch, the
step's options, the global numpy batch, the reference's initial params
(numpy, stacked), the LB members' weights and, for tensor parallelism, the
meshes ``(data, model)`` to run the case on (by default ``(W, 1)``). The
step is ``make_train_step`` with params and moments placed by
``train_step.placement`` at ``MIN_FSDP`` (small, so that the smoke configs'
leaves are split; a case's ``min_fsdp`` option overrides it, and its
``layer_list`` option places optimizer leaves on the layer list as the
reference's rules do, ``testing.placements.on_layer_list``); each rank
feeds its data rank's rows of the batch. A case whose ``ckpt`` is ``(W, 1)``
is saved after its steps at W ranks (``ckpt_placed_<case>``), and the
checkpoint the test wrote (``ckpt_one_<case>``) is restored into fresh
blocks. At
W = 1 the same case also runs through the one-process ``make_train_step``
(no process group). On a mesh given by the case, each step runs under
``analysis.collectives.CollectiveRecord``, and the record's counts are kept
beside ``distributed.dp.COUNTS``. A case whose options hold ``seqpar``
runs the step with the residual stream split by sequence over "model".
A world that holds a (2, 2) mesh also runs ``seq_collectives`` on its
two-rank model group. ``OUT_DIR/moe_layers.pkl``, where the test wrote it,
holds MoE layer layouts (``moe_layers``); a world of 2 runs
``layer_round_trip``.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core as tcore
from repro_torch.checkpoint import ckpt
from repro_torch.analysis.collectives import CollectiveRecord
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import dp as DP
from repro_torch.distributed.sharding import LIST, Mesh, data_extent, placed_dims, rank_of
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.testing.placements import on_layer_list
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.tree import flat_paths, leaves
from torch_helpers import dist_program

#: leaves of at least this many elements are split across the ranks
MIN_FSDP = 1024
STEPS = 2


def train_config(opts: dict) -> TS.TrainConfig:
    return TS.TrainConfig(
        adamw=TO.AdamWConfig(lr=1e-3, eight_bit=opts.get("eight_bit", False)),
        remat=True, lb_ingest=True, accum_steps=opts.get("accum_steps", 1),
        grad_compress=opts.get("grad_compress", False), q_chunk=8, k_chunk=8)


def case_config(case: dict):
    return get_smoke_config(case["arch"]).with_(**case["cfg"])


def fresh_state(case: dict, tc: TS.TrainConfig) -> dict:
    cfg = case_config(case)
    params = TM.params_from_numpy(case["params"], cfg, "cpu")
    return {"params": params, "opt": TO.init(params, tc.adamw), "efb": None,
            "step": torch.zeros((), dtype=torch.int32)}


def host(tree) -> dict:
    """A whole state's params and moments (and the error-feedback residual
    of ``grad_compress``, once there is one) as flat numpy arrays under the
    reference's stacked paths, plus the step."""
    parts = {k: tree[k] for k in ("params", "opt", "efb") if tree.get(k) is not None}
    out = {k: ckpt._to_host(v) for k, v in flat_paths(parts).items()}
    out["step"] = np.asarray(int(tree["step"]))
    return out


def placement(case: dict, mesh) -> dict:
    """``train_step.placement``'s specs of the params and moments at
    ``MIN_FSDP`` (a case's ``min_fsdp`` option overrides it); with the
    case's ``layer_list`` option, ``testing.placements.on_layer_list``'s:
    the optimizer leaves that the reference places on the layer list so
    placed."""
    cfg = case_config(case)
    tc = train_config(case["opts"])
    min_fsdp = case["opts"].get("min_fsdp", MIN_FSDP)
    if case["opts"].get("layer_list"):
        return on_layer_list(cfg, tc, mesh, min_fsdp_size=min_fsdp)
    return TS.placement(cfg, tc, mesh, TS.state_shapes(cfg, tc)["params"],
                        min_fsdp_size=min_fsdp)


def run_case(case: dict, mesh, rank: int, world: int, out: dict, tag: str, specs=None,
             record: bool = False):
    """Two steps of the case on this rank's rows: the step over the mesh's
    ranks with its state placed by ``specs``, or without them the
    one-process step. ``record``: the collectives of each step
    (``collectives<s>/record/<kind>`` and ``collectives<s>/counts/<kind>``)."""
    cfg = case_config(case)
    tc = train_config(case["opts"])
    gb = len(case["batch"]["labels"])
    if specs is not None:
        step = TS.make_train_step(cfg, tc, mesh, gb, specs=specs,
                                  seqpar=case["opts"].get("seqpar", False))
        state = TS.shard_state(fresh_state(case, tc), specs, mesh)
        dims = placed_dims(state["params"], specs["params"], mesh)
        out[f"{tag}/n_split"] = np.asarray(sum(d is not None for d in leaves(dims)))
        out[f"{tag}/n_list"] = np.asarray(sum(d == LIST for d in leaves(placed_dims(
            state["opt"], specs["opt"], mesh))))
    else:
        step = TS.make_train_step(cfg, tc, Mesh(("data",), (1,)), gb)
        state = fresh_state(case, tc)
    tables = dist_program(tcore, case["weights"]).device_tables("cpu")
    w = data_extent(mesh) if specs is not None else world
    r = rank_of(mesh) if specs is not None else rank
    b = gb // w
    rows = {k: v[r * b:(r + 1) * b] for k, v in case["batch"].items()}
    for s in range(STEPS):
        DP.reset_counts()
        if record:
            with CollectiveRecord() as rec:
                state, met = step(state, rows, tables)
            for k, v in rec.stats().ops.items():
                out[f"{tag}/collectives{s}/record/{k}"] = np.asarray(v)
            for k, v in DP.COUNTS.items():
                out[f"{tag}/collectives{s}/counts/{k.replace('_', '-')}"] = np.asarray(v)
        else:
            state, met = step(state, rows, tables)
        for k, v in met.items():
            out[f"{tag}/{s}/{k}"] = v.detach().numpy()
        # the whole state after each step (``state<s>``)
        whole = TS.gather_state(state, specs, mesh) if specs is not None else state
        for k, v in host(whole).items():
            out[f"{tag}/state{s}/{k}"] = v
    return state


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out_dir = Path(out_dir)
        cases = pickle.loads((out_dir / "cases.pkl").read_bytes())
        mesh = make_debug_mesh(world, 1)
        out = {}
        try:  # a mesh of another size than the world is refused
            make_debug_mesh(world + 1, 1)
        except ValueError as exc:
            out["other_world_refused"] = np.asarray(str(exc))
        meshes = {}
        for name, case in cases.items():
            for dm in case.get("meshes", ()):  # made in one order on every rank
                if dm not in meshes:
                    meshes[dm] = make_debug_mesh(*dm)
            for dm in case.get("meshes", ()):
                tag = f"{name}@{dm[0]}x{dm[1]}"
                specs = placement(case, meshes[dm])
                state = run_case(case, meshes[dm], rank, world, out, tag, specs, record=True)
                if case.get("ckpt") == dm:
                    # a save of the stepped blocks (whole, by the first rank), then a
                    # restore into fresh blocks on the same mesh
                    ckpt.save(str(out_dir / "ckpt_tp"), STEPS, state_ckpt(state), specs=specs,
                              mesh=meshes[dm])
                    dist.barrier()  # written before any rank reads it
                    back = TS.shard_state(fresh_state(case, train_config(case["opts"])), specs,
                                          meshes[dm])
                    ckpt.restore_into(str(out_dir / "ckpt_tp"), state_ckpt(back), specs=specs,
                                      mesh=meshes[dm])
                    for k, v in host(TS.gather_state(back, specs, meshes[dm])).items():
                        out[f"{tag}/restored/{k}"] = v
            if "meshes" in case:
                continue
            specs = placement(case, mesh)
            state = run_case(case, mesh, rank, world, out, name, specs)
            if world == 1:  # the one-process step on the same case
                run_case(case, mesh, rank, world, out, f"{name}/plain")
            if case.get("ckpt") == (world, 1):
                # a save of the stepped state (whole, by rank 0), then a restore
                # of the checkpoint the test wrote
                safe = name.replace("/", "_")
                ckpt.save(str(out_dir / f"ckpt_placed_{safe}"), STEPS, state_ckpt(state),
                          specs=specs, mesh=mesh)
                back = TS.shard_state(fresh_state(case, train_config(case["opts"])), specs, mesh)
                ckpt.restore_into(str(out_dir / f"ckpt_one_{safe}"), state_ckpt(back),
                                  specs=specs, mesh=mesh)
                for k, v in host(TS.gather_state(back, specs, mesh)).items():
                    out[f"{name}/restored_one/{k}"] = v
        if (2, 2) in meshes:
            seq_collectives(meshes[(2, 2)], out)
        layouts = out_dir / "moe_layers.pkl"
        if layouts.exists():
            moe_layers(mesh, rank, world, pickle.loads(layouts.read_bytes()), out)
        if world == 2:
            layer_round_trip(mesh, out)
        np.savez(out_dir / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def seq_collectives(mesh, out: dict) -> None:
    """``distributed.tp``'s sequence-parallel collectives under autograd on
    the two-rank model group of ``mesh`` (float64): the rank's half of the
    tokens of ``x`` ``[B, T, d]`` gathered (``TP.full``), a column product
    on its half of ``w1``'s outputs, the row product on its half of
    ``w2``'s inputs reduce-scattered over the tokens (``TP.exit``), and a
    block run whole on a gathered ``w3`` (``TP.whole``) whose output keeps
    the rank's tokens (``TP.part``). The rank's gradients of its tokens,
    of its slices and of the whole leaf ``s`` (its tokens' share) go to
    ``seqcoll/got/<name>``; those of the unsplit computation, cut the same
    way, to ``seqcoll/want/<name>``."""
    from repro_torch.distributed import tp as TPM
    from repro_torch.distributed.sharding import model_rank

    r, n = model_rank(mesh), 2
    g = torch.Generator().manual_seed(11)
    draw = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    x, c, s = draw(2, 8, 6), draw(2, 8, 6), draw(6)
    w1, w2, w3 = draw(6, 10), draw(10, 6), draw(6, 6)

    def loss(x, w1, w2, w3, s, full, exit_, whole, part):
        xs = x * s
        xf = full(xs)
        y = exit_(torch.tanh(xf @ w1) @ w2) + part(torch.sin(xf @ whole(w3)))
        return (y * part(c)).sum()

    mine = [x.narrow(1, r * 4, 4), w1.narrow(1, r * 5, 5), w2.narrow(0, r * 5, 5),
            w3.narrow(1, r * 3, 3), s]
    mine = [t.clone().requires_grad_(True) for t in mine]
    par = TPM.TP(group=mesh.model_group, rank=r, size=n,
                 dims={id(mine[1]): 1, id(mine[2]): 0, id(mine[3]): 1}, seq=True)
    got = torch.autograd.grad(loss(*mine, par.full, lambda y: par.exit(mine[2], y), par.whole,
                                   par.part), mine)
    whole = [t.clone().requires_grad_(True) for t in (x, w1, w2, w3, s)]
    ident = lambda t: t
    want = torch.autograd.grad(loss(*whole, ident, ident, ident, ident), whole)
    cuts = [lambda t: t.narrow(1, r * 4, 4), lambda t: t.narrow(1, r * 5, 5),
            lambda t: t.narrow(0, r * 5, 5), lambda t: t.narrow(1, r * 3, 3), ident]
    out["seqcoll/data_rank"] = np.asarray(rank_of(mesh))
    for name, a, b, cut in zip(("x", "w1", "w2", "w3", "s"), got, want, cuts):
        out[f"seqcoll/got/{name}"] = a.numpy()
        out[f"seqcoll/want/{name}"] = cut(b).numpy()


def moe_layers(mesh, rank: int, world: int, layouts: list, out: dict) -> None:
    """``moe_ffn`` of one layer of each layout of this world's size (its
    ``rows_of``: the rows of each rank, in rank order, of one slot over the
    world; its config overrides, numpy params and tokens ``x``) on this
    rank's rows: the output, aux loss and drop count, and whether every
    ``dispatch_plan`` call equals plain (``moe<i>/...``)."""
    from repro_torch.models import moe as TMOE
    from repro_torch.testing.plans import held, recorded_plans

    for i, lay in enumerate(layouts):
        rows_of = lay["rows_of"]
        if len(rows_of) != world:
            continue
        cfg = get_smoke_config("mixtral_8x22b").with_(**lay["cfg"])
        params = {k: torch.from_numpy(v.copy()) for k, v in lay["params"].items()}
        lo = sum(rows_of[:rank])
        x = torch.from_numpy(lay["x"][lo:lo + rows_of[rank]].copy())
        with DP.use_slots(DP.Slots(mesh.group, rank, (0,) * world, tuple(rows_of))), \
                recorded_plans() as calls:
            y, aux = TMOE.moe_ffn(params, x, cfg)
        out[f"moe{i}/y"] = y.numpy()
        out[f"moe{i}/aux_loss"] = aux["aux_loss"].numpy()
        out[f"moe{i}/dropped"] = aux["dropped"].numpy()
        out[f"moe{i}/plans_equal"] = np.asarray([p["equal"] for p in held(calls)])


def layer_round_trip(mesh, out: dict) -> None:
    """Mixtral's 8-bit optimizer state (moments drawn from a seed) placed by
    ``param_sharding`` over its own tree at ``min_fsdp_size=1``, as the
    reference places it: ``shard_tree``'s block of ``ln1``'s ``m`` row
    scale (``layers/held``: the layers this rank holds, ``layers/mine``
    their values) and the state gathered back (``layers/back/<path>``)
    beside the whole state (``layers/whole/<path>``)."""
    from repro_torch.distributed.sharding import gather_tree, param_sharding, shard_tree
    from repro_torch.tree import tree_map

    cfg = get_smoke_config("mixtral_8x22b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(7)
    opt = tree_map(lambda x, stacked: (
        torch.randint(-127, 128, x.shape, generator=gen).to(x.dtype) if x.dtype == torch.int8
        else torch.rand(x.shape, generator=gen) + 0.5), TO.init(params, TO.AdamWConfig(
            eight_bit=True)))
    specs = param_sharding(opt, mesh, cfg, min_fsdp_size=1)
    blocks = shard_tree(opt, specs, mesh)
    items = flat_paths(blocks)["mu/layers/ln1/m/s"]
    out["layers/held"] = np.asarray([i for i, x in enumerate(items) if x is not None])
    out["layers/mine"] = np.stack([x.numpy() for x in items if x is not None])
    out["layers/dims"] = np.asarray([d == LIST for d in flat_paths(
        placed_dims(opt, specs, mesh))["mu/layers/ln1/m/s"]])
    for tag, tree in (("back", gather_tree(blocks, specs, mesh)), ("whole", opt)):
        for k, v in flat_paths(tree).items():
            out[f"layers/{tag}/{k}"] = ckpt._to_host(v)


def state_ckpt(state: dict) -> dict:
    return {"params": state["params"], "opt": state["opt"], "step": state["step"]}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
