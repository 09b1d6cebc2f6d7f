#!/usr/bin/env python3
"""The port's training step over the ranks of one host's CUDA cards (NCCL),
one process per card, started by ``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node 4 scripts/train_dp_torch.py \
        [--model N] [--seqpar] [--arch A --layers L] [--accum-steps A] \
        [--moe-groups G] [--layer-list]

The mesh is ``make_debug_mesh(world / N, N)``: ``--model`` ranks of tensor
parallelism on "model" (default 1), the rest data-parallel. ``--arch``
(default yi-6b) picks the model of both legs. ``--seqpar`` splits the
residual stream by sequence over the model ranks (Megatron's sequence
parallelism, ``make_train_step(..., seqpar=True)``) in both legs.
``--accum-steps`` (``TrainConfig.accum_steps``: the global batch in A
microbatches of ``rows // A``, which may straddle the ranks' rows) and
``--moe-groups`` (a MoE config's ``moe_dispatch_groups``: contiguous
ranges of a microbatch's tokens, which may span ranks) apply to both legs.
``--layer-list`` adds one agreement case: Mixtral's smoke config (its own
capacity factor) with 8-bit moments at ``min_fsdp_size`` 1, its norms' row
scales placed on the layer dim as the reference's rules place them
(``repro_torch.testing.placements.on_layer_list``); the data extent must
divide its 2 layers.

1. Agreement: Yi-6B's and Mixtral's smoke configs and the smoke config of
   ``--arch`` (float32, TF32 off, LB ingest off; the vlm's rows carry their
   vision embeddings), params and moments split across the ranks
   (``train_step.placement`` at ``min_fsdp_size`` 1024), 3 steps of the
   step over the mesh on each data rank's rows of the batch against the
   one-process ``make_train_step`` on the whole batch (every rank runs it
   too, on its own card, from the same init): loss, grad norm
   and every param within rtol/atol 2e-4 (float32 reassociation: the ranks'
   gradients add in another order; in the ``--layer-list`` case at most 1 in 1000
   params past it, each within EIGHT_BIT_STEPS lr or UPDATE_RTOL of its
   own movement). With ``--seqpar`` each config also runs the seqpar step
   over the mesh from the same state, held against the same mesh's
   unsplit step within the same tolerance.
2. Timing: ``--arch`` at full width, ``--layers`` of its depth (bf16, remat,
   LB ingest; the vlm's rows with their vision embeddings, drawn by
   ``repro_torch.testing.batches.with_vision``), placed at the default FSDP
   threshold; the trainer's global batch is ``--rows`` per data rank x 2048
   tokens; 2 warm-up steps, then
   ``--steps`` timed. Rank 0 prints the median step ms, trained tokens/s
   (of the rows that the microbatches take), its peak memory and the
   collectives a step (``distributed.dp.COUNTS``), and those of one more
   step (not timed) by kind with their bytes
   (``analysis.collectives.CollectiveRecord``). In that step every
   ``dispatch_plan`` call (the ingest's pack; a MoE model's packs, each
   layer's in the forward and in remat's recompute, in every round of the
   microbatches) is held exactly equal to the plain version's (pos,
   counts) on the same members (``repro_torch.testing.plans``), and a MoE
   model's dropped assignments are counted (summed over the ranks), as they
   are in step 1 (from the init: the same params whatever
   ``--moe-groups``).

Rank 0 prints the card line and one JSON object; any rank's failed check
exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQ = 2048
TOL = dict(rtol=2e-4, atol=2e-4)
#: with 8-bit moments an int8 value within reassociation of a rounding half
#: may round the other way: a param so moved may pass TOL, by at most this
#: many lr (twice the Adam ratio's bound), or, where an 8-bit v dequantizes
#: to 0 and the ratio grows as 1/|g|, by this share of the one-process
#: run's own movement of it (the rules of the CPU parity tests)
EIGHT_BIT_STEPS = 2.001
UPDATE_RTOL = 0.25


def agreement(torch, np, arch, over, mesh, seqpar=False, device="cuda", accum=1,
              layer_list=False):
    """The largest share of TOL that the W-rank step's loss, grad norm and
    params take from the one-process step's on the whole batch (a check
    fails above 1); with ``seqpar`` also that of the seqpar step's from the
    W-rank step's. ``accum``: the steps' ``accum_steps``. With
    ``layer_list`` the moments are 8-bit and the state is placed at
    ``min_fsdp_size`` 1 with optimizer leaves on the layer list
    (``on_layer_list``; it fails unless some are); its params may pass TOL
    in at most 1 in 1000 elements, each within EIGHT_BIT_STEPS lr or
    UPDATE_RTOL of the one-process run's movement of it
    (``params_past_tol``, ``past_tol_in_lr``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import LIST, data_extent, placed_dims, rank_of
    from repro_torch.testing.placements import on_layer_list
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.tree import leaves

    cfg = get_smoke_config(arch).with_(**over)
    eight_bit = layer_list
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3, eight_bit=eight_bit), remat=True,
                        lb_ingest=False, accum_steps=accum, q_chunk=8, k_chunk=8)
    w, rank = data_extent(mesh), rank_of(mesh)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4 * w, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (4 * w, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    fresh = lambda: TS.init_train_state(torch.Generator(device=device).manual_seed(0), cfg, tc,
                                        device)
    plain, plain_step = fresh(), TS.make_train_step(cfg, tc)
    start = [p.detach().clone() for p in leaves(plain["params"])]
    specs = on_layer_list(cfg, tc, mesh, min_fsdp_size=1) if layer_list else TS.placement(
        cfg, tc, mesh, TS.state_shapes(cfg, tc)["params"], min_fsdp_size=1024)
    step = TS.make_train_step(cfg, tc, mesh, len(toks), specs=specs)
    mine = TS.shard_state(fresh(), specs, mesh)
    if seqpar:
        seq_step = TS.make_train_step(cfg, tc, mesh, len(toks), specs=specs, seqpar=True)
        seq = TS.shard_state(fresh(), specs, mesh)
    rows = slice(rank * 4, (rank + 1) * 4)
    share = lambda a, b: float(((a - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs())).max()
                               .detach())
    worst = {"mesh_vs_one_process": 0.0}
    if seqpar:
        worst["seqpar_vs_mesh"] = 0.0
    for _ in range(3):
        plain, pm = plain_step(plain, batch, None)
        mine, mm = step(mine, {k: v[rows] for k, v in batch.items()}, None)
        if seqpar:
            seq, sm = seq_step(seq, {k: v[rows] for k, v in batch.items()}, None)
        for k in ("loss", "grad_norm"):
            worst["mesh_vs_one_process"] = max(worst["mesh_vs_one_process"], share(mm[k], pm[k]))
            if seqpar:
                worst["seqpar_vs_mesh"] = max(worst["seqpar_vs_mesh"], share(sm[k], mm[k]))
    whole = TS.gather_state(mine, specs, mesh)
    past, n_params, beyond, past_lr = 0, 0, 0, 0.0
    for a, b, b0 in zip(leaves(whole["params"]), leaves(plain["params"]), start):
        if eight_bit:  # the elements that an int8 rounding moved past TOL
            a, b = a.detach(), b.detach()
            off = (a - b).abs() > TOL["atol"] + TOL["rtol"] * b.abs()
            bound = torch.clamp(UPDATE_RTOL * (b - b0).abs(), min=EIGHT_BIT_STEPS * tc.adamw.lr)
            past, n_params = past + int(off.sum()), n_params + b.numel()
            beyond += int((off & ((a - b).abs() > bound)).sum())
            past_lr = max(past_lr, float((a - b).abs().masked_fill(~off, 0).max())
                          / tc.adamw.lr)
            a = torch.where(off, b, a)
        worst["mesh_vs_one_process"] = max(worst["mesh_vs_one_process"], share(a, b))
    if eight_bit and (past > n_params // 1000 or beyond):
        raise SystemExit(f"{arch}: {past} of {n_params} params past TOL (at most 1 in 1000), "
                         f"{beyond} of them past their bound, the farthest {past_lr} lr: "
                         f"{worst}")
    if seqpar:
        for a, b in zip(leaves(TS.gather_state(seq, specs, mesh)["params"]),
                        leaves(whole["params"])):
            worst["seqpar_vs_mesh"] = max(worst["seqpar_vs_mesh"], share(a, b))
    if max(worst.values()) > 1:
        raise SystemExit(f"{arch}: a step is more than TOL from the one it is held to "
                         f"(shares of TOL): {worst}")
    if eight_bit:
        worst.update(params_past_tol=past, past_tol_in_lr=past_lr)
    worst["leaves_on_the_layer_list"] = sum(d == LIST for d in leaves(
        placed_dims(mine["opt"], specs["opt"], mesh)))
    if layer_list and not worst["leaves_on_the_layer_list"]:
        raise SystemExit(f"{arch}: no optimizer leaf lies on the layer list at a data extent "
                         f"of {w} ({cfg.n_layers} layers)")
    return worst


def timing(torch, mesh, arch, layers, rows, steps, seqpar=False, accum=1, groups=1):
    from repro_torch.analysis.collectives import CollectiveRecord
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed.sharding import data_extent, model_extent, placed_dims
    from repro_torch.testing.batches import with_vision
    from repro_torch.distributed.sharding import rank_of
    from repro_torch.testing.plans import held, recorded_drops, recorded_plans
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    full = get_config(arch)
    moe = full.family == "moe"
    cfg = full.with_(n_layers=layers, **({"moe_dispatch_groups": groups} if moe else {}))
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-4, warmup_steps=2, decay_steps=100),
                        remat=True, lb_ingest=True, accum_steps=accum)
    w = data_extent(mesh)  # the LB members: the data ranks
    tr = Trainer(cfg, tc, TrainerConfig(n_members=w,
                                        ckpt_dir=str(ROOT / "build" / "train_dp_torch"),
                                        device=f"cuda:{torch.cuda.current_device()}",
                                        ckpt_every=1 << 30), mesh=mesh,
                 step_fn=TS.jit_train_step(cfg, tc, mesh, TS.state_shapes(cfg, tc),
                                           global_batch=None, seqpar=seqpar))
    if cfg.family == "vlm":
        with_vision(tr)
    tr.init_or_restore(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in leaves(TS.state_shapes(cfg, tc)["params"]))
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], []
    inner = tr.step_fn

    first_drops = []  # step 1's, from the init: the same params whatever the groups

    def counted(*a):
        DP.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_drops() if not times else contextlib.nullcontext([]) as drops:
            out = inner(*a)
        first_drops.extend(drops)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(dict(DP.COUNTS))
        return out

    tr.step_fn = counted
    hist = tr.run(2 + steps, batch=rows * w, seq=SEQ)
    med = statistics.median(times[2:])
    occ = hist[-1]["ingest_occupancy"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    tr.step_fn = inner
    # one more step, not timed
    with CollectiveRecord() as rec, recorded_plans() as calls, recorded_drops() as drops:
        tr.run(1, batch=rows * w, seq=SEQ)
    plans = held(calls)
    # per round of the microbatches, each MoE layer packs this rank's rows of
    # it in the forward and again in remat's recompute
    want = [cfg.top_k * (rnd[0].stop - rnd[0].start) * SEQ
            for rnd in TS._rounds(accum, w, rank_of(mesh), rows)
            for _ in range(2 * layers)] if moe else []
    if [p["n"] for p in plans[1:]] != want or not all(p["equal"] for p in plans) or (
            len(drops) != len(want) // 2):
        raise SystemExit(f"{arch}: the step's dispatch_plan calls against plain: {plans}; "
                         f"{len(drops)} layer calls counted their drops")
    dropped = DP.all_reduce(torch.tensor([sum(first_drops), sum(drops)], device="cuda"),
                            mesh.group).tolist()
    trained = w * rows // accum * accum  # the rows that the microbatches take
    split = {axis: sum(d is not None for d in leaves(placed_dims(
        tr.state["params"], tr.specs["params"], mesh, axis))) for axis in ("data", "model")}
    return dict(model=f"{cfg.name} width, {layers} of {full.n_layers} layers, bf16, remat, "
                      "lb_ingest" + (f", {cfg.n_vision_tokens} vision_embeds rows a row"
                                     if cfg.family == "vlm" else "")
                      + (", seqpar" if seqpar else "")
                      + (f", accum_steps {accum}" if accum > 1 else "")
                      + (f", moe_dispatch_groups {groups}" if moe else ""), seqpar=seqpar,
                accum_steps=accum, moe_dispatch_groups=groups if moe else None,
                trained_rows=trained,
                dropped_assignments_step1=dropped[0] if moe else None,
                dropped_assignments=dropped[1] if moe else None,
                n_params=n_params, state_gb_a_rank_reckoned=n_params * 12 / 1e9 / model_extent(
                    mesh) / data_extent(mesh),
                mesh=dict(data=w, model=model_extent(mesh)), rows_per_data_rank=rows, seq=SEQ,
                step_ms_median=med * 1e3, step_ms=[t * 1e3 for t in times[2:]],
                trained_tokens_per_s=occ * trained * (SEQ - 1) / med,
                occupancy=occ, peak_mem_gb_rank0=peak,
                collectives_per_step=counts[-1], collectives_recorded=rec.stats().to_json(),
                param_leaves_split=split, loss=[h["loss"] for h in hist],
                dispatch_plan_equal_to_plain=[(p["n"], p["n_members"]) for p in plans])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b", help="the model of both legs")
    ap.add_argument("--layers", type=int, default=8,
                    help="layers of the timing leg (the vlm: a multiple of its "
                         "cross_attn_every)")
    ap.add_argument("--rows", type=int, default=4, help="rows of 2048 tokens per rank")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of tensor parallelism on 'model' (the data extent is world / N)")
    ap.add_argument("--seqpar", action="store_true",
                    help="split the residual stream by sequence over the model ranks")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches of the global batch (both legs)")
    ap.add_argument("--moe-groups", type=int, default=1,
                    help="a MoE config's moe_dispatch_groups (both legs)")
    ap.add_argument("--layer-list", action="store_true",
                    help="add an agreement case with 8-bit norm scales on the layer list")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available() or "WORLD_SIZE" not in os.environ:
        print("FAIL: run on CUDA cards under torch.distributed.run", flush=True)
        return 1
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl", device_id=torch.device("cuda", torch.cuda.current_device()))
    from repro_torch.launch.mesh import make_debug_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        mesh = make_debug_mesh(world // args.model, args.model)
        groups = {"moe_dispatch_groups": args.moe_groups}
        cases = {"yi_6b": {}, "mixtral_8x22b": {"capacity_factor": 0.5, **groups}}
        cases.setdefault(args.arch.replace("-", "_").replace(".", "_"), {})
        out = {"agreement_share_of_tol": {arch: agreement(
            torch, np, arch, over, mesh, args.seqpar, accum=args.accum_steps)
            for arch, over in cases.items()}}
        if args.layer_list:
            out["agreement_share_of_tol"]["mixtral_8x22b/layer_list"] = agreement(
                torch, np, "mixtral_8x22b", groups, mesh, args.seqpar, accum=args.accum_steps,
                layer_list=True)
        out["timing"] = timing(torch, mesh, args.arch, args.layers, args.rows, args.steps,
                               args.seqpar, args.accum_steps, args.moe_groups)
    except BaseException:
        # a rank that fails leaves at once: tearing its group down would wait
        # on the collectives that the other ranks are still in (the launcher
        # stops them when this process exits)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
        print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
