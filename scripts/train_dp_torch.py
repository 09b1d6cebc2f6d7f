#!/usr/bin/env python3
"""The port's training step over the ranks of one host's CUDA cards (NCCL),
one process per card, started by ``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node 4 scripts/train_dp_torch.py \
        [--model N] [--seqpar] [--arch A --layers L]

The mesh is ``make_debug_mesh(world / N, N)``: ``--model`` ranks of tensor
parallelism on "model" (default 1), the rest data-parallel. ``--arch``
(default yi-6b) picks the model of both legs. ``--seqpar`` splits the
residual stream by sequence over the model ranks (Megatron's sequence
parallelism, ``make_train_step(..., seqpar=True)``) in both legs.

1. Agreement: Yi-6B's and Mixtral's smoke configs and the smoke config of
   ``--arch`` (float32, TF32 off, LB ingest off; the vlm's rows carry their
   vision embeddings), params and moments split across the ranks
   (``train_step.placement`` at ``min_fsdp_size`` 1024), 3 steps of the
   step over the mesh on each data rank's rows of the batch against the
   one-process ``make_train_step`` on the whole batch (every rank runs it
   too, on its own card, from the same init): loss, grad norm
   and every param within rtol/atol 2e-4 (float32 reassociation: the ranks'
   gradients add in another order). With ``--seqpar`` each config also
   runs the seqpar step over the mesh from the same state, held against
   the same mesh's unsplit step within the same tolerance.
2. Timing: ``--arch`` at full width, ``--layers`` of its depth (bf16, remat,
   LB ingest; the vlm's rows with their vision embeddings, drawn by
   ``repro_torch.testing.batches.with_vision``), placed at the default FSDP
   threshold; the trainer's global batch is ``--rows`` per data rank x 2048
   tokens; 2 warm-up steps, then
   ``--steps`` timed. Rank 0 prints the median step ms, trained tokens/s,
   its peak memory and the collectives a step (``distributed.dp.COUNTS``),
   and those of one more step (not timed) by kind with their bytes
   (``analysis.collectives.CollectiveRecord``). In that step every
   ``dispatch_plan`` call (the ingest's pack; a MoE model's packs, each
   layer's in the forward and in remat's recompute) is held exactly equal
   to the plain version's (pos, counts) on the same members
   (``repro_torch.testing.plans``).

Rank 0 prints the card line and one JSON object; any rank's failed check
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQ = 2048
TOL = dict(rtol=2e-4, atol=2e-4)


def agreement(torch, np, arch, over, mesh, seqpar=False, device="cuda"):
    """The largest share of TOL that the W-rank step's loss, grad norm and
    params take from the one-process step's on the whole batch (a check
    fails above 1); with ``seqpar`` also that of the seqpar step's from the
    W-rank step's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import data_extent, rank_of
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.tree import leaves

    cfg = get_smoke_config(arch).with_(**over)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=False,
                        q_chunk=8, k_chunk=8)
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
    specs = TS.placement(cfg, tc, mesh, TS.state_shapes(cfg, tc)["params"], min_fsdp_size=1024)
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
    for a, b in zip(leaves(whole["params"]), leaves(plain["params"])):
        worst["mesh_vs_one_process"] = max(worst["mesh_vs_one_process"], share(a, b))
    if seqpar:
        for a, b in zip(leaves(TS.gather_state(seq, specs, mesh)["params"]),
                        leaves(whole["params"])):
            worst["seqpar_vs_mesh"] = max(worst["seqpar_vs_mesh"], share(a, b))
    if max(worst.values()) > 1:
        raise SystemExit(f"{arch}: a step is more than TOL from the one it is held to "
                         f"(shares of TOL): {worst}")
    return worst


def timing(torch, mesh, arch, layers, rows, steps, seqpar=False):
    from repro_torch.analysis.collectives import CollectiveRecord
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed.sharding import data_extent, model_extent, placed_dims
    from repro_torch.testing.batches import with_vision
    from repro_torch.testing.plans import held, recorded_plans
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = full.with_(n_layers=layers)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-4, warmup_steps=2, decay_steps=100),
                        remat=True, lb_ingest=True)
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

    def counted(*a):
        DP.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a)
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
    with CollectiveRecord() as rec, recorded_plans() as calls:  # one more step, not timed
        tr.run(1, batch=rows * w, seq=SEQ)
    plans = held(calls)
    moe = cfg.family == "moe"
    if len(plans) != 1 + (2 * layers if moe else 0) or not all(p["equal"] for p in plans) or (
            moe and any(p["n"] != cfg.top_k * rows * SEQ for p in plans[1:])):
        raise SystemExit(f"{arch}: the step's dispatch_plan calls against plain: {plans}")
    split = {axis: sum(d is not None for d in leaves(placed_dims(
        tr.state["params"], tr.specs["params"], mesh, axis))) for axis in ("data", "model")}
    return dict(model=f"{cfg.name} width, {layers} of {full.n_layers} layers, bf16, remat, "
                      "lb_ingest" + (f", {cfg.n_vision_tokens} vision_embeds rows a row"
                                     if cfg.family == "vlm" else "")
                      + (", seqpar" if seqpar else ""), seqpar=seqpar,
                n_params=n_params, state_gb_a_rank_reckoned=n_params * 12 / 1e9 / model_extent(
                    mesh) / data_extent(mesh),
                mesh=dict(data=w, model=model_extent(mesh)), rows_per_data_rank=rows, seq=SEQ,
                step_ms_median=med * 1e3, step_ms=[t * 1e3 for t in times[2:]],
                trained_tokens_per_s=occ * rows * w * (SEQ - 1) / med,
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
        cases = {"yi_6b": {}, "mixtral_8x22b": {"capacity_factor": 0.5}}
        cases.setdefault(args.arch.replace("-", "_").replace(".", "_"), {})
        out = {"agreement_share_of_tol": {arch: agreement(torch, np, arch, over, mesh,
                                                          args.seqpar)
                                          for arch, over in cases.items()}}
        out["timing"] = timing(torch, mesh, args.arch, args.layers, args.rows, args.steps,
                               args.seqpar)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
        print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
