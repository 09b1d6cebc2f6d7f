#!/usr/bin/env python3
"""The port's placed serving step (``launch/serve_step.py``) over the ranks
of one host's CUDA cards (NCCL), one process per card, started by
``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node 4 scripts/serve_tp_torch.py

It runs on the meshes ``make_debug_mesh(world / N, N)`` for N in
``--models`` (default 4, 2, 1: (1, 4), (2, 2) and (4, 1) on four cards):

1. Agreement: the smoke configs of the dense, moe, hybrid, ssm and vlm
   families (float32, TF32 off), params and decode state placed by
   ``serve_step.placement`` at ``min_fsdp_size`` 1024, a prefill of 4 x 16
   tokens and 3 decode steps on each data rank's rows against the
   one-process ``model.prefill``/``decode_step`` on the whole batch (every
   rank runs it too, on its own card): the logits of every step and the
   gathered state within rtol/atol 2e-4.
2. Timing: Yi-6B at full width, ``--layers`` of its 32 layers (bf16,
   random weights), placed at the reference's FSDP threshold (2**24): a
   prefill of ``--batch`` x ``--seq`` tokens (``flash_attention`` on each
   rank's heads), then ``--steps`` decode steps; the slowest rank's prefill
   ms and median decode step ms (host clock around a step that ends on the
   card), each rank's peak memory, and the collectives of one prefill and
   one decode step by kind with their bytes
   (``analysis.collectives.CollectiveRecord``).

Rank 0 prints the card line and one JSON object; any rank's failed check
exits non-zero. ``--device cpu`` runs the same over gloo on the CPU, at
small ``--layers``/``--seq``, to check the script without a card.
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
TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("yi_6b", "mixtral_8x22b", "zamba2_2_7b", "rwkv6_7b", "llama_3_2_vision_90b")


def _state_like(torch, cfg, state):
    """The state with a vlm's vision tokens present, so the specs place them."""
    like = dict(state)
    if cfg.family == "vlm":
        like["vision"] = torch.zeros(len(state["pos"]), cfg.n_vision_tokens, cfg.d_model,
                                     device="meta")
    return like


def _steps(torch, step_fn, batch, tokens):
    """Prefill then the decode steps: the logits of each."""
    logits, state = step_fn[0](batch)
    out = [logits]
    for tok in tokens:
        logits, state = step_fn[1](tok, state)
        out.append(logits)
    return out, state


def agreement(torch, np, arch, mesh, dev):
    """The largest share of TOL that the placed step's logits and gathered
    state take from the one-process step's (a check fails above 1)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch import shardspecs
    from repro_torch.models import model as M
    from repro_torch.tree import flat_paths, stack

    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b, t, steps, max_len = 4, 16, 3, 24
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32))
             .to(dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    toks = [torch.from_numpy(x).to(dev) for x in
            rng.integers(0, cfg.vocab, (steps, b)).astype(np.int32)]
    fresh = lambda: M.init_decode_state(cfg, b, max_len, dev)
    with torch.no_grad():
        plain, plain_state = _steps(torch, (
            lambda bt: M.prefill(params, bt, fresh(), cfg, q_chunk=8, k_chunk=8),
            lambda tk, st: M.decode_step(params, tk, st, cfg, q_chunk=8, k_chunk=8)),
            batch, toks)
    specs = SS.placement(cfg, mesh, params, _state_like(torch, cfg, fresh()), min_fsdp_size=1024)
    mine = shd.shard_tree(params, specs["params"], mesh)
    step = SS.ServeStep(cfg, mesh, specs, global_batch=b, q_chunk=8, k_chunk=8)
    rows = lambda x: SS.batch_rows({"x": x}, mesh, b)["x"]
    got, state = _steps(torch, (
        lambda bt: step.prefill(mine, SS.batch_rows(bt, mesh, b),
                                shardspecs.shard_state(fresh(), specs["state"], mesh)),
        lambda tk, st: step.decode(mine, rows(tk), st)), batch, toks)
    every = lambda x: torch.cat(DP.all_gather(x, mesh.group)) if SS.rows_split(mesh, b) else x
    whole = shardspecs.gather_state(state, specs["state"], mesh)
    pairs = [(every(a), p) for a, p in zip(got, plain)]
    flat = lambda s: {k: stack(v) for k, v in flat_paths(shardspecs._as_tree(s)).items()
                      if v is not None}
    pairs += list(zip(flat(whole).values(), flat(plain_state).values()))
    worst = 0.0
    for a, p in pairs:
        a, p = a.double(), p.double()
        worst = max(worst, float(((a - p).abs() / (TOL["atol"] + TOL["rtol"] * p.abs())).max()))
    if worst > 1:
        raise SystemExit(f"{arch}: the placed step is {worst:.3g}x TOL from the one-process step")
    return worst


def timing(torch, dist, mesh, layers, batch, seq, steps, dev):
    from repro_torch.analysis.collectives import CollectiveRecord
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp as DP
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch import shardspecs
    from repro_torch.models import model as M

    cfg = get_config("yi-6b").with_(n_layers=layers)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fresh = lambda: M.init_decode_state(cfg, batch, seq + steps + 1, dev)
    cuda = dev != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    specs = SS.placement(cfg, mesh, params, fresh())
    mine = shd.shard_tree(params, specs["params"], mesh)
    del params
    step = SS.ServeStep(cfg, mesh, specs, global_batch=batch)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev,
                           dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (steps + 1, batch), generator=g, device=dev,
                         dtype=torch.int32)
    rows = lambda x: SS.batch_rows({"x": x}, mesh, batch)["x"]

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    prefill_s, decode_s, counts = [], [], {}
    for rep in range(3):
        state = shardspecs.shard_state(fresh(), specs["state"], mesh)
        DP.reset_counts()
        _lib.reset_launches()
        (logits, state), s = timed(lambda: step.prefill(mine, {"tokens": rows(prompt)}, state))
        prefill_s.append(s)
        counts = {"prefill": dict(DP.COUNTS), "flash": dict(_lib.LAUNCHES)}
    for i in range(steps):
        (logits, state), s = timed(lambda: step.decode(mine, rows(toks[i]), state))
        decode_s.append(s)
    ok = bool(torch.isfinite(logits).all())
    with CollectiveRecord() as rec_p:
        _, state2 = step.prefill(mine, {"tokens": rows(prompt)},
                                 shardspecs.shard_state(fresh(), specs["state"], mesh))
    with CollectiveRecord() as rec_d:
        step.decode(mine, rows(toks[steps]), state2)
    # the slowest rank's times
    t = torch.tensor([statistics.median(prefill_s), statistics.median(decode_s)],
                     dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0],
                        device=dev)
    peaks = [torch.zeros_like(peak) for _ in range(dist.get_world_size())]
    dist.all_gather(peaks, peak)
    return dict(model=f"yi-6b width, {layers} of 32 layers, bf16, random weights",
                mesh=dict(data=shd.data_extent(mesh), model=shd.model_extent(mesh)),
                batch=batch, seq=seq, decode_steps=steps, logits_finite=ok,
                prefill_ms=float(t[0]) * 1e3, decode_step_ms=float(t[1]) * 1e3,
                prefill_ms_rank0=[x * 1e3 for x in prefill_s],
                decode_ms_rank0=[x * 1e3 for x in decode_s],
                peak_mem_gb_per_rank=[float(p) for p in peaks],
                flash_launches_per_prefill=counts["flash"].get("flash_attention", 0),
                flash_wgmma_per_prefill=counts["flash"].get("flash_attention_wgmma", 0),
                collectives_per_prefill=counts["prefill"],
                collectives_recorded_prefill=rec_p.stats().to_json(),
                collectives_recorded_decode=rec_d.stats().to_json())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="4,2,1",
                    help="ranks on 'model' of each mesh run (the data extent is world / N)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    cuda = args.device == "cuda"
    if (cuda and not torch.cuda.is_available()) or "WORLD_SIZE" not in os.environ:
        print("FAIL: run on CUDA cards under torch.distributed.run", flush=True)
        return 1
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("nccl",
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo")
    from repro_torch.launch.mesh import make_debug_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    t_all = time.perf_counter()
    out = {}
    try:
        for n in (int(x) for x in args.models.split(",")):
            mesh = make_debug_mesh(world // n, n)
            tag = f"{world // n}x{n}"
            out[tag] = {"agreement_share_of_tol": {a: agreement(torch, np, a, mesh, args.device)
                                                   for a in ARCHS}}
            out[tag]["timing"] = timing(torch, dist, mesh, args.layers, args.batch, args.seq,
                                        args.steps, args.device)
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t_all
    if rank == 0:
        if cuda:
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True)
            print(card.stdout.strip(), flush=True)
        print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
