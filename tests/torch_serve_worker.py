"""One gloo rank of ``tests/test_torch_serve_tp.py``: every case of the
placed serving step (``launch/serve_step.py``) on each of its meshes, its
results in ``<out>/rank<r>.npz``.

    python tests/torch_serve_worker.py RANK WORLD INIT_FILE OUT_DIR

``OUT_DIR/cases.pkl`` (written by the test) holds the cases: the arch and
its config overrides, the reference's initial params (numpy, stacked), the
prompt (and a vlm's vision tokens), the tokens of the decode steps, the
cache length, the layout (``wide``, ``seqpar``, ``moegroup``) and the
meshes ``(data, model)`` to run on. Each rank places the params and the
decode state by ``serve_step.placement`` at ``MIN_FSDP`` (small, so that
the smoke configs' leaves split), runs the prefill and the decode steps on
its data rank's rows, and keeps the logits of every row (gathered over the
data ranks), the decode state gathered whole, the collectives of the
prefill and of the first decode step (``analysis.collectives``), and for
each decode step whether its token landed on this rank's cache slots.
"""
from __future__ import annotations

import gc
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.collectives import CollectiveRecord
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import dp as DP
from repro_torch.distributed import sharding as shd
from repro_torch.launch import serve_step as SS
from repro_torch.launch import shardspecs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.tree import flat_paths, stack

#: leaves of at least this many elements are split across the data ranks
MIN_FSDP = 1024
CHUNK = 8


def case_config(case: dict, data_ranks: int = 1):
    cfg = get_smoke_config(case["arch"]).with_(**case["cfg"])
    if case.get("moegroup"):
        cfg = cfg.with_(moe_dispatch_groups=data_ranks)
    return cfg


def whole_state(cfg, case: dict):
    """A fresh decode state (the vlm's with room for its vision tokens,
    so that the specs place them)."""
    b = len(case["prompt"])
    state = TM.init_decode_state(cfg, b, case["max_len"], "cpu")
    like = dict(state)
    if cfg.family == "vlm":
        like["vision"] = torch.zeros(b, cfg.n_vision_tokens, cfg.d_model)
    return state, like


def host_state(state) -> dict:
    """A decode state as numpy arrays under the reference's stacked paths."""
    return {k: stack(v).numpy() for k, v in flat_paths(shardspecs._as_tree(state)).items()
            if v is not None}


def _flat(x):
    return [y for v in x for y in _flat(v)] if isinstance(x, list) else [x]


def _record(out: dict, tag: str, rec: CollectiveRecord) -> None:
    for k, v in rec.stats().ops.items():
        out[f"{tag}/{k}"] = np.asarray(v)


def run_case(case: dict, mesh, out: dict, tag: str) -> None:
    w = shd.data_extent(mesh)
    cfg = case_config(case, w)
    b = len(case["prompt"])
    params = TM.params_from_numpy(case["params"], cfg, "cpu")
    state, like = whole_state(cfg, case)
    specs = SS.placement(cfg, mesh, params, like, wide=case.get("wide", False),
                         min_fsdp_size=MIN_FSDP)
    params = shd.shard_tree(params, specs["params"], mesh)
    state = shardspecs.shard_state(state, specs["state"], mesh)
    step = SS.ServeStep(cfg, mesh, specs, global_batch=b, seqpar=case.get("seqpar", False),
                              q_chunk=CHUNK, k_chunk=CHUNK)
    batch = {"tokens": torch.from_numpy(case["prompt"])}
    if "vision" in case:
        batch["vision_embeds"] = torch.from_numpy(case["vision"])

    def every_row(logits):
        return torch.cat(DP.all_gather(logits, mesh.group)) if SS.rows_split(mesh, b) else logits

    DP.reset_counts()
    with CollectiveRecord() as rec:
        logits, state = step.prefill(params, SS.batch_rows(batch, mesh, b), state)
    _record(out, f"{tag}/prefill", rec)
    out[f"{tag}/logits0"] = every_row(logits).numpy()
    kpos = [c.pos for c in _flat(state.get("kv", []))]
    for s, tok in enumerate(case["decode"]):
        before = [p.clone() for p in kpos]
        rows = SS.batch_rows({"t": torch.from_numpy(tok)}, mesh, b)["t"]
        with CollectiveRecord() as rec:
            logits, state = step.decode(params, rows, state)
        if s == 0:
            _record(out, f"{tag}/decode", rec)
        out[f"{tag}/logits{s + 1}"] = every_row(logits).numpy()
        if kpos:  # did this step's token land on this rank's slots?
            out[f"{tag}/wrote{s + 1}"] = np.asarray(not torch.equal(before[0], kpos[0]))
    out[f"{tag}/counts"] = np.asarray(sum(DP.COUNTS.values()))
    for k, v in host_state(shardspecs.gather_state(state, specs["state"], mesh)).items():
        out[f"{tag}/state/{k}"] = v


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out_dir = Path(out_dir)
        cases = pickle.loads((out_dir / "cases.pkl").read_bytes())
        meshes, out = {}, {}
        for name, case in cases.items():
            for dm in case["meshes"]:
                if dm[0] * dm[1] != world:
                    continue
                if dm not in meshes:  # made in one order on every rank
                    meshes[dm] = make_debug_mesh(*dm)
                run_case(case, meshes[dm], out, f"{name}@{dm[0]}x{dm[1]}")
        np.savez(out_dir / f"rank{rank}.npz", **out)
        dist.barrier()  # every rank done; no group referenced past its destruction
        meshes.clear()
        gc.collect()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
