"""Dry run of every (arch x shape) cell on the meta device: the counterpart
of the JAX package's ``repro/launch/dryrun.py``, on one H100 (``mesh="h100"``,
chips = dp = tp = 1) and, for the training cells, on the reference's 256-
and 512-chip meshes (``"single"``, ``"multi"``).

For each cell, at the published config, the params and the optimizer state
(train) or the decode state (prefill, decode) are built on
``device="meta"``: shapes and dtypes, no storage. The step the reference
lowers then runs under ``torch.utils.flop_counter.FlopCounterMode``:

- train: the LB ingest, ``train_loss`` forward and backward with remat, and
  the AdamW update (8-bit moments for ``EIGHT_BIT``), through
  ``train_step.make_train_step`` (one card) or ``jit_train_step`` (a
  sharded mesh);
- prefill: ``model.prefill`` (``model.forward`` for the encoder);
- decode: ``model.decode_step``.

A sharded mesh runs in one process as rank 0 of torch's fake process group
(``fake_world``: 256 or 512 ranks on a ``FakeStore``, whose collectives
move nothing): ``launch.mesh``'s factories bind the mesh
(``make_production_mesh``, ``make_dp_mesh`` for ``dponly``,
``make_hybrid_mesh`` for ``tpN``) and the cell runs on rank 0's blocks
inside ``analysis.collectives.CollectiveRecord``, which records each
collective with its bytes and its group's size:

- train: the state placed by ``jit_train_step``'s specs, the step
  tensor-parallel on "model" (``distributed/tp.py``) on data rank 0's rows;
  under ``seqpar`` its residual stream split by sequence over "model"
  (the reference's ``logical_rules(mesh, seq_axis="model")``): the row
  products reduce-scatter the tokens and each block gathers them;
- prefill, decode: the placed serving step (``launch/serve_step.py``):
  params by ``param_sharding(min_fsdp_size=2**24)``, the decode state by
  ``shardspecs.placed_state_shardings`` (``long_500k``'s batch of one puts
  the cache's sequence on the data axes), data rank 0's rows.

The variants, as the reference's: ``widetp`` (serving: TP dims over every
axis, no FSDP), ``seqpar`` (the residual stream split over "model": the
train cells and the prefill), ``moegroup`` (``moe_dispatch_groups`` = the
data extent). Each token of a variant joins with ``+``.

The kernel wrappers take their plain versions on meta tensors, so nothing
computes; an operation whose result lies off the meta device fails the cell.
The JSON artifact has the reference's keys: ``chips``, ``dp``, ``tp``,
``cost.flops`` (the counted FLOPs of rank 0: matmul-like ops only, every
product the plain path computes), ``memory.argument_size_in_bytes``
(rank 0's params, optimizer state, batch, tables and decode state;
temporaries are not counted), ``collectives`` (the record's
``CollectiveStats``; none on one card), ``analytic``
(``analysis/perfmodel.py`` at the mesh's chips, dp and tp),
``collectives_by_shape`` (the record's largest calls by tensor),
``model_flops`` and ``lower_compile_s`` (the cell's seconds).
``analysis/roofline.py`` of either package reads it.

Usage:
    python -m repro_torch.launch.dryrun --arch yi_6b --shape prefill_32k --out DIR
    python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch yi_6b --shape long_500k --mesh single \
        --variant seqpar
    python -m repro_torch.launch.dryrun --shape train_4k --mesh both --variant seqpar
    python -m repro_torch.launch.dryrun --all --out DIR
    python -m repro_torch.launch.dryrun --all --mesh both

Variants: ``baseline`` and ``rwkvchunk`` (the same cells here: RWKV6
prefills with the chunked WKV in both, see ``RWKV_CHUNK``); on the sharded
meshes ``dponly``, ``tpN``, ``seqpar``, ``widetp`` and ``moegroup``.
``widetp`` places serving's params only, as the reference's does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import perfmodel
from repro_torch.analysis.collectives import CollectiveRecord
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.epoch import EpochManager
from repro_torch.core.tables import MemberSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve_step as SS
from repro_torch.launch import shapes as SH
from repro_torch.launch import shardspecs
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from repro_torch.tree import leaves

MESH = "h100"
#: the reference's meshes: one pod of 256 chips, two of 512
SHARDED = {"single": 256, "multi": 512}
META = SH.META
# Per-arch training knobs (memory-critical archs get 8-bit Adam).
EIGHT_BIT = {"arctic_480b", "llama_3_2_vision_90b", "mixtral_8x22b"}
# Chunk sizes per shape (attention q/k blocking).
CHUNKS = {"train_4k": (1024, 1024), "prefill_32k": (2048, 2048),
          "decode_32k": (1, 2048), "long_500k": (1, 4096)}
# RWKV6's WKV chunk in every cell: the reference's training step takes 64,
# its baseline prefill the per-token scan (chunk 1), whose 32768 x 32 layers
# of meta operations take over an hour; so the prefill takes 64 here too
# and ``rwkvchunk`` (the reference's name for it) is the baseline itself
RWKV_CHUNK = 64
VARIANTS = ("baseline", "rwkvchunk")
#: the reference's variants that the sharded meshes lower ("tpN": any N)
MESH_VARIANTS = ("dponly", "tpN", "seqpar", "widetp", "moegroup")


def _arch_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def build_tables(n_members: int, device=META):
    em = EpochManager(max_members=max(64, n_members))
    members = {i: MemberSpec(node_id=i) for i in range(n_members)}
    em.initialize(members, {i: 1.0 for i in range(n_members)})
    return em.device_tables(device)


def model_flops(cfg, shape) -> float:
    """6 N D (train) or 2 N_active D (prefill, decode: one token a lane);
    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec``."""
    s = SH.SHAPES[shape] if isinstance(shape, str) else shape
    n_total, n_active = cfg.param_count()
    if s.kind == "train":
        return 6.0 * n_active * s.global_batch * s.seq_len
    if s.kind == "prefill":
        return 2.0 * n_active * s.global_batch * s.seq_len
    return 2.0 * n_active * s.global_batch  # decode: one token


class MetaOnly(TorchDispatchMode):
    """Fails on any operation whose result lies off the meta device and
    holds data (an empty tensor holds none: ``torch.utils.checkpoint``
    makes one on the CPU for its hooks in some torch versions)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" and t.numel():
                raise RuntimeError(f"{func} gave a tensor on {t.device} in a meta dry run")
        return out


def tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def _nbytes(*trees) -> int:
    ts = [t for tree in trees for t in tensors(tree)]
    off = {str(t.device) for t in ts if t.device.type != "meta"}
    if off:
        raise RuntimeError(f"a dry run's input lies on {sorted(off)}, not on meta")
    return sum(t.numel() * t.element_size() for t in ts)


def _counted(fn) -> tuple[float, dict]:
    with FlopCounterMode(display=False) as fc, MetaOnly():
        fn()
    by_op = {str(op): float(n) for op, n in fc.get_flop_counts().get("Global", {}).items()}
    return float(fc.get_total_flops()), by_op


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of torch's fake process group of
    ``n_ranks`` (a ``FakeStore``: no other process, no network; its
    collectives move nothing), for the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tokens(variant: str) -> set:
    return set(variant.split("+")) if variant else {"baseline"}


def _tp_of(toks: set):
    tok = next((t for t in toks if t.startswith("tp") and t[2:].isdigit()), None)
    return None if tok is None else int(tok[2:])


def sharded_mesh(mesh_kind: str, variant: str) -> Mesh:
    """The reference's mesh of ``mesh_kind`` ("single", "multi") for the
    variant, bound to the process group (``fake_world``)."""
    toks = _tokens(variant)
    multi = mesh_kind == "multi"
    if "dponly" in toks:
        return LM.make_dp_mesh(multi_pod=multi)
    if _tp_of(toks):
        return LM.make_hybrid_mesh(_tp_of(toks), multi_pod=multi)
    return LM.make_production_mesh(multi_pod=multi)


def lower_cell(arch: str, shape_name: str, variant: str = "baseline", *, mesh: str = MESH,
               cfg=None) -> dict:
    """The cell's artifact (or ``{"skipped": reason}``) on the one card
    (``mesh="h100"``) or on the reference's mesh ``"single"`` or
    ``"multi"`` (inside ``fake_world`` of its size). ``cfg`` stands in for
    the arch's published config (a smoke config)."""
    refuse(variant, mesh)
    cfg = get_config(arch) if cfg is None else cfg
    reason = SH.skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh, "skipped": reason}
    spec = SH.SHAPES[shape_name]
    qc, kc = CHUNKS[shape_name]
    eight_bit = _arch_id(arch) in EIGHT_BIT
    rwkv_chunk = RWKV_CHUNK if cfg.family == "ssm" else 1
    toks = _tokens(variant)
    m = None if mesh == MESH else sharded_mesh(mesh, variant)
    if m is not None and "moegroup" in toks and cfg.family == "moe":
        cfg = cfg.with_(moe_dispatch_groups=shd.data_extent(m))
    batch = SH.batch_specs(cfg, shape_name)
    extra = {"rwkv_chunk": rwkv_chunk} if cfg.family == "ssm" else {}
    chips = dp = tp = 1
    if m is not None:
        chips, tp = SHARDED[mesh], shd.model_extent(m)
        dp = chips // tp
    rec = CollectiveRecord()
    if spec.kind == "train":
        tcfg = TS.TrainConfig(adamw=OPT.AdamWConfig(eight_bit=eight_bit), remat=True,
                              lb_ingest=True, q_chunk=qc, k_chunk=kc,
                              rwkv_chunk=rwkv_chunk)
        state = TS.init_train_state(None, cfg, tcfg, device=META)
        if m is None:
            tables = build_tables(1)
            step = TS.make_train_step(cfg, tcfg, Mesh(("data",), (1,)),
                                      global_batch=spec.global_batch)
        else:
            w = shd.data_extent(m)
            if spec.global_batch % w:
                raise SystemExit(f"{mesh} {variant}: a global batch of {spec.global_batch} "
                                 f"rows does not split over {w} data ranks")
            step = TS.jit_train_step(cfg, tcfg, m, {"params": state["params"]},
                                     global_batch=spec.global_batch,
                                     seqpar="seqpar" in toks)
            state = TS.shard_state(state, step.specs, m)
            rows = spec.global_batch // w
            batch = {k: v[:rows] for k, v in batch.items()}  # data rank 0's rows
            tables = build_tables(w)
            extra["param_leaves_split"] = _split_leaves(state["params"], step.specs["params"], m)
        arg_bytes = _nbytes(state["params"], state["opt"], batch, tables)
        with rec:
            flops, by_op = _counted(lambda: step(state, batch, tables))
        extra.update(lb_ingest=True, eight_bit_opt=eight_bit)
    else:
        params = M.init_params(cfg, None, device=META)
        state = None
        if not cfg.encoder_only:
            state = SH.decode_state_specs(cfg, shape_name)
            if spec.kind == "prefill" and cfg.family == "vlm":
                state["vision"] = None  # provided via batch at prefill
        if m is None:
            arg_bytes = _nbytes(params, batch, state)
            if cfg.encoder_only:
                fn = lambda: M.forward(params, batch, cfg, remat=False, q_chunk=qc, k_chunk=kc)
            elif spec.kind == "prefill":
                fn = lambda: M.prefill(params, batch, state, cfg, q_chunk=qc, k_chunk=kc,
                                       rwkv_chunk=rwkv_chunk)
            else:
                fn = lambda: M.decode_step(params, batch["tokens"], state, cfg, q_chunk=qc,
                                           k_chunk=kc)
            with torch.no_grad():
                flops, by_op = _counted(fn)
        else:
            specs = {"params": SS.param_specs(cfg, m, params, wide="widetp" in toks)}
            params = shd.shard_tree(params, specs["params"], m)
            if state is not None:
                specs["state"] = shardspecs.placed_state_shardings(cfg, m, state)
                state = shardspecs.shard_state(state, specs["state"], m)
            step = SS.ServeStep(cfg, m, specs, global_batch=spec.global_batch,
                                      seqpar="seqpar" in toks, q_chunk=qc, k_chunk=kc,
                                      rwkv_chunk=rwkv_chunk)
            batch = SS.batch_rows(batch, m, spec.global_batch)  # data rank 0's rows
            arg_bytes = _nbytes(params, batch, state)
            if cfg.encoder_only:
                fn = lambda: step.forward(params, batch)
            elif spec.kind == "prefill":
                fn = lambda: step.prefill(params, batch, state)
            else:
                fn = lambda: step.decode(params, batch["tokens"], state)
            extra["param_leaves_split"] = _split_leaves(params, specs["params"], m)
            extra["rows_split"] = SS.rows_split(m, spec.global_batch)
            with rec:
                flops, by_op = _counted(fn)
    est = perfmodel.estimate(cfg, shape_name, chips, dp, tp, eight_bit_opt=eight_bit)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "variant": variant,
        "chips": chips, "dp": dp, "tp": tp, **extra,
        "cost": {"flops": flops},
        "flops_by_op": by_op,
        "memory": {"argument_size_in_bytes": arg_bytes},
        "collectives": rec.stats().to_json(),
        "collectives_by_shape": rec.by_shape(),
        "analytic": est.to_json(),
        "model_flops": model_flops(cfg, shape_name),
    }


def _split_leaves(params, specs, mesh) -> dict:
    """The count of param leaves placed on each axis ("wide": on both)."""
    return {axis: sum(d is not None for d in leaves(shd.placed_dims(params, specs, mesh, axis)))
            for axis in ("data", "model", "wide")}


def refuse(variant: str, mesh: str = MESH) -> None:
    """Stops (``SystemExit``) on a cell that the dry run does not lower."""
    toks = _tokens(variant)
    mesh_toks = {t for t in toks if t in MESH_VARIANTS or _tp_of({t})}
    other = sorted(toks - set(VARIANTS) - mesh_toks)
    if other:
        raise SystemExit(f"variant {'+'.join(other)}: the dry run knows {VARIANTS} and, on "
                         f"the sharded meshes, {MESH_VARIANTS}")
    if mesh == MESH and mesh_toks:
        raise SystemExit(f"variant {'+'.join(sorted(mesh_toks))} places the reference's "
                         f"sharded meshes: run it with --mesh single|multi|both")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES))
    ap.add_argument("--mesh", default=MESH, choices=[MESH, "single", "multi", "both"],
                    help="the one card 'h100', or the reference's 256/512-chip meshes "
                         "on torch's fake process group")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    shapes = [args.shape] if args.shape else list(SH.SHAPES)
    for mesh in meshes:
        refuse(args.variant, mesh)

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for mesh in meshes:
        world = contextlib.nullcontext() if mesh == MESH else fake_world(SHARDED[mesh])
        with world:
            for arch in archs:
                for shape in shapes:
                    _one(arch, shape, mesh, args, failures)
    n = len(archs) * len(shapes) * len(meshes)
    print(f"\n{n} cells in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"{len(failures)} FAILURES")
        raise SystemExit(1)
    print("all cells ok")


def _one(arch: str, shape: str, mesh: str, args, failures: list) -> None:
    """Lower one cell, write its artifact and print its line."""
    tag = f"{_arch_id(arch)}__{shape}__{mesh}"
    if args.variant != "baseline":
        tag += f"__{args.variant}"
    t0 = time.perf_counter()
    try:
        art = lower_cell(arch, shape, args.variant, mesh=mesh)
    except Exception as e:  # one cell's failure is reported, the sweep goes on
        failures.append((tag, str(e)))
        print(f"[{tag}] FAIL: {e}", flush=True)
        traceback.print_exc()
        return
    art["lower_compile_s"] = time.perf_counter() - t0
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(art, f, indent=1)
    extra = ""
    if "cost" in art:
        flops = art["cost"]["flops"]  # rank 0's
        extra = (f" flops={flops:.3e} useful={art['model_flops'] / (flops * art['chips']):.3f}"
                 if flops else " flops=0")
        extra += f" wire={art['collectives']['total_wire_bytes']:.3e}"
    print(f"[{tag}] {art.get('skipped', 'ok')} ({art['lower_compile_s']:.2f}s){extra}",
          flush=True)


if __name__ == "__main__":
    main()
