"""Dry run of every (arch x shape) cell on the meta device, on the one-card
mesh: the counterpart of the JAX package's ``repro/launch/dryrun.py`` for one
H100 (``mesh="h100"``, chips = dp = tp = 1).

For each cell, at the published config, the params and the optimizer state
(train) or the decode state (prefill, decode) are built on
``device="meta"``: shapes and dtypes, no storage. The step the reference
lowers then runs under ``torch.utils.flop_counter.FlopCounterMode``:

- train: the LB ingest, ``train_loss`` forward and backward with remat, and
  the AdamW update (8-bit moments for ``EIGHT_BIT``), through
  ``train_step.make_train_step``;
- prefill: ``model.prefill`` (``model.forward`` for the encoder);
- decode: ``model.decode_step``.

The kernel wrappers take their plain versions on meta tensors, so nothing
computes; an operation whose result lies off the meta device fails the cell.
The JSON artifact has the reference's keys: ``cost.flops`` (the counted
FLOPs: matmul-like ops only, every product the plain path computes),
``memory.argument_size_in_bytes`` (params, optimizer state, batch, tables
and decode state; temporaries are not counted), ``collectives`` (none on one
card), ``analytic`` (``analysis/perfmodel.py``), ``model_flops`` and
``lower_compile_s`` (the cell's seconds). ``analysis/roofline.py`` of either
package reads it.

Usage:
    python -m repro_torch.launch.dryrun --arch yi_6b --shape prefill_32k --out DIR
    python -m repro_torch.launch.dryrun --all --out DIR

Variants: ``baseline`` and ``rwkvchunk`` (the same cells here: RWKV6
prefills with the chunked WKV in both, see ``RWKV_CHUNK``). The
reference's mesh variants and its 256/512-chip meshes (``launch.mesh``)
are not lowered yet: the CLI refuses them (the dry run on a fake process
group is ROADMAP.md queue 1, item 1(b)).
"""
from __future__ import annotations

import argparse
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.epoch import EpochManager
from repro_torch.core.tables import MemberSpec
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import shapes as SH
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

MESH = "h100"
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
#: the reference's mesh variants, which the dry run does not lower yet
SHARDED_ONLY = ("dponly", "tpN", "seqpar", "widetp", "moegroup")


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
    """Fails on any operation whose result lies off the meta device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
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


def lower_cell(arch: str, shape_name: str, variant: str = "baseline") -> dict:
    """The cell's artifact (or ``{"skipped": reason}``), on one card."""
    refuse_sharded(variant)
    cfg = get_config(arch)
    reason = SH.skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": MESH, "skipped": reason}
    spec = SH.SHAPES[shape_name]
    qc, kc = CHUNKS[shape_name]
    eight_bit = _arch_id(arch) in EIGHT_BIT
    rwkv_chunk = RWKV_CHUNK if cfg.family == "ssm" else 1
    batch = SH.batch_specs(cfg, shape_name)
    extra = {"rwkv_chunk": rwkv_chunk} if cfg.family == "ssm" else {}
    if spec.kind == "train":
        tcfg = TS.TrainConfig(adamw=OPT.AdamWConfig(eight_bit=eight_bit), remat=True,
                              lb_ingest=True, q_chunk=qc, k_chunk=kc,
                              rwkv_chunk=rwkv_chunk)
        state = TS.init_train_state(None, cfg, tcfg, device=META)
        mesh = Mesh(("data",), (1,))
        tables = build_tables(1)
        step = TS.make_train_step(cfg, tcfg, mesh, global_batch=spec.global_batch)
        arg_bytes = _nbytes(state["params"], state["opt"], batch, tables)
        flops, by_op = _counted(lambda: step(state, batch, tables))
        extra.update(lb_ingest=True, eight_bit_opt=eight_bit)
    else:
        params = M.init_params(cfg, None, device=META)
        if spec.kind == "prefill" and cfg.encoder_only:
            arg_bytes = _nbytes(params, batch)
            fn = lambda: M.forward(params, batch, cfg, remat=False, q_chunk=qc, k_chunk=kc)
        elif spec.kind == "prefill":
            state = SH.decode_state_specs(cfg, shape_name)
            if cfg.family == "vlm":
                state["vision"] = None  # provided via batch at prefill
            arg_bytes = _nbytes(params, batch, state)
            fn = lambda: M.prefill(params, batch, state, cfg, q_chunk=qc, k_chunk=kc,
                                   rwkv_chunk=rwkv_chunk)
        else:
            state = SH.decode_state_specs(cfg, shape_name)
            arg_bytes = _nbytes(params, batch, state)
            fn = lambda: M.decode_step(params, batch["tokens"], state, cfg, q_chunk=qc,
                                       k_chunk=kc)
        with torch.no_grad():
            flops, by_op = _counted(fn)
    est = perfmodel.estimate(cfg, shape_name, 1, 1, 1, eight_bit_opt=eight_bit)
    return {
        "arch": arch, "shape": shape_name, "mesh": MESH, "variant": variant,
        "chips": 1, "dp": 1, "tp": 1, **extra,
        "cost": {"flops": flops},
        "flops_by_op": by_op,
        "memory": {"argument_size_in_bytes": arg_bytes},
        "collectives": {"ops": {}, "dynamic_ops": {}, "payload_bytes": {}, "wire_bytes": {},
                        "total_payload_bytes": 0.0, "total_wire_bytes": 0.0},
        "analytic": est.to_json(),
        "model_flops": model_flops(cfg, shape_name),
    }


def refuse_sharded(variant: str) -> None:
    toks = set(variant.split("+"))
    other = sorted(toks - set(VARIANTS))
    if other:
        raise SystemExit(
            f"variant {'+'.join(other)}: only {VARIANTS} run on the one-card mesh; the "
            f"mesh variants ({', '.join(SHARDED_ONLY)}) are not lowered yet: the sharded dry "
            "run on the fake process group is ROADMAP.md queue 1, item 1(b)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES))
    ap.add_argument("--mesh", default=MESH, choices=[MESH, "single", "multi", "both"],
                    help="only the one-card mesh 'h100' runs; the reference's 256/512-chip "
                         "meshes are refused")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.mesh != MESH:
        raise SystemExit(
            f"mesh {args.mesh!r}: the reference's 256/512-chip meshes (launch.mesh) are not "
            f"lowered yet: the sharded dry run on the fake process group is ROADMAP.md queue "
            f"1, item 1(b); run --mesh {MESH}")
    refuse_sharded(args.variant)

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SH.SHAPES) if args.all or args.shape is None else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            tag = f"{_arch_id(arch)}__{shape}__{MESH}"
            if args.variant != "baseline":
                tag += f"__{args.variant}"
            t0 = time.perf_counter()
            try:
                art = lower_cell(arch, shape, args.variant)
            except Exception as e:  # one cell's failure is reported, the sweep goes on
                failures.append((tag, str(e)))
                print(f"[{tag}] FAIL: {e}", flush=True)
                traceback.print_exc()
                continue
            art["lower_compile_s"] = time.perf_counter() - t0
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(art, f, indent=1)
            extra = ""
            if "cost" in art:
                extra = (f" flops={art['cost']['flops']:.3e} "
                         f"useful={art['model_flops'] / art['cost']['flops']:.3f}"
                         if art["cost"]["flops"] else " flops=0")
            print(f"[{tag}] {art.get('skipped', 'ok')} ({art['lower_compile_s']:.2f}s){extra}",
                  flush=True)
    print(f"\n{len(archs) * len(shapes)} cells in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"{len(failures)} FAILURES")
        raise SystemExit(1)
    print("all cells ok")


if __name__ == "__main__":
    main()
