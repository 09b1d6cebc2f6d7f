"""Training launcher.

The port of ``repro.launch.train``: the same arguments, plus ``--device``
(default ``cuda``) and ``--lb-ingest``.

  * --demo : run real steps with the arch's smoke config (exercises the full
    trainer: LB epochs, telemetry, checkpointing, straggler mitigation).
  * default: the arch's published config.

The reference launcher trains with ``lb_ingest=False``; so does this one
unless ``--lb-ingest`` is given, which routes every step's batch through the
LB calendar (the ``lb_route`` kernel on the card) over a one-process
("data",) mesh. It prints the reference's two lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --demo --steps 12 \\
        --batch 2 --seq 16 [--controld] --ckpt-dir build/train_ckpt --device cpu

A run resumes from the latest checkpoint under ``--ckpt-dir``; its default
lies under ``tempfile.gettempdir()`` and is the port's own.

Under ``torch.distributed.run`` (which sets ``RANK``/``WORLD_SIZE``) the
launcher trains over W data-parallel ranks: a process group (gloo with
``--device cpu``, NCCL with ``--device cuda``, one card per rank), the
("data", "model") mesh (W, 1), params and moments placed by
``param_sharding``, checkpoints written whole by rank 0; rank 0 prints.
The ranks end together, their groups released before the process group is
destroyed.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --demo --steps 12 --batch 4 --seq 16 \
        --ckpt-dir build/train_dp --device cpu
"""
from __future__ import annotations

import argparse
import gc
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"),
                    help="checkpoints go here, and a run resumes from the latest "
                         "one found (default: under the temporary directory, $TMPDIR)")
    ap.add_argument("--eight-bit", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--controld", action="store_true",
                    help="run the ingest control plane as a controld "
                         "session: DP workers register as leased members "
                         "and heartbeat in one batch per recalendar")
    ap.add_argument("--lb-ingest", action="store_true",
                    help="route each step's batch through the LB calendar and "
                         "pack it per member (one-process mesh)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ranks = int(os.environ.get("WORLD_SIZE", "0"))
    if ranks and not dist.is_initialized():  # started by torch.distributed.run
        if str(args.device).startswith("cuda"):
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            args.device = f"cuda:{torch.cuda.current_device()}"
        dist.init_process_group("nccl" if str(args.device).startswith("cuda") else "gloo")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.demo else get_config(args.arch)
    tcfg = TS.TrainConfig(
        adamw=OPT.AdamWConfig(lr=1e-3, eight_bit=args.eight_bit,
                              decay_steps=max(args.steps, 10)),
        remat=not args.demo, lb_ingest=args.lb_ingest,
        grad_compress=args.grad_compress,
        q_chunk=min(args.seq, 1024), k_chunk=min(args.seq, 1024),
    )
    if dist.is_initialized():
        mesh = make_debug_mesh(dist.get_world_size(), 1)
    else:
        mesh = Mesh(("data",), (1,)) if args.lb_ingest else None
    say = print if not dist.is_initialized() or dist.get_rank() == 0 else (lambda *a: None)
    tr = Trainer(cfg, tcfg, TrainerConfig(n_members=4, ckpt_dir=args.ckpt_dir,
                                          use_controld=args.controld, device=str(dev)),
                 mesh=mesh)
    start = tr.init_or_restore(torch.Generator(device=dev).manual_seed(0))
    say(f"arch={cfg.name} params={cfg.param_count()[0]/1e6:.1f}M "
        f"resume_step={start}")
    hist = tr.run(args.steps, batch=args.batch, seq=args.seq)
    losses = [h["loss"] for h in hist]
    say(f"steps={len(losses)} loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if ranks:
        # Every rank done with its collectives, and no group left referenced
        # when the process group goes: a gloo group that outlives
        # ``destroy_process_group`` is torn down at interpreter exit, after
        # the runtime its threads need, and the process aborts ("terminate
        # called without an active exception", seen on ~1 in 20 two-rank
        # runs under load, after the run's last line was printed).
        dist.barrier()
        del tr, mesh
        gc.collect()
        dist.destroy_process_group()
        return None
    return tr


if __name__ == "__main__":
    main()
