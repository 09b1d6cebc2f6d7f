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
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh
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

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.demo else get_config(args.arch)
    tcfg = TS.TrainConfig(
        adamw=OPT.AdamWConfig(lr=1e-3, eight_bit=args.eight_bit,
                              decay_steps=max(args.steps, 10)),
        remat=not args.demo, lb_ingest=args.lb_ingest,
        grad_compress=args.grad_compress,
        q_chunk=min(args.seq, 1024), k_chunk=min(args.seq, 1024),
    )
    tr = Trainer(cfg, tcfg, TrainerConfig(n_members=4, ckpt_dir=args.ckpt_dir,
                                          use_controld=args.controld, device=str(dev)),
                 mesh=Mesh(("data",), (1,)) if args.lb_ingest else None)
    start = tr.init_or_restore(torch.Generator(device=dev).manual_seed(0))
    print(f"arch={cfg.name} params={cfg.param_count()[0]/1e6:.1f}M "
          f"resume_step={start}")
    hist = tr.run(args.steps, batch=args.batch, seq=args.seq)
    losses = [h["loss"] for h in hist]
    print(f"steps={len(losses)} loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return tr


if __name__ == "__main__":
    main()
