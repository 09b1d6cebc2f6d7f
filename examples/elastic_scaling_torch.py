"""Elastic scaling + straggler mitigation + failure recovery on the
PyTorch/CUDA port — the paper's fig-7c scenario driven by the control plane
during a live training run.

    PYTHONPATH=src python examples/elastic_scaling_torch.py [--device cpu]

Timeline:
  steps  0-19 : 4 members, uniform weights
  step    20 : member 3 FAILS -> hit-lessly removed from the next epoch
  steps 21-39: member 2 is a 3x straggler -> PI controller sheds its slots
  step    40 : two fresh members join (scale-out)

The port of the JAX package's ``examples/elastic_scaling.py``, with
``--device`` (default ``cuda``; it raises without CUDA) and ``--ckpt-dir``
(default: a fresh directory under the system's temporary directory).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.calendar import calendar_counts  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

#: steps before the failure, with the straggler, after the scale-out
TIMELINE = (20, 20, 10)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model and the trainer run")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    return ap.parse_args(argv)


def shares(trainer, n=8):
    em = trainer.manager
    cal = em.state.calendars[em.current_epoch]
    c = calendar_counts(cal, n)
    return {i: int(v) for i, v in enumerate(c) if v > 0}


def make_trainer(device, ckpt_dir: str) -> Trainer:
    cfg = get_smoke_config("yi_6b")
    tcfg = TS.TrainConfig(adamw=OPT.AdamWConfig(lr=1e-3), remat=False,
                          lb_ingest=False, q_chunk=16, k_chunk=16)
    return Trainer(cfg, tcfg, TrainerConfig(n_members=4, ckpt_dir=ckpt_dir,
                                            ckpt_every=10, recalendar_every=5,
                                            device=str(device)))


def timeline(tr: Trainer, steps=TIMELINE, batch=4, seq=16) -> dict:
    """Fail member 3 after ``steps[0]`` steps, straggle member 2 (3x) for
    ``steps[1]``, add members 6 and 7 and run ``steps[2]``; returns the
    calendar shares after each event."""
    out = {"epoch0": shares(tr)}
    print("epoch 0 calendar shares:", out["epoch0"])
    tr.run(steps[0], batch=batch, seq=seq)

    print("\n-- member 3 fails --")
    tr.handle_failure([3])
    out["after_failure"] = shares(tr)
    print("next-epoch shares:", out["after_failure"])

    # straggler: member 2 reports 3x step time
    orig = tr.hub.report_step
    tr.hub.report_step = lambda m, dt, **kw: orig(m, dt * (3.0 if m == 2 else 1.0), **kw)
    tr.run(steps[1], batch=batch, seq=seq)
    out["after_straggler"] = shares(tr)
    print(f"\n-- after {steps[1]} steps with member 2 straggling (3x) --")
    print("shares:", out["after_straggler"])

    print("\n-- scale out: members 6, 7 join --")
    tr.hub.report_step = orig
    tr.add_members([6, 7])
    out["after_scale_out"] = shares(tr)
    print("next-epoch shares:", out["after_scale_out"])
    tr.run(steps[2], batch=batch, seq=seq)
    return out


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_elastic_ckpt_")
    tr = make_trainer(dev, ckpt_dir)
    tr.init_or_restore(torch.Generator(device=dev).manual_seed(0))
    out = timeline(tr)

    losses = [h["loss"] for h in tr.history]
    print(f"\ntrained {len(losses)} steps through 4 epochs; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print("audit tail:", tr.manager.audit[-6:])
    print(_lib.launch_line(), file=sys.stderr, flush=True)
    return tr, out


if __name__ == "__main__":
    main()
