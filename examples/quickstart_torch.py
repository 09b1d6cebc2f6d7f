"""Quickstart on the PyTorch/CUDA port: stream DAQ events through the EJ-FAT
load balancer into a small LM and train it for a few hundred steps.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 200] [--device cpu]

What it exercises: DAQ fleet (5 sources, synchronized event numbers) ->
9KB segmentation -> WAN reorder -> LB calendar routing (the ``lb_route``
kernel on the card, the only kernel it launches) -> per-lane reassembly
(the compute node's host-side numpy plan, ``DataPlane.make_reassembler``'s
default) -> token batches -> AdamW training. The port of the JAX package's
``examples/quickstart.py``, with ``--device`` (default ``cuda``; it raises
without CUDA) in place of ``--backend``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import EpochManager, MemberSpec  # noqa: E402
from repro_torch.data.daq import DAQConfig  # noqa: E402
from repro_torch.data.pipeline import StreamingPipeline, batches_from_bundles  # noqa: E402
from repro_torch.data.transport import TransportConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="where the data plane, the reassembly and the model run "
                         "(cuda launches the kernels)")
    return ap.parse_args(argv)


def make_pipeline(seq: int, device) -> StreamingPipeline:
    """The LB front end: 4 compute members, entropy over 4 lanes."""
    em = EpochManager(max_members=16)
    em.initialize({i: MemberSpec(node_id=i, lane_bits=2) for i in range(4)},
                  {i: 1.0 for i in range(4)})
    return StreamingPipeline(
        DAQConfig(n_daqs=5, seq_len=seq, mean_bundle_bytes=12_000, seed=0),
        TransportConfig(reorder_window=32, seed=0), em, device=device)


def model_config() -> ModelConfig:
    """A ~10M-param LM (same block as the full configs)."""
    return ModelConfig(name="quickstart-lm", family="dense", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, d_ff=704,
                       vocab=256, dtype="float32")


def train_config(steps: int) -> TS.TrainConfig:
    return TS.TrainConfig(adamw=OPT.AdamWConfig(lr=3e-4, warmup_steps=20,
                                                decay_steps=steps),
                          remat=False, lb_ingest=False, q_chunk=64, k_chunk=64)


def train(pipe, cfg, state, step, steps: int, seq: int, batch: int) -> list[float]:
    """Pump triggers through the LB and train on the reassembled bundles
    until ``steps`` steps ran; returns every step's loss."""
    losses, seen = [], 0
    while seen < steps:
        payloads = pipe.pump(6)
        for b in batches_from_bundles(payloads, seq, batch):
            t = b % cfg.vocab
            state, metrics = step(state, {"tokens": t, "labels": t}, None)
            losses.append(float(metrics["loss"]))
            seen += 1
            if seen % 25 == 0:
                print(f"step {seen:4d}  loss {np.mean(losses[-25:]):.4f}  "
                      f"lb: routed={pipe.stats.n_routed} "
                      f"members={dict(sorted(pipe.stats.per_member.items()))}")
            if seen >= steps:
                break
    return losses


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    pipe = make_pipeline(args.seq, dev)
    cfg = model_config()
    n_params, _ = cfg.param_count()
    print(f"model: {n_params/1e6:.1f}M params")

    tcfg = train_config(args.steps)
    state = TS.init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, tcfg, dev)
    step = TS.make_train_step(cfg, tcfg)
    losses = train(pipe, cfg, state, step, args.steps, args.seq, args.batch)
    print(f"\nfinal loss {np.mean(losses[-10:]):.4f} (start {np.mean(losses[:10]):.4f})")
    emap = pipe.event_member_map()
    assert all(len(m) == 1 for m in emap.values())
    print(f"event atomicity: OK over {len(emap)} events; "
          f"dropped={pipe.stats.n_discarded}")
    print(_lib.launch_line(), file=sys.stderr, flush=True)
    return losses, pipe


if __name__ == "__main__":
    main()
