"""Serving through the LB front door on the PyTorch/CUDA port: batched
requests are events; the calendar picks the replica, the entropy field picks
the decode lane (RSS). Submissions accumulate and are routed lazily — one
batched ``lb_route`` launch per engine tick, not one per request; each
prefill attends through ``flash_attention`` on the card. Mid-run, a replica
is drained hit-lessly (weight -> 0 in the next epoch).

    PYTHONPATH=src python examples/serve_lb_torch.py [--device cpu]

The port of the JAX package's ``examples/serve_lb.py``, with ``--device``
(default ``cuda``; it raises without CUDA) in place of ``--backend``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model, the caches and the data plane live "
                         "(cuda launches the kernels)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("yi_6b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(cfg, ServeConfig(n_replicas=3, lane_bits=1,
                                         max_len=96, device=str(dev)),
                        params)
    rng = np.random.default_rng(0)

    print("phase 1: 12 requests across 3 replicas")
    reqs = [eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))),
                       max_new_tokens=8) for _ in range(12)]
    eng.run_until_done()
    print("  routed per replica:", dict(sorted(eng.stats["routed"].items())),
          f"({eng.stats['route_calls']} batched route calls)")
    print("  completed:", eng.stats["completed"])

    print("\nphase 2: drain replica 1 (weight 0 in next epoch, hit-less)")
    eng.cp.weights[1] = 0.0
    eng.cp.schedule_epoch(eng.next_event, boundary=eng.next_event)
    before = dict(eng.stats["routed"])
    reqs2 = [eng.submit(rng.integers(0, cfg.vocab, 6), max_new_tokens=6)
             for _ in range(12)]
    eng.run_until_done()
    after = eng.stats["routed"]
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in (0, 1, 2)}
    print("  new requests per replica:", delta)
    assert delta[1] == 0, "drained replica must receive no new work"
    assert all(r.done for r in reqs + reqs2)
    print("  drained OK; all", len(reqs) + len(reqs2), "requests completed")
    print(_lib.launch_line(), file=sys.stderr, flush=True)
    return eng, delta


if __name__ == "__main__":
    main()
