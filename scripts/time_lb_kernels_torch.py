#!/usr/bin/env python3
"""Time the port's LB kernels, ``lb_route`` and ``dispatch_plan``, of one
source tree on one CUDA card, each against its plain version.

    python scripts/time_lb_kernels_torch.py [--src SRC] [--window N] [--tick N]

Times, in ms, with ``chip_smoke.py``'s timing code and inputs:

- at stream width (2^20 packets, L2 evicted before every call,
  ``time_on_card``): ``lb_route`` over 4 stacked 512-member instances with
  random instance ids, with every instance id 0 (the same tables and
  headers: what the divergence of a warp's instance ids costs), and over
  one instance; ``dispatch_plan`` on the routed members (M = 512);
- at the main path's sizes with the inputs in L2 (``time_warm``, graphs of
  200 calls): ``lb_route`` and ``dispatch_plan`` at the closed loop's window
  ``--window`` (the full-width loop's median; ``chip_smoke.py`` prints it),
  ``lb_route`` at a serving tick of ``--tick`` requests.

``--src`` (default: this checkout's ``src/``) may point at the ``src/`` of
another checkout, such as an unpacked parent commit: its kernels are built
and timed with the same inputs and code, so two trees compare in one call on
one card (run them in turns: parent, change, change, parent). Prints the
card line and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--window", type=int, default=16384)
    ap.add_argument("--tick", type=int, default=12)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.dataplane import DataPlane
    from repro_torch.core.protocol import words_to_tensor
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import dispatch_plan
    from repro_torch.kernels.lb_route import lb_route

    if not Path(ref.__file__).resolve().is_relative_to(src):
        print(f"FAIL: repro_torch came from {ref.__file__}, not {src}")
        return 1
    rng = np.random.default_rng(11)
    vlb, base, span = cs.full_width_tables(np, rng)
    words, _ = cs.full_width_headers(np, rng, base, span)
    hdr = words_to_tensor(words, "cuda")
    iid = torch.from_numpy(rng.integers(0, cs.N_INST, cs.N_FULL).astype(np.int32)).cuda()
    iid0 = torch.zeros_like(iid)
    stacked = DataPlane.from_instances(vlb.instances, device="cuda").tables
    single = DataPlane.from_manager(vlb.instances[0], device="cuda").tables
    times = {}

    def timed(name, fn, want):
        ms, last = cs.time_on_card(torch, fn)
        cs.check_equal(torch, name, last, want)
        times[name] = ms

    timed("lb_route_4x512_random_ids_2^20", lambda: lb_route(hdr, stacked, iid),
          ref.lb_route_ref(hdr, stacked, iid))
    timed("lb_route_4x512_ids_all_0_2^20", lambda: lb_route(hdr, stacked, iid0),
          ref.lb_route_ref(hdr, stacked, iid0))
    timed("lb_route_1x512_2^20", lambda: lb_route(hdr, single), ref.lb_route_ref(hdr, single))
    member = lb_route(hdr, stacked, iid)[0]
    timed("dispatch_plan_m512_2^20", lambda: dispatch_plan(member, n_members=cs.MAX_MEMBERS),
          ref.dispatch_plan_ref(member, n_members=cs.MAX_MEMBERS))
    main_path = cs.main_path_sizes(torch, np, args.window, args.tick)
    print(cs.card_line())
    print(json.dumps(dict(src=str(src), times_ms=times, main_path=main_path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
