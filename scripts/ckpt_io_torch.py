#!/usr/bin/env python3
"""Time the port's checkpoint of a training state on one CUDA card, in its
parts. The state is ``chip_smoke.py``'s ``[train]`` state: Yi-6B at full
width, ``--layers`` of its 32 layers, bf16 params, float32 moments, random.

- host copy: ``ckpt.host_arrays`` (stack each per-layer list on the card,
  copy to the host, widen bf16 to float32), which ``AsyncSaver.save`` runs
  on the caller's thread;
- write: ``np.savez`` of those arrays into ``arrays.npz``, the saver
  thread's work (``ckpt.save`` from the host arrays);
- disk: the same bytes written by ``ndarray.tofile`` into one plain file,
  the rate of the file system without the zip stream (the file is deleted
  at once);
- np.load: every member of the npz read through ``np.load`` (the zip
  stream, 256 KiB at a time), with no copy to the card;
- restore: ``ckpt.restore_into`` the state in place (the npz mapped, each
  leaf copied to the card and cast).

    python scripts/ckpt_io_torch.py [--layers 8] [--dir build/ckpt_io]

The file was just written, so the reads come from the host's page cache as
a resume right after a save does. Prints the card line and one JSON object
(seconds, GB of the npz, GB/s); ``--dir`` is removed at the end.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--dir", default=str(ROOT / "build" / "ckpt_io"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a GPU")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.train import train_step as TS

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = get_config("yi-6b").with_(n_layers=args.layers)
    st = TS.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                             TS.TrainConfig(), "cuda")
    tree = {"params": st["params"], "opt": st["opt"], "step": st["step"]}
    d = Path(args.dir)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    out = {"layers": args.layers}

    arrays, out["host_copy_s"] = clock(lambda: ckpt.host_arrays(tree))
    gb = sum(a.nbytes for a in arrays.values()) / 1e9

    def raw():
        with open(d / "raw.bin", "wb") as f:
            for a in arrays.values():
                a.tofile(f)

    _, out["disk_tofile_s"] = clock(raw)
    (d / "raw.bin").unlink()
    _, out["write_savez_s"] = clock(lambda: ckpt._write(str(d), 1, arrays, None))
    del arrays

    def np_load():
        with np.load(d / "step_00000001" / "arrays.npz") as z:
            return sum(z[k].nbytes for k in z.files)

    _, out["np_load_s"] = clock(np_load)
    probe = [st["params"]["embed"], st["opt"]["mu"]["layers"][0]["attn"]["wq"]["m"]]
    saved = [t.clone() for t in probe]
    for t in probe:  # what the restore must overwrite
        t.add_(1)
    step, out["restore_into_s"] = clock(lambda: ckpt.restore_into(str(d), tree))
    if step != 1 or not all(torch.equal(a, b) for a, b in zip(probe, saved)):
        print("FAIL: the restored state differs from the saved one")
        return 1
    out["npz_gb"] = gb
    for k in ("host_copy", "disk_tofile", "write_savez", "np_load", "restore_into"):
        out[k + "_gb_per_s"] = gb / out[k + "_s"]
    shutil.rmtree(d, ignore_errors=True)
    print(cs.card_line())
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
