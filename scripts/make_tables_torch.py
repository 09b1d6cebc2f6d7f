"""Render the port's dry-run tables from its artifacts.

    PYTHONPATH=src python scripts/make_tables_torch.py artifacts/dryrun_torch > tables.md

reads the JSON artifacts that ``python -m repro_torch.launch.dryrun --out
DIR`` writes (one per cell: the one-card ``h100`` mesh and the reference's
``single``/``multi`` meshes) and prints the dry-run matrix, one roofline
table per mesh and the variants against their baselines, on the chip that
``--chip`` names: by default ``repro_torch.analysis.roofline.H100``, or
``--chip "NAME,PEAK_FLOPS,HBM_BYTES_PER_S,LINK_BYTES_PER_S[,WIRE_CORRECTION]"``
for another. The single- and multi-pod tables are printed even when empty,
the one-card table only when such cells are there.

``--tournament`` renders ranked policy-tournament tables instead, from the
JSON summaries ``python -m repro_torch.simnet.run --tournament ... --json``
writes:

    PYTHONPATH=src python scripts/make_tables_torch.py --tournament t1.json t2.json

The port of the JAX package's ``scripts/make_tables.py`` (without its
``--bench``); fed the same artifacts and that chip's constants it prints the
same text.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
from repro_torch.analysis import roofline as RL  # noqa: E402

#: roofline sections: (mesh, title), the reference's pods first
MESH_TITLES = (("single", "single pod (256 chips)"), ("multi", "multi pod (512 chips)"),
               ("h100", "one card (1 chip)"))


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def parse_chip(spec: str) -> RL.Chip:
    """``NAME,PEAK_FLOPS,HBM_BYTES_PER_S,LINK_BYTES_PER_S[,WIRE_CORRECTION]``."""
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) not in (4, 5):
        raise ValueError(f"--chip wants NAME,PEAK,HBM,LINK[,CORRECTION], got {spec!r}")
    return RL.Chip(parts[0], *(float(x) for x in parts[1:]))


def dry_run_tables(art_dir: str, chip: RL.Chip) -> None:
    arts = RL.load_artifacts(art_dir)
    skips = [a for a in arts if "skipped" in a]
    cells = [a for a in arts if "skipped" not in a]
    base = [a for a in cells if a.get("variant", "baseline") == "baseline"]
    vari = [a for a in cells if a.get("variant", "baseline") != "baseline"]

    # ---- Dry-run table -------------------------------------------------------
    print("### Dry-run compilation matrix\n")
    print("| arch | shape | mesh | chips | compile s | HLO args/dev "
          "| temps/dev | collective ops (static) |")
    print("|---|---|---|---|---|---|---|---|")
    for a in sorted(base, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        mem = a.get("memory", {})
        args = fmt_bytes(mem.get("argument_size_in_bytes", 0))
        temps = fmt_bytes(mem.get("temp_size_in_bytes", 0))
        ops = sum(a["collectives"]["ops"].values())
        print(f"| {a['arch']} | {a['shape']} | {a['mesh']} | {a['chips']} | "
              f"{a.get('lower_compile_s', 0):.1f} | {args} | {temps} | {ops} |")
    print("\n**Documented skips** (DESIGN.md §4):\n")
    seen = set()
    for a in sorted(skips, key=lambda x: (x["arch"], x["shape"])):
        key = (a["arch"], a["shape"])
        if key in seen:
            continue
        seen.add(key)
        print(f"- {a['arch']} x {a['shape']}: {a['skipped']}")

    # ---- Roofline tables ------------------------------------------------------
    for mesh_kind, title in MESH_TITLES:
        rows = [RL.analyze(a, chip) for a in base if a["mesh"] == mesh_kind]
        if mesh_kind == "h100" and not rows:
            continue
        rows.sort(key=lambda r: (r.arch, r.shape))
        print(f"\n### Roofline — baseline, {title}\n")
        print(RL.markdown_table(rows))

    # ---- Variants -------------------------------------------------------------
    if vari:
        print("\n### Perf variants (beyond-paper)\n")
        print("| arch | shape | mesh | variant | collective s | step s | util | vs baseline |")
        print("|---|---|---|---|---|---|---|---|")
        base_by = {(a["arch"], a["shape"], a["mesh"]): RL.analyze(a, chip) for a in base}
        for a in sorted(vari, key=lambda x: (x["arch"], x["shape"], x["variant"])):
            r = RL.analyze(a, chip)
            b = base_by.get((a["arch"], a["shape"], a["mesh"]))
            speed = f"{b.step_time_s / r.step_time_s:.2f}x" if b else "-"
            print(f"| {r.arch} | {r.shape} | {r.mesh} | {a['variant']} | "
                  f"{r.collective_s:.4g} | {r.step_time_s:.4g} | "
                  f"{r.hw_utilization:.3f} | {speed} |")


def tournament_tables(paths) -> int:
    """Ranked-p99 tables from ``simnet.run --tournament`` JSON summaries."""
    if not paths:
        print("usage: make_tables_torch.py --tournament summary.json [...]",
              file=sys.stderr)
        return 2
    for path in paths:
        with open(path) as f:
            summary = json.load(f)
        t = summary.get("tournament")
        if not t:
            print(f"{path}: no 'tournament' block "
                  f"(run python -m repro_torch.simnet.run --tournament ... --json)",
                  file=sys.stderr)
            return 1
        print(f"### Policy tournament — scenario `{t['scenario']}` "
              f"({t['steps']} steps, seed {t['seed']})\n")
        print("| rank | policy | p50 (ms) | p99 (ms) | vs best (ms) "
              "| timeouts | queue drops |")
        print("|---|---|---|---|---|---|---|")
        for leg in t["ranked"]:
            print(f"| {leg['rank']} | {leg['policy']} "
                  f"| {leg['latency_p50_s'] * 1e3:.3f} "
                  f"| {leg['latency_p99_s'] * 1e3:.3f} "
                  f"| +{leg['p99_vs_best_s'] * 1e3:.3f} "
                  f"| {leg['bundles_timed_out']} "
                  f"| {leg['packets_dropped_queue']} |")
        print()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tournament", nargs="*", default=None, metavar="JSON",
                    help="render tournament summaries instead of the dry run")
    ap.add_argument("--chip", default=None,
                    help="NAME,PEAK_FLOPS,HBM_BYTES_PER_S,LINK_BYTES_PER_S"
                         "[,WIRE_CORRECTION] (default: roofline.H100)")
    ap.add_argument("art_dir", nargs="?", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.tournament is not None:
        return tournament_tables(args.tournament)
    dry_run_tables(args.art_dir, parse_chip(args.chip) if args.chip else RL.H100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
