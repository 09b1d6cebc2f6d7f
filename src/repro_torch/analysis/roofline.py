"""Three-term roofline from dry-run artifacts, on one NVIDIA H100.

Port of the JAX package's ``repro/analysis/roofline.py`` with the chip's
constants as an argument (``Chip``; ``H100`` by default)::

    compute term    = FLOPs per device / peak FLOP/s        [bf16 dense]
    memory term     = bytes per device / HBM bytes/s
    collective term = wire bytes per device * wire_correction / link bytes/s

The compute and memory terms read the analytic model
(``analysis/perfmodel.py``), so they count the same work whatever implements
it; ``useful_ratio`` = model FLOPs / counted FLOPs exposes what the
implementation adds (a plain attention's masked half, remat). The H100's
correction is 1: the port reads no CPU HLO text, whose widened bf16
buffers the reference halves. MODEL_FLOPS = 6*N*D (train) or 2*N_active*D
(prefill/decode).
"""
from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float      # FLOP/s of one chip
    hbm_bw: float          # bytes/s of one chip's device memory
    link_bw: float         # bytes/s of one link, one direction
    wire_correction: float = 1.0


#: NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, the card
#: ``nvidia-smi`` names in PERF.md: dense bf16 tensor-core peak, HBM3, NVLink
#: per direction (NVIDIA's data sheet)
H100 = Chip("NVIDIA H100 80GB HBM3 (SXM), 700 W", peak_flops=989.4e12, hbm_bw=3.35e12,
            link_bw=450e9)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    step_time_s: float
    hw_utilization: float  # model_flops / (step_time * chips * peak)
    roofline_fraction: float  # max(compute, memory) / step — how close the
    # projected step sits to its unavoidable (compute|memory) bound; the
    # right score for memory-bound decode shapes where compute-MFU ~ 0.

    def to_json(self):
        return dataclasses.asdict(self)


def analyze(artifact: dict, chip: Chip = H100) -> Roofline:
    """Terms: compute/memory from the analytic per-device model, the
    collective term from the artifact's wire bytes (0 on one card)."""
    chips = artifact["chips"]
    fpd = float(artifact["analytic"]["flops"])
    bpd = float(artifact["analytic"]["bytes_hbm"])
    wire = float(artifact["collectives"]["total_wire_bytes"]) * chip.wire_correction
    model_flops = float(artifact.get("model_flops", 0.0))

    compute_s = fpd / chip.peak_flops
    memory_s = bpd / chip.hbm_bw
    collective_s = wire / chip.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    useful = model_flops / (fpd * chips) if fpd else 0.0
    hw_util = model_flops / (step * chips * chip.peak_flops) if step > 0 else 0.0
    bound = max(compute_s, memory_s)
    return Roofline(
        arch=artifact["arch"].replace("-", "_").replace(".", "_"),
        shape=artifact["shape"], mesh=artifact["mesh"],
        chips=chips, flops_per_device=fpd, bytes_per_device=bpd,
        wire_bytes_per_device=wire, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, useful_ratio=useful, step_time_s=step,
        hw_utilization=hw_util,
        roofline_fraction=bound / step if step > 0 else 0.0,
    )


def against(est, model_flops: float, seconds: float, chip: Chip = H100) -> dict:
    """A measured step (``seconds`` on ``chip``) against its analytic work
    ``est`` (a ``perfmodel.PerfEstimate`` on one chip): ``mfu`` = model
    FLOPs / (seconds x peak), ``roofline_fraction`` = max(compute, memory
    term) / seconds. Neither can pass 1 unless the count or the clock is
    wrong."""
    compute_s = est.flops / chip.peak_flops
    memory_s = est.bytes_hbm / chip.hbm_bw
    return dict(model_flops=model_flops, analytic_flops=est.flops,
                analytic_bytes=est.bytes_hbm, compute_ms=compute_s * 1e3,
                memory_ms=memory_s * 1e3,
                bound_by="compute" if compute_s >= memory_s else "memory",
                mfu=model_flops / (seconds * chip.peak_flops),
                roofline_fraction=max(compute_s, memory_s) / seconds)


def load_artifacts(art_dir: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(art_dir)):
        if f.endswith(".json"):
            with open(os.path.join(art_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def markdown_table(rooflines: list[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "bottleneck | useful FLOP ratio | roofline util |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in rooflines:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.4g} | "
            f"{r.memory_s:.4g} | {r.collective_s:.4g} | **{r.bottleneck}** | "
            f"{r.useful_ratio:.3f} | {r.hw_utilization:.3f} |"
        )
    return hdr + "\n".join(rows) + "\n"
