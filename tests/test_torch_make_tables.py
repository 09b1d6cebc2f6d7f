"""``scripts/make_tables_torch.py`` against the JAX package's
``scripts/make_tables.py`` on the CPU: fed the same dry-run artifacts and
the TPU v5e's constants (``--chip``) it prints the reference's tables; the
port's one-card (``h100``) cells add their own roofline section; the
tournament tables of a ``simnet.run --tournament`` summary are the
reference's; the default chip is the H100.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import roofline as RR
from repro_torch.analysis import roofline as TR
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.simnet import run as port_run

ROOT = Path(__file__).resolve().parents[1]
V5E_SPEC = f"TPU v5e,{RR.PEAK_FLOPS},{RR.HBM_BW},{RR.ICI_BW},{RR.BF16_CORRECTION}"


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _artifacts(d: Path, seed=0):
    """Reference-format cells on both pods: baselines, variants, skips."""
    rng = np.random.default_rng(seed)
    arts = []
    for arch in ("yi-6b", "mixtral_8x22b"):
        for shape in ("prefill_32k", "train_4k"):
            for mesh, chips in (("single", 256), ("multi", 512)):
                for variant in ("baseline", "tp4"):
                    arts.append({
                        "arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
                        "variant": variant, "lower_compile_s": float(rng.uniform(1, 90)),
                        "memory": {"argument_size_in_bytes": int(rng.integers(1e6, 1e11)),
                                   "temp_size_in_bytes": int(rng.integers(1e6, 1e10))},
                        "collectives": {"ops": {"all-reduce": int(rng.integers(0, 90)),
                                                "all-gather": int(rng.integers(0, 9))},
                                        "total_wire_bytes": float(rng.uniform(0, 1e12))},
                        "analytic": {"flops": float(rng.uniform(1e12, 1e16)),
                                     "bytes_hbm": float(rng.uniform(1e9, 1e12))},
                        "model_flops": float(rng.uniform(1e14, 1e18))})
    arts.append({"arch": "hubert_xlarge", "shape": "decode_32k", "mesh": "single",
                 "skipped": "encoder-only: no decode step"})
    arts.append({"arch": "hubert_xlarge", "shape": "decode_32k", "mesh": "multi",
                 "skipped": "encoder-only: no decode step"})
    for i, a in enumerate(arts):
        (d / f"cell{i:02d}.json").write_text(json.dumps(a))


def _tables(capsys, ref_dir, port_argv):
    _script("scripts/make_tables.py", "make_tables_ref").main(str(ref_dir))
    want = capsys.readouterr().out
    assert _script("scripts/make_tables_torch.py", "make_tables_torch").main(port_argv) == 0
    return capsys.readouterr().out, want


def test_dry_run_tables_equal_reference_on_its_chip(tmp_path, capsys):
    _artifacts(tmp_path)
    got, want = _tables(capsys, tmp_path, ["--chip", V5E_SPEC, str(tmp_path)])
    assert got == want
    assert "### Perf variants" in got and "hubert_xlarge x decode_32k" in got


def test_one_card_cells_add_a_section(tmp_path, capsys):
    """A port artifact of the one-card mesh (the Yi-6B smoke config's
    decode cell, lowered on the meta device) is read by both scripts; the
    port prints its roofline table, the rest is the reference's text."""
    _artifacts(tmp_path)
    art = D.lower_cell("yi_6b", "decode_32k", cfg=get_smoke_config("yi_6b"))
    (tmp_path / "yi_6b__decode_32k__h100.json").write_text(json.dumps(art))
    got, want = _tables(capsys, tmp_path, ["--chip", V5E_SPEC, str(tmp_path)])
    head = "\n### Roofline — baseline, one card (1 chip)\n\n"
    section = head + RR.markdown_table([RR.analyze(art)]) + "\n"
    assert section in got and got.replace(section, "", 1) == want
    got_h100, _ = _tables(capsys, tmp_path, [str(tmp_path)])
    assert TR.markdown_table([TR.analyze(art)]) in got_h100
    assert TR.markdown_table([TR.analyze(art)]) != RR.markdown_table([RR.analyze(art)])


def test_tournament_tables_equal_reference(tmp_path, capsys):
    summary = tmp_path / "t.json"
    assert port_run.main(["--scenario", "straggler", "--steps", "8", "--engine", "host",
                          "--device", "cpu", "--tournament", "prop,pid,frozen",
                          "--json", str(summary)]) == 0
    capsys.readouterr()
    ref = _script("scripts/make_tables.py", "make_tables_ref")
    assert ref.tournament_tables([str(summary)]) == 0
    want = capsys.readouterr().out
    port = _script("scripts/make_tables_torch.py", "make_tables_torch")
    assert port.main(["--tournament", str(summary)]) == 0
    got = capsys.readouterr().out
    assert got == want and "| 3 |" in got


def test_chip_spec_is_checked():
    port = _script("scripts/make_tables_torch.py", "make_tables_torch")
    chip = port.parse_chip(V5E_SPEC)
    assert (chip.peak_flops, chip.hbm_bw, chip.link_bw, chip.wire_correction) == \
        (RR.PEAK_FLOPS, RR.HBM_BW, RR.ICI_BW, RR.BF16_CORRECTION)
    assert port.parse_chip("x,1,2,3").wire_correction == 1.0
    with pytest.raises(ValueError, match="--chip"):
        port.parse_chip("x,1,2")
