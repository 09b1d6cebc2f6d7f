"""The port's critical-path analyzer (``python -m
repro_torch.telemetry.analyze_trace``) against the JAX package's
``scripts/analyze_trace.py`` on the CPU: the same stage tables for a
simulator scenario (host engine, the reference's fused engine does not
import under jax 0.9) and a fabric scenario, each package's
``--summary-json`` read by the other to the same table, the Perfetto
export, the FAIL rule, and ``--summary`` touching no device.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.telemetry import analyze_trace as port_at
from repro_torch.telemetry.trace import TraceBuffer

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location("analyze_trace_ref",
                                                  ROOT / "scripts" / "analyze_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("source", [
    ["--scenario", "straggler", "--engine", "host", "--steps", "16"],
    ["--fabric", "vlb_spray", "--steps", "6"],
], ids=["straggler", "vlb_spray"])
def test_tables_and_summaries_equal_reference(source, tmp_path, capsys):
    """p50, p99 and p99.9: the same tables (stage sums reconciled), and each
    package's summary reloaded by the other prints them again."""
    pcts = ["--percentile", "50", "--percentile", "99", "--percentile", "99.9"]
    ref = _reference()
    s_ref, s_port = tmp_path / "ref.json", tmp_path / "port.json"
    perf_ref, perf_port = tmp_path / "ref_trace.json", tmp_path / "port_trace.json"
    rc_ref, want, _ = _run(ref.main, source + pcts + ["--summary-json", str(s_ref),
                                                      "--perfetto", str(perf_ref)], capsys)
    rc, got, err = _run(port_at.main, source + pcts + ["--device", "cpu", "--summary-json",
                                                       str(s_port), "--perfetto",
                                                       str(perf_port)], capsys)
    assert rc == rc_ref == 0
    assert got == want and want.count("reconciles to") == 3
    assert "# kernel launches: " in err
    assert json.loads(perf_port.read_text()) == json.loads(perf_ref.read_text())
    for main, summary in ((ref.main, s_port), (port_at.main, s_ref)):
        rc, again, _ = _run(main, ["--summary", str(summary)] + pcts, capsys)
        assert rc == 0 and again == want


def test_fail_rule_and_summary_without_a_device(tmp_path, capsys, monkeypatch):
    """A stage sum off by more than ``--max-rel-err`` FAILS in both packages
    (here a span shortened in the saved summary); ``--summary`` runs with
    no CUDA present and the default device."""
    ref = _reference()
    path = tmp_path / "s.json"
    assert port_at.main(["--scenario", "baseline", "--engine", "host", "--steps", "10",
                         "--device", "cpu", "--summary-json", str(path)]) == 0
    capsys.readouterr()
    d = json.loads(path.read_text())
    tb = TraceBuffer.from_summary(d)
    from repro_torch.telemetry.traceview import percentile_key
    key = percentile_key(tb, 99.0)
    spans, wan = d["spans"], tb.stage_id("wan")
    for i, (k, st) in enumerate(zip(spans["key"], spans["stage"])):
        if int(k) == int(key) and int(st) == wan:  # every copy's WAN hop halved
            spans["t1"][i] = spans["t0"][i] + 0.5 * (spans["t1"][i] - spans["t0"][i])
    path.write_text(json.dumps(d))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ref.main, port_at.main):
        rc, out, err = _run(main, ["--summary", str(path), "--max-rel-err", "1e-9"], capsys)
        assert rc == 1 and "does not reconcile" in err
    with pytest.raises(RuntimeError, match="cuda"):
        port_at.main(["--scenario", "baseline", "--steps", "2"])


def test_head_sampled_summary_reloads_to_the_live_tables(tmp_path, capsys):
    """``--trace-sample 0.25``: both packages print the same live tables;
    the port reads its summary back to them (its retained bundles are those
    whose spans the summary holds). The reference's reader counts every
    completion as retained and finds no spans for the unsampled p50 bundle
    (a limit of the reference, ROADMAP queue 3)."""
    run = ["--scenario", "straggler", "--engine", "host", "--steps", "16",
           "--trace-sample", "0.25", "--percentile", "50", "--percentile", "99"]
    ref = _reference()
    rc_ref, want, _ = _run(ref.main, run, capsys)
    path = tmp_path / "sampled.json"
    rc, got, _ = _run(port_at.main, run + ["--device", "cpu", "--summary-json", str(path)],
                      capsys)
    assert rc == rc_ref == 0 and got == want
    pcts = ["--percentile", "50", "--percentile", "99"]
    rc, again, _ = _run(port_at.main, ["--summary", str(path)] + pcts, capsys)
    assert rc == 0 and again == want
    rc, _, err = _run(ref.main, ["--summary", str(path)] + pcts, capsys)
    assert rc == 1 and "no retained bundle found for p50" in err
