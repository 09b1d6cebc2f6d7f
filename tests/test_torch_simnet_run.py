"""The port's simulator driver (``python -m repro_torch.simnet.run``) against
the JAX package's ``scripts/run_simnet.py`` on the CPU: ``--compare-policy``,
``--tournament`` and ``--compare-frozen`` summaries, the ``--trace-*``
outputs, the metrics JSONL that ``scripts/analyze_soak.py`` reads, and the
functions the driver's legs run through (a config runs once).

The reference runs ``--engine host``: its fused engine does not import
under jax 0.9 (ROADMAP queue 3). Summaries are compared without
``wall_s``/``packets_per_sec``: counters and ranks exactly, latencies within
rel 1e-9.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.simnet import run as port_run

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_ref", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(got, want, path="summary"):
    """Equal structure; ints, strings and bools exact; floats within rel 1e-9."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=1e-12), path
    else:
        assert type(got) is type(want) and got == want, path


def _summaries(argv, tmp_path, capsys):
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    rc_ref = _script("run_simnet").main(argv + ["--engine", "host", "--json", str(want_p)])
    rc = port_run.main(argv + ["--engine", "host", "--device", "cpu", "--json", str(got_p)])
    capsys.readouterr()
    want, got = json.loads(want_p.read_text()), json.loads(got_p.read_text())
    for d in (want, got):
        d.pop("wall_s")
        d.pop("packets_per_sec")
    return rc, rc_ref, got, want


@pytest.mark.parametrize("scenario", ["straggler", "elephant"])
def test_tournament_and_policy_compare_equal_reference(scenario, tmp_path, capsys,
                                                        monkeypatch):
    """``--compare-policy --tournament proportional,pid,frozen
    --compare-frozen``: the same summary, ranks and gates; the port runs
    each of the three distinct legs once where the reference runs five."""
    runs = []
    leg = port_run.run_leg
    monkeypatch.setattr(port_run, "run_leg", lambda cfg, sc: runs.append(cfg) or leg(cfg, sc))
    argv = ["--scenario", scenario, "--steps", "16", "--compare-policy",
            "--tournament", "proportional,pid,frozen", "--compare-frozen"]
    rc, rc_ref, got, want = _summaries(argv, tmp_path, capsys)
    assert rc == rc_ref == 0 and got["violations"] == want["violations"] == []
    _assert_close(got, want)
    assert [r["policy"] for r in got["tournament"]["ranked"]] == \
        [r["policy"] for r in want["tournament"]["ranked"]]
    assert got["tournament"]["scenario"] == scenario
    assert [(c.frozen_weights, c.controld_policy) for c in runs] == \
        [(False, "proportional"), (True, "proportional"), (False, "pid")]
    assert all(c.controld for c in runs)


@pytest.mark.parametrize("argv", [
    ["--scenario", "straggler", "--steps", "12", "--policy", "pid", "--tournament",
     "pid,prop,pid"],
    ["--scenario", "baseline", "--steps", "8", "--frozen-weights", "--compare-policy",
     "--tournament", "frozen,bogus"],
])
def test_primary_leg_reuse_and_refusals_equal_reference(argv, tmp_path, capsys):
    """A primary under PID (reused by the tournament, aliases deduped) and
    a frozen primary (a tournament of one known name plus an unknown one:
    both gates fire in both packages)."""
    rc, rc_ref, got, want = _summaries(argv, tmp_path, capsys)
    assert rc == rc_ref
    _assert_close(got, want)


def test_legs_take_a_built_config():
    """The leg runner, the comparison and the tournament from a
    ``SimConfig`` built without the flags (as the smoke does at full
    width): a leg config equal to one run reuses its report."""
    scn = port_run.get_scenario("straggler")
    cfg = scn.build_config(steps=10, n_members=4, device="cpu", engine="host", controld=True,
                           trace=True, metrics_every=2)
    report, sim = port_run.run_leg(cfg, scn)
    assert sim.trace is not None and report.engine == "host"
    legs = port_run.Legs(cfg, scn, report)
    assert legs.get(frozen=False) is report
    assert legs.get(frozen=False, policy="proportional") is report
    cmp_block, bad = port_run.policy_compare(legs)
    assert not bad and cmp_block["proportional_p99_s"] == round(report.latency_p99_s, 9)
    t_block, bad = port_run.tournament(legs, "frozen,pid,proportional", "straggler")
    assert not bad and sorted(r["policy"] for r in t_block["ranked"]) == \
        ["frozen", "pid", "proportional"]
    done = legs.reports()
    assert len(done) == 3 and done[0][1] is report
    for leg_cfg, _ in done:
        assert not leg_cfg.trace and leg_cfg.metrics_every == 0
    assert legs.get(frozen=True) is done[2][1]


def test_trace_outputs_equal_reference(tmp_path, capsys):
    """``--trace-summary-json``: span ids exact, times within rel 1e-9, the
    breakdown equal; ``--trace-out``: the Perfetto JSON parses to the same
    events. Only the primary leg traces (``--compare-frozen`` beside it)."""
    argv = ["--scenario", "straggler", "--steps", "12", "--compare-frozen",
            "--trace-sample", "0.5", "--trace-tail-k", "16"]
    out = {}
    for name, main, extra in (("ref", _script("run_simnet").main, []),
                              ("port", port_run.main, ["--device", "cpu"])):
        s, p = tmp_path / f"{name}_summary.json", tmp_path / f"{name}_trace.json"
        assert main(argv + extra + ["--engine", "host", "--trace-summary-json", str(s),
                                    "--trace-out", str(p)]) == 0
        out[name] = json.loads(s.read_text()), json.loads(p.read_text())
    capsys.readouterr()
    (got_s, got_p), (want_s, want_p) = out["port"], out["ref"]
    assert sorted(got_s) == sorted(want_s)
    assert len(want_s["spans"]["key"]) > 0
    for k, v in want_s["spans"].items():
        if k in ("t0", "t1"):
            np.testing.assert_allclose(got_s["spans"][k], v, rtol=REL, atol=1e-12)
        else:
            assert got_s["spans"][k] == v, k
    _assert_close({k: v for k, v in got_s.items() if k != "spans"},
                  {k: v for k, v in want_s.items() if k != "spans"})
    _assert_close(got_p, want_p)


def test_metrics_jsonl_feeds_analyze_soak(tmp_path, capsys):
    """The port's metrics JSONL (a plain leg and the ``--kill-leader-every``
    leg) through ``scripts/analyze_soak.py``: exit 0, and the report holds
    the series that the reference's JSONL gives."""
    soak = _script("analyze_soak")
    for leg in (["--scenario", "baseline", "--steps", "12"],
                ["--scenario", "baseline", "--steps", "24", "--kill-leader-every", "10"]):
        reports = {}
        for name, main, extra in (("ref", _script("run_simnet").main, []),
                                  ("port", port_run.main, ["--device", "cpu"])):
            rows, rep = tmp_path / f"{name}.jsonl", tmp_path / f"{name}_soak.json"
            rows.unlink(missing_ok=True)
            assert main(leg + extra + ["--engine", "host", "--metrics-interval", "1",
                                       "--metrics-jsonl", str(rows)]) == 0
            assert soak.main([str(rows), "--json", str(rep)]) == 0
            reports[name] = json.loads(rep.read_text())
        capsys.readouterr()
        (got,), (want,) = (list(reports[n]["files"].values()) for n in ("port", "ref"))
        assert sorted(got["series"]) == sorted(want["series"])
        assert got["rows"] == want["rows"] and got["violations"] == []
        if "--kill-leader-every" in leg:
            assert "controld_ha_failovers" in got["series"]
