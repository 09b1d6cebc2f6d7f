"""The port's slice as a whole: the closed loop against the JAX package's
driver from the same seed, the port's independence from JAX, and its
refusal to fall back to the CPU on its own."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import closed_loop

ROOT = Path(__file__).resolve().parents[1]


def _reference_loop():
    spec = importlib.util.spec_from_file_location(
        "run_closed_loop_ref", ROOT / "scripts" / "run_closed_loop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scenario", ["loss", "straggler"])
def test_closed_loop_matches_reference(scenario, tmp_path, capsys):
    argv = ["--steps", "12", "--scenario", scenario, "--n-members", "4",
            "--n-daqs", "2", "--mtu-payload", "2048", "--seed", "5"]
    out = tmp_path / "ref.json"
    assert _reference_loop().main(argv + ["--backend", "jnp", "--json", str(out)]) == 0
    want = json.loads(out.read_text())
    got = closed_loop.run(closed_loop.parse_args(argv + ["--device", "cpu"]))
    capsys.readouterr()
    want.pop("wall_s")
    summary = dict(got.summary)
    summary.pop("wall_s")
    assert summary == want
    assert got.packets_packed == got.packets_routed and got.pack_dropped == 0
    # one launch record per step; CPU tensors take the plain versions
    assert len(got.step_launches) == 12
    assert all(n == 0 for step in got.step_launches for n in step.values())


def _summary_without_wall(path) -> dict:
    d = json.loads(path.read_text())
    d.pop("wall_s")
    d.pop("packets_per_sec")
    return d


# the closed loop on the simulator: --engine host against the reference's
@pytest.mark.parametrize("scenario", ["straggler", "loss", "reorder"])
def test_closed_loop_simulator_engine_matches_reference(scenario, tmp_path, capsys):
    argv = ["--steps", "20", "--scenario", scenario, "--n-members", "4", "--n-daqs", "2",
            "--seed", "3", "--engine", "host"]
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    rc_ref = _reference_loop().main(argv + ["--json", str(want_p)])
    rc = closed_loop.main(argv + ["--device", "cpu", "--json", str(got_p)])
    capsys.readouterr()
    assert rc == rc_ref == 0
    assert _summary_without_wall(got_p) == _summary_without_wall(want_p)


def test_closed_loop_simulator_metrics_rows_match_reference(tmp_path, capsys):
    """--metrics-interval on the host engine: the same JSONL rows, machine
    state (resident memory) aside."""
    argv = ["--steps", "12", "--scenario", "straggler", "--n-members", "4", "--n-daqs", "2",
            "--engine", "host", "--metrics-interval", "4"]
    rows = {}
    for name, main, extra in (("ref", _reference_loop().main, []),
                              ("port", closed_loop.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        assert main(argv + extra + ["--metrics-jsonl", str(path)]) == 0
        rows[name] = [json.loads(line) for line in path.read_text().splitlines()]
        for r in rows[name]:
            r["metrics"].pop("process_rss_bytes")
    capsys.readouterr()
    assert len(rows["port"]) == 3 and rows["port"] == rows["ref"]


def test_closed_loop_loop_engine_metrics_rows(tmp_path, capsys):
    """--metrics-interval on the per-step loop: the reference's row keys and
    counters (the step histogram is wall time)."""
    argv = ["--steps", "6", "--scenario", "loss", "--n-members", "4", "--n-daqs", "2",
            "--metrics-interval", "2"]
    rows = {}
    for name, main, extra in (("ref", _reference_loop().main, ["--backend", "jnp"]),
                              ("port", closed_loop.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        assert main(argv + extra + ["--metrics-jsonl", str(path)]) == 0
        rows[name] = [json.loads(line) for line in path.read_text().splitlines()]
    capsys.readouterr()
    assert [sorted(r["metrics"]) for r in rows["port"]] == \
        [sorted(r["metrics"]) for r in rows["ref"]]
    assert [r["step"] for r in rows["port"]] == [r["step"] for r in rows["ref"]] == [1, 3, 5]
    for k in ("loop_windows_total", "loop_bundles_completed", "loop_epoch_switches",
              "loop_step_seconds_count"):
        assert [r["metrics"][k] for r in rows["port"]] == \
            [r["metrics"][k] for r in rows["ref"]], k


@pytest.mark.parametrize("argv", [["--scenario", "elastic", "--engine", "host"]])
def test_closed_loop_simulator_engine_refusals(argv, capsys):
    """The elastic scenario on the simulator is refused with rc 2, as by the
    reference."""
    assert closed_loop.main(argv + ["--steps", "4", "--n-members", "4", "--n-daqs", "2",
                                    "--device", "cpu"]) == 2
    assert "not" in capsys.readouterr().err


def test_closed_loop_fused_engine_metrics_rows_match_reference_host(tmp_path, capsys):
    """--metrics-interval on the fused engine: its replayed JSONL rows equal
    the reference host engine's at rel 1e-9 (the reference's fused engine
    does not import under jax 0.9), resident memory aside."""
    argv = ["--steps", "12", "--scenario", "straggler", "--n-members", "4", "--n-daqs", "2",
            "--metrics-interval", "4"]
    rows = {}
    for name, main, extra in (("ref", _reference_loop().main, ["--engine", "host"]),
                              ("port", closed_loop.main, ["--engine", "fused",
                                                          "--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        assert main(argv + extra + ["--metrics-jsonl", str(path)]) == 0
        rows[name] = [json.loads(line) for line in path.read_text().splitlines()]
    capsys.readouterr()
    assert [r["step"] for r in rows["port"]] == [r["step"] for r in rows["ref"]] == [3, 7, 11]
    for got, want in zip(rows["port"], rows["ref"]):
        got["metrics"].pop("process_rss_bytes")
        want["metrics"].pop("process_rss_bytes")
        assert set(got["metrics"]) == set(want["metrics"])
        assert got["t_sim"] == pytest.approx(want["t_sim"], rel=1e-9, abs=1e-12)
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k


def test_full_width_preset():
    """The loop size that chip_smoke.py and the profile script share."""
    args = closed_loop.parse_args(closed_loop.FULL_WIDTH + ["--steps", "25"])
    assert (args.scenario, args.n_members, args.n_daqs, args.triggers_per_step) == \
        ("straggler", 64, 16, 128)
    assert (args.max_members, args.mtu_payload, args.lane_bits) == (512, 8948, 2)
    assert (args.loss, args.dup, args.reorder_window) == (0.01, 0.01, 256)
    assert (args.mean_bundle_bytes, args.reweight_every, args.timeout_windows) == \
        (64000, 5, 4)
    assert args.device == "cuda" and args.steps == 25


def test_port_imports_without_jax_or_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import importlib.util, pathlib\n"
        "for f in sorted(pathlib.Path('scripts').glob('*_torch.py'))"
        " + sorted(pathlib.Path('examples').glob('*_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location(f.stem, f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    names.append(str(f))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 40
    for sub in ("controld", "telemetry", "testing", "fabric", "train", "distributed",
                "checkpoint"):
        assert f"repro_torch.{sub}" in names, sub
    for mod in ("controld.daemon", "controld.ha", "controld.journal", "controld.messages",
                "controld.replication", "controld.transport", "telemetry.registry",
                "telemetry.export", "telemetry.trace", "telemetry.traceview",
                "testing.faults", "testing.hypo", "fabric.spray", "fabric.elephant",
                "fabric.sim", "fabric.scenarios", "fabric.run", "serve.engine",
                "train.optimizer", "train.train_step", "train.trainer",
                "distributed.context", "distributed.sharding", "distributed.compression",
                "checkpoint.ckpt", "launch.train", "tree", "models.moe",
                "configs.mixtral_8x22b", "configs.arctic_480b", "analysis.perfmodel",
                "analysis.roofline", "launch.shapes", "launch.dryrun", "launch.mesh",
                "launch.shardspecs", "distributed.dp", "controld.run",
                "telemetry.analyze_trace", "simnet.run"):
        assert f"repro_torch.{mod}" in names, mod
    for f in ("scripts/make_tables_torch.py", "examples/quickstart_torch.py",
              "examples/serve_lb_torch.py", "examples/elastic_scaling_torch.py"):
        assert f in names, f


def test_port_sources_name_no_jax_or_repro_import():
    """Imports inside functions too: no line of the port's package, its
    scripts, its examples or the smoke imports ``jax`` or ``repro``."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + sorted((ROOT / "scripts").glob("*_torch.py"))
             + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"])
    assert len(files) > 60
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
           for m in pat.finditer(f.read_text())]
    assert not bad, bad


def test_calendar_edges_run_without_hypothesis():
    """The port's property tests draw through ``repro_torch.testing.hypo``:
    with hypothesis unimportable (a ``sys.modules`` entry of None before
    pytest starts) the file collects and passes on the seeded fallback."""
    code = ("import sys\n"
            "sys.modules['hypothesis'] = None\n"
            "import pytest\n"
            "sys.exit(pytest.main(['-q', '-p', 'no:cacheprovider', '-p', 'no:hypothesispytest',\n"
            "                      '-p', 'no:xdist', '--assert=plain',\n"
            "                      'tests/test_torch_calendar_edges.py']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
                               "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert " passed" in proc.stdout and "failed" not in proc.stdout


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of the card-side scripts, at any depth."""
    import ast

    for script in ("chip_smoke.py", "scripts/profile_closed_loop_torch.py"):
        tree = ast.parse((ROOT / script).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert any(m.startswith("repro_torch") for m in mods), script
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), (script, m)


class TestDeviceDefault:
    """Every entry point defaults to device="cuda" and raises without CUDA."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_constructors_raise(self):
        import repro_torch.core as tcore
        from repro_torch.core.dataplane import DataPlane, DataPlaneCache
        from repro_torch.data.daq import DAQConfig
        from repro_torch.data.pipeline import StreamingPipeline
        from repro_torch.data.reassembly import BatchReassembler
        from repro_torch.data.transport import TransportConfig, WANTransport

        em = tcore.EpochManager(max_members=8)
        em.initialize({0: tcore.MemberSpec(node_id=0)}, {0: 1.0})
        for make in (lambda: DataPlane.from_manager(em),
                     lambda: DataPlane.from_instances([em, em]),
                     lambda: DataPlaneCache(em),
                     lambda: em.state.compile(),
                     lambda: WANTransport(TransportConfig()),
                     lambda: BatchReassembler(),
                     lambda: StreamingPipeline(DAQConfig(), TransportConfig(), em),
                     lambda: closed_loop.run(closed_loop.parse_args(["--steps", "1"]))):
            with pytest.raises(RuntimeError, match="cuda"):
                make()

    def test_training_entry_points_raise(self, tmp_path):
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import train as launch_train
        from repro_torch.train import train_step as TS
        from repro_torch.train.trainer import Trainer, TrainerConfig

        cfg = get_smoke_config("yi_6b")
        assert TrainerConfig().device == "cuda"
        for make in (lambda: Trainer(cfg, TS.TrainConfig(), TrainerConfig(ckpt_dir=str(tmp_path))),
                     lambda: TS.init_train_state(torch.Generator(), cfg, TS.TrainConfig()),
                     lambda: launch_train.main(["--demo", "--ckpt-dir", str(tmp_path)])):
            with pytest.raises(RuntimeError, match="cuda"):
                make()

    def test_cpu_when_asked(self):
        import repro_torch.core as tcore
        from repro_torch.core.dataplane import DataPlane

        em = tcore.EpochManager(max_members=8)
        em.initialize({0: tcore.MemberSpec(node_id=0)}, {0: 1.0})
        r = DataPlane.from_manager(em, device="cpu").route_events([5, 6], [0, 1])
        assert r.member.tolist() == [0, 0] and r.member.device.type == "cpu"
