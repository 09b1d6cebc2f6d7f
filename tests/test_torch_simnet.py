"""repro_torch.simnet against the JAX package's repro.simnet on the CPU: the
host engine's whole report on every non-controld scenario, the link and
queue primitives, the Gilbert-Elliott draw, the driver's summary, and the
options that wait for unported modules."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.simnet as ref_simnet
import repro.simnet.links as ref_links
import repro.simnet.queues as ref_queues
import repro_torch.simnet as port_simnet
import repro_torch.simnet.links as port_links
from repro_torch.data import prng
from repro_torch.simnet import run as port_run
from repro_torch.simnet.queues import FarmConfig, FarmQueues
from repro_torch.simnet.sim import SimConfig, Simulator

ROOT = Path(__file__).resolve().parents[1]
HOOK_FREE = ["baseline", "straggler", "hetero_farm", "correlated_loss", "multi_instance"]
HOOKED = ["burst", "elephant", "link_flap"]
CONTROLD = ["lease_churn", "cp_restart", "leader_failover", "farm_1k", "multi_tenant"]


def _reports(name, steps, **extra):
    rs, ps = ref_simnet.get_scenario(name), port_simnet.get_scenario(name)
    want = ref_simnet.Simulator(rs.build_config(steps=steps, engine="host", **extra),
                                dataclasses.replace(rs)).run()
    got = port_simnet.Simulator(ps.build_config(steps=steps, engine="host", device="cpu",
                                                **extra), dataclasses.replace(ps)).run()
    return got, want


def _comparable(report) -> dict:
    d = report.to_dict(with_traces=True)
    d.pop("wall_s")
    d.pop("packets_per_sec")
    return d


@pytest.mark.parametrize("name", HOOK_FREE + HOOKED)
def test_host_engine_report_equals_reference(name):
    # 40 windows: past the purge of vanished bundles at window 31
    got, want = _reports(name, 40)
    assert got.engine == want.engine == "host"
    assert _comparable(got) == _comparable(want)
    assert got.bundles_completed > 0 and not got.violations


def test_torch_queue_engine_report_equals_np():
    scn = port_simnet.get_scenario("straggler")
    runs = [Simulator(scn.build_config(steps=20, engine="host", device="cpu",
                                       queue_engine=q), dataclasses.replace(scn)).run()
            for q in ("np", "torch")]
    assert _comparable(runs[0]) == _comparable(runs[1])


def _fifo_case(seed):
    rng = np.random.default_rng(seed)
    n, n_links = int(rng.integers(1, 300)), int(rng.integers(1, 6))
    return (rng.integers(0, n_links, n), rng.uniform(0, 1.0, n), rng.uniform(0, 0.01, n),
            rng.uniform(-0.2, 0.2, n_links))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fifo_departures_equal_reference(seed):
    link, t, s, busy = _fifo_case(seed)
    b_port, b_ref = busy.copy(), busy.copy()
    got = port_links.fifo_departures_multi(link, t, s, b_port)
    want = ref_links.fifo_departures_multi(link, t, s, b_ref)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b_port, b_ref)
    order = np.argsort(t, kind="stable")
    got1 = port_links.fifo_departures(t[order], s[order], float(busy[0]))
    want1 = ref_links.fifo_departures(t[order], s[order], float(busy[0]))
    np.testing.assert_array_equal(got1[0], want1[0])
    assert got1[1] == want1[1]


@pytest.mark.parametrize("start_bad", [False, True])
@pytest.mark.parametrize("seed,window,n,p_gb,p_bg", [
    (0, 0, 1, 0.05, 0.2), (3, 7, 500, 0.05, 0.2), (211, 2, 1000, 0.02, 0.25),
    (12, 31, 4097, 0.3, 0.6), (5, 1, 200, 0.0, 0.5)])
def test_gilbert_elliott_states_equal_reference(seed, window, n, p_gb, p_bg, start_bad):
    got, got_end = port_links.gilbert_elliott_states(
        seed, window, n, p_gb=p_gb, p_bg=p_bg, start_bad=start_bad, device="cpu")
    want, want_end = ref_links.gilbert_elliott_states(
        seed, window, n, p_gb=p_gb, p_bg=p_bg, start_bad=start_bad)
    np.testing.assert_array_equal(got, want)
    assert got_end == want_end


@pytest.mark.parametrize("minval,maxval", [(1e-12, 1.0), (0.0, 1.0), (-2.5, 3.0),
                                           (-1e3, 7.25)])
def test_uniform_range_equals_jax(minval, maxval):
    for seed, window in ((0, 0), (0x6E5 ^ 211, 5), (77, 123)):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(seed), window), (1000,),
            minval=minval, maxval=maxval))
        got = prng.uniform(prng.fold_in(prng.prng_key(seed), window), (1000,), "cpu",
                           minval=minval, maxval=maxval).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _farm_windows(seed, m, windows=4):
    rng = np.random.default_rng(seed)
    t_base = 0.0
    for _ in range(windows):
        n = int(rng.integers(1, 400))
        member = rng.integers(0, m, n)
        # jitter pushes some arrivals before the previous window's last one
        t = t_base + rng.uniform(-0.002, 0.01, n)
        yield member, t, rng.uniform(64, 9000, n)
        t_base += 0.01


@pytest.mark.parametrize("seed,m,cap", [(0, 4, 0.05), (1, 7, 0.002), (2, 16, 1e-4)])
def test_farm_queues_torch_engine_equals_np_and_reference(seed, m, cap):
    cfg = FarmConfig.uniform(m, capacity_s=cap,
                             scale=np.random.default_rng(seed).uniform(0.5, 4.0, m))
    ref_cfg = ref_queues.FarmConfig(m, cfg.per_packet_s, cfg.per_byte_s, cfg.capacity_s)
    farms = [FarmQueues(cfg, "np", device="cpu"), FarmQueues(cfg, "torch", device="cpu"),
             ref_queues.FarmQueues(ref_cfg, "np")]
    for member, t, nbytes in _farm_windows(seed, m):
        outs = [f.serve(member, t, nbytes) for f in farms]
        for o in outs[1:]:
            for field in dataclasses.fields(o):
                np.testing.assert_array_equal(getattr(o, field.name),
                                              getattr(outs[0], field.name))
    for f in farms[1:]:
        np.testing.assert_array_equal(f.w, farms[0].w)
        assert f.n_dropped == farms[0].n_dropped and f.n_served == farms[0].n_served


def _reference_driver():
    spec = importlib.util.spec_from_file_location("run_simnet_ref",
                                                  ROOT / "scripts" / "run_simnet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [["--scenario", "straggler", "--steps", "20",
                                   "--compare-frozen"],
                                  ["--scenario", "multi_instance", "--steps", "12",
                                   "--seed", "3", "--traces"]])
def test_driver_summary_equals_reference(argv, tmp_path, capsys):
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    rc_ref = _reference_driver().main(argv + ["--engine", "host", "--json", str(want_p)])
    rc = port_run.main(argv + ["--engine", "host", "--device", "cpu", "--json", str(got_p)])
    capsys.readouterr()
    assert rc == rc_ref == 0
    want, got = json.loads(want_p.read_text()), json.loads(got_p.read_text())
    for d in (want, got):
        d.pop("wall_s")
        d.pop("packets_per_sec")
    assert got == want


@pytest.mark.parametrize("option", [dict(controld=True), dict(ha=True), dict(trace=True),
                                    dict(metrics_every=5)])
def test_unported_options_raise(option):
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=f"SimConfig.{name} needs .*ROADMAP"):
        Simulator(SimConfig(steps=2, device="cpu", **option))


@pytest.mark.parametrize("name", CONTROLD)
def test_controld_scenarios_raise(name):
    scn = port_simnet.get_scenario(name)
    assert sorted(port_simnet.SCENARIOS) == sorted(ref_simnet.SCENARIOS)
    with pytest.raises(NotImplementedError, match="controld"):
        Simulator(scn.build_config(steps=2, device="cpu"), dataclasses.replace(scn)).run()


class TestDeviceDefault:
    """The simulator's entry points default to the card and raise without
    CUDA; ``device="cpu"`` runs the plain path."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_points_raise(self, capsys):
        cfg = FarmConfig.uniform(2)
        for make in (lambda: Simulator(SimConfig(steps=1)),
                     lambda: FarmQueues(cfg),
                     lambda: port_links.Link(port_links.LinkConfig()),
                     lambda: port_links.LinkSet([port_links.LinkConfig()]),
                     lambda: port_run.main(["--steps", "1"])):
            with pytest.raises(RuntimeError, match="cuda"):
                make()
        assert SimConfig().device == "cuda"

    def test_cpu_when_asked(self):
        r = Simulator(SimConfig(steps=2, engine="host", device="cpu")).run()
        assert r.packets_sent > 0
