"""repro_torch.simnet against the JAX package's repro.simnet on the CPU: the
host engine's whole report on every scenario (the controld presets
included), the daemon's digest, tracing and live metrics on the host engine,
the link and queue primitives, the Gilbert-Elliott draw, run.py's
summary, and the fused engine's trace and metrics replay against the
reference's host engine."""
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


# windows per controld preset: past the hooks (a third, a half, two thirds
# of the run) at the small presets; farm_1k (1024 members) at 4
CONTROLD_STEPS = {"lease_churn": 30, "cp_restart": 30, "leader_failover": 30,
                  "multi_tenant": 30, "farm_1k": 4}


def _sims(name, steps, **extra):
    rs, ps = ref_simnet.get_scenario(name), port_simnet.get_scenario(name)
    want = ref_simnet.Simulator(rs.build_config(steps=steps, engine="host", **extra),
                                dataclasses.replace(rs))
    got = port_simnet.Simulator(ps.build_config(steps=steps, engine="host", device="cpu",
                                                **extra), dataclasses.replace(ps))
    return got, want, got.run(), want.run()


@pytest.mark.parametrize("name", CONTROLD)
def test_controld_preset_report_equals_reference(name):
    assert sorted(port_simnet.SCENARIOS) == sorted(ref_simnet.SCENARIOS)
    got_sim, want_sim, got, want = _sims(name, CONTROLD_STEPS[name])
    assert got.engine == want.engine == "host"
    assert _comparable(got) == _comparable(want)
    assert not got.violations and got.bundles_completed > 0
    # every tenant's daemon state, byte for byte
    assert got_sim.daemon.state_digest() == want_sim.daemon.state_digest()
    expect = {"lease_churn": dict(leases_expired=1), "cp_restart": dict(daemon_restarts=1),
              "leader_failover": dict(ha_failovers=1, ha_revivals=1)}.get(name, {})
    for k, v in expect.items():
        assert getattr(got, k) == v, k


def test_leader_failover_chaos_gates():
    """The reference's HA chaos gates (``tests/test_ha.py``, whose run there
    stops at the reference's fused-engine import) on the port: a failover
    within 1.25 lease terms, no lost bundle, replication current after the
    revive, and the same schedule and digest from a second run."""
    runs = []
    for _ in range(2):
        scn = port_simnet.get_scenario("leader_failover")
        sim = Simulator(scn.build_config(steps=30, engine="host", device="cpu"),
                        dataclasses.replace(scn))
        r = sim.run()
        assert r.violations == [] and r.ha_failovers >= 1 and sim.ha_revivals >= 1
        assert r.bundles_completed == r.bundles_sent and r.bundles_timed_out == 0
        assert all(d <= 1.25 * sim._ha_term_s() for d in r.ha_failover_durations)
        assert sim.cluster.leader().replicator.lag() == 0
        runs.append((r.ha_failover_durations, sim.daemon.state_digest()))
    assert runs[1] == runs[0]


def test_farm_1k_tables_take_the_global_route_design():
    """farm_1k's stacked tables (4 x 4096 member slots) are above a block's
    shared memory: the card routes them with lb_route's "global" design."""
    from repro_torch.kernels.lb_route import _design, smem_bytes
    scn = port_simnet.get_scenario("farm_1k")
    sim = Simulator(scn.build_config(steps=1, engine="host", device="cpu"),
                    dataclasses.replace(scn))
    t = sim.dataplane().tables
    n_inst, n_members = t.member_node.shape
    n_rows = t.calendars.shape[1]
    assert (n_inst, n_members) == (4, 4096)
    assert smem_bytes("shared", n_inst, n_rows, n_members) == 328_480
    assert _design(n_inst, n_rows, n_members) == "global"


@pytest.mark.parametrize("name,extra", [("straggler", {}),
                                        ("lease_churn", {}),
                                        ("multi_instance", dict(trace_sample=0.25,
                                                                trace_tail_k=8))])
def test_trace_on_the_host_engine_equals_reference(name, extra):
    """Per-bundle spans byte-equal as Perfetto JSON; in controld mode also
    the daemon's per-message spans under each window's trace id, all but
    their durations (the daemon's wall-clock handling time, in both
    packages)."""
    got_sim, want_sim, got, want = _sims(name, 12, trace=True, **extra)
    assert _comparable(got) == _comparable(want)
    gt, wt = got_sim.trace, want_sim.trace
    assert gt.stage_names == wt.stage_names
    gs, ws = gt.spans(), wt.spans()
    wall = np.isin(ws["stage"], [i for i, n in enumerate(wt.stage_names)
                                 if n.startswith("controld.")])
    assert wall.any() == got_sim.cfg.controld
    for k in ws:
        if k == "t1":
            assert np.array_equal(gs[k][~wall], ws[k][~wall])
        else:
            assert np.array_equal(gs[k], ws[k]), k
    if not wall.any():
        assert gt.to_perfetto_json() == wt.to_perfetto_json()
        assert json.dumps(gt.to_summary(), sort_keys=True) == json.dumps(
            wt.to_summary(), sort_keys=True)
    assert got_sim._lat_keys == want_sim._lat_keys


@pytest.mark.parametrize("name", ["straggler", "leader_failover"])
def test_metrics_on_the_host_engine_equal_reference(name, tmp_path):
    """The live registry's JSONL rows and its Prometheus page (the process's
    resident memory aside: machine state)."""
    rows = {}
    sims = _sims(name, 30, metrics_every=5, metrics_path=None)
    for pkg, sim in (("port", sims[0]), ("ref", sims[1])):
        page = [ln for ln in sim.metrics.render().splitlines()
                if not ln.startswith("process_rss_bytes")]
        rows[pkg] = page
    assert rows["port"] == rows["ref"]
    paths = {}
    for pkg, mod, extra in (("port", port_simnet, dict(device="cpu")), ("ref", ref_simnet, {})):
        path = tmp_path / f"{pkg}.jsonl"
        scn = mod.get_scenario(name)
        mod.Simulator(scn.build_config(steps=30, engine="host", metrics_every=5,
                                       metrics_path=str(path), **extra),
                      dataclasses.replace(scn)).run()
        paths[pkg] = [json.loads(line) for line in path.read_text().splitlines()]
        for r in paths[pkg]:
            r["metrics"].pop("process_rss_bytes")
    assert len(paths["port"]) == 6 and paths["port"] == paths["ref"]


# -- the fused engine's trace and metrics replay, against the reference's
# host engine (the reference's fused engine does not import under jax 0.9)

FUSED_LOOP_KW = dict(triggers_per_step=16, n_daqs=2, n_members=4, mean_bundle_bytes=6_000)


def _traced_fused_and_reference_host(name, steps=24, **extra):
    rs, ps = ref_simnet.get_scenario(name), port_simnet.get_scenario(name)
    want = ref_simnet.Simulator(rs.build_config(steps=steps, seed=0, engine="host",
                                                trace=True, **extra),
                                dataclasses.replace(rs))
    got = Simulator(ps.build_config(steps=steps, seed=0, engine="fused", device="cpu",
                                    trace=True, **extra), dataclasses.replace(ps))
    rg, rw = got.run(), want.run()
    assert (rg.engine, rw.engine) == ("fused", "host")
    assert not rg.violations and not rw.violations
    return got, want


@pytest.mark.parametrize("name", ["baseline", "straggler"])
def test_fused_engine_spans_equal_reference_host_engine(name):
    """The fused engine materializes its spans after the run from the step's
    returned per-row arrays: the reference host engine's span set, ids
    exact, times within rel 1e-9 (the reference's host-vs-fused tolerance)."""
    got, want = _traced_fused_and_reference_host(name)
    gt, wt = got.trace, want.trace
    assert gt.stage_names == wt.stage_names
    a, b = wt.spans(), gt.spans()
    assert len(a["key"]) == len(b["key"]) > 0
    for f in ("stage", "key", "pid", "aux"):
        assert np.array_equal(a[f], b[f]), f
    for f in ("t0", "t1"):
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)
    ka, ta, da = wt.completions()
    kb, tb_, db = gt.completions()
    assert np.array_equal(ka, kb)
    np.testing.assert_allclose(tb_, ta, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(db, da, rtol=1e-9, atol=1e-12)
    assert got._lat_keys == want._lat_keys
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=1e-9, atol=1e-12)


def test_fused_engine_sampled_spans_equal_reference_host_engine():
    """Head sampling and the tail reservoir select the same bundles."""
    got, want = _traced_fused_and_reference_host("baseline", trace_sample=0.25,
                                                 trace_tail_k=8)
    assert np.array_equal(got.trace.spans()["key"], want.trace.spans()["key"])
    assert np.array_equal(got.trace.tail_keys(), want.trace.tail_keys())
    assert len(got.trace.tail_keys()) == 8


def _metrics_sims(tmp_path, loss=0.0, **extra):
    """Both packages at one config; ``loss`` on the member links makes
    bundles time out in reassembly."""
    sims = {}
    for pkg, mod, kw in (("ref", ref_simnet, dict(engine="host")),
                         ("port", port_simnet, dict(engine="fused", device="cpu"))):
        path = tmp_path / f"{pkg}.jsonl"
        link = dataclasses.replace(mod.SimConfig().member_link, loss_prob=loss)
        sim = mod.Simulator(mod.SimConfig(steps=16, metrics_every=4, metrics_path=str(path),
                                          member_link=link, **kw, **FUSED_LOOP_KW, **extra))
        assert sim.run().engine == kw["engine"]
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        sims[pkg] = (sim, rows)
    return sims


@pytest.mark.parametrize("loss", [0.0, 0.05])
def test_fused_engine_metrics_rows_equal_reference_host_engine(tmp_path, loss):
    """The registry's rows and the JSONL time series at rel 1e-9, abs 1e-12
    (the process's resident memory aside: machine state). With lossy member
    links bundles time out in reassembly, and the pending gauge leaves them
    out on the fused engine as on the host engine."""
    sims = _metrics_sims(tmp_path, loss=loss)
    assert (sims["ref"][0].reassemblers and any(
        ra.stats.n_timed_out_groups for ra in sims["ref"][0].reassemblers.values())) == (loss > 0)
    want, got = sims["ref"][0].metrics.sample(), sims["port"][0].metrics.sample()
    assert set(got) == set(want)
    for k in sorted(set(want) - {"process_rss_bytes"}):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
    rw, rg = sims["ref"][1], sims["port"][1]
    assert [r["step"] for r in rg] == [r["step"] for r in rw] == [3, 7, 11, 15]
    for a, b in zip(rg, rw):
        assert a["t_sim"] == pytest.approx(b["t_sim"], rel=1e-9, abs=1e-12)
        a["metrics"].pop("process_rss_bytes")
        b["metrics"].pop("process_rss_bytes")
        assert set(a["metrics"]) == set(b["metrics"])
        for k, v in b["metrics"].items():
            assert a["metrics"][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k


def test_fused_engine_exemplars_link_buckets_to_trace_ids(tmp_path):
    from repro_torch.telemetry.registry import LATENCY_BUCKETS_S
    from repro_torch.telemetry.trace import parse_trace_id

    sims = _metrics_sims(tmp_path, trace=True)
    sim = sims["port"][0]
    page = sim.metrics.render()
    assert 'trace_id="' in page
    ex = sim.trace.exemplars(LATENCY_BUCKETS_S)
    assert ex and ex == sims["ref"][0].trace.exemplars(LATENCY_BUCKETS_S)
    for _bi, (tid, e2e) in ex.items():
        assert parse_trace_id(tid) >= 0 and e2e > 0


def test_fused_tracing_captures_no_new_program():
    """Tracing and metrics run the program the untraced run built: no new
    capture, the same number of superblock runs."""
    from repro_torch.simnet import fused

    # a shape of its own (6 members, 5 triggers) so the first run below is
    # the one that may build the program
    cfg = SimConfig(steps=16, n_members=6, triggers_per_step=5, n_daqs=2, device="cpu")
    Simulator(cfg).run()
    calls0, traces0 = fused.FUSED_STEP_CALLS, fused.FUSED_TRACES
    sim = Simulator(dataclasses.replace(cfg, trace=True, metrics_every=1))
    eng = fused.FusedEngine(sim)
    assert eng.run().engine == "fused"
    assert fused.FUSED_TRACES == traces0
    assert fused.FUSED_STEP_CALLS - calls0 == eng.n_superblocks == 2
    # the per-row outputs came back once per superblock of the traced run
    assert len(eng.row_copy_s) == 2
    assert len(sim.trace.spans()["key"]) > 0 and sim.metrics is not None


def test_controld_config_on_the_fused_engine_runs_the_host_engine():
    from repro_torch.simnet import fused
    scn = port_simnet.get_scenario("multi_tenant")
    cfg = scn.build_config(steps=6, device="cpu")
    assert cfg.engine == "fused"
    assert fused.unsupported_reason(cfg, scn) == "controld sessions are host-side daemons"
    report = Simulator(cfg, dataclasses.replace(scn)).run()
    assert report.engine == "host" and not report.violations


@pytest.mark.parametrize("argv", [
    ["--scenario", "multi_instance", "--steps", "20", "--controld", "--policy", "pid"],
    ["--scenario", "baseline", "--steps", "24", "--kill-leader-every", "10"],
    ["--scenario", "lease_churn", "--steps", "18", "--metrics-interval", "6"],
])
def test_driver_controld_flags_equal_reference(argv, tmp_path, capsys):
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
