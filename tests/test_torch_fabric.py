"""repro_torch.fabric against the JAX package's repro.fabric on the CPU: the
spray hashes and the live-set re-index, the elephant detector's transitions,
each preset's whole report, the controld fabric's daemon digest, the
validation errors, the driver's summary, and the reference's own gates
(VLB beats direct hashing, isolation cuts mice p99, a hit-less LB failure,
conservation, event affinity, the lane partition)."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.fabric as ref_fabric
import repro_torch.fabric as port_fabric
from repro.simnet.links import LinkConfig as RefLinkConfig
from repro_torch.fabric import (ElephantConfig, ElephantDetector, FabricConfig, FabricSim,
                                get_fabric_scenario, mix64, spray_keys, spray_paths)
from repro_torch.fabric import run as port_run
from repro_torch.simnet.links import LinkConfig

ROOT = Path(__file__).resolve().parents[1]

# the preset legs the reference's driver runs (scripts/run_fabric.py)
LEGS = {
    "vlb": ("vlb_spray", dict(mode="vlb")),
    "direct": ("vlb_spray", dict(mode="direct")),
    "isolated": ("elephant_mice", dict(isolate=True)),
    "shared": ("elephant_mice", dict(isolate=False)),
    "failure": ("lb_node_failure", {}),
}


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in ("wall_s", "packets_per_sec")}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def _comparable(report) -> dict:
    return _strip(report.to_dict())


def _pair(name, **extra):
    """The same preset leg through both packages: (port sim, ref sim, port
    report, ref report)."""
    ps, rs = get_fabric_scenario(name), ref_fabric.get_fabric_scenario(name)
    port = FabricSim(ps.build_config(device="cpu", **extra), scenario=ps)
    ref = ref_fabric.FabricSim(rs.build_config(**extra), scenario=rs)
    return port, ref, port.run(), ref.run()


@pytest.fixture(scope="module")
def legs():
    return {leg: _pair(name, **extra) for leg, (name, extra) in LEGS.items()}


# -- spray plane and detector -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 9, 2**63 + 5])
def test_spray_keys_equal_reference(seed):
    ev = np.arange(1, 3001, dtype=np.uint64) * np.uint64(7919)
    dq = (np.arange(3000) % 11).astype(np.uint64)
    for got, want in zip(spray_keys(ev, dq, seed), ref_fabric.spray_keys(ev, dq, seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    x = np.arange(50_000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    assert np.array_equal(mix64(x), ref_fabric.mix64(x))


@pytest.mark.parametrize("live", [[0, 1, 2, 3], [0, 2, 3], [3], [1, 4, 6, 7, 9]])
@pytest.mark.parametrize("mode", ["vlb", "direct"])
def test_spray_paths_equal_reference(live, mode):
    """Including the re-index over a live set with holes (a killed LB)."""
    ev = np.arange(1, 801, dtype=np.uint64)
    dq = (np.arange(800) % 5).astype(np.uint64)
    got = spray_paths(ev, dq, live, mode=mode, seed=9)
    want = ref_fabric.spray_paths(ev, dq, live, mode=mode, seed=9)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert set(np.unique(got[0])) <= set(live) and set(np.unique(got[1])) <= set(live)


def test_spray_errors_equal_reference():
    ev, dq = np.ones(4, np.uint64), np.zeros(4, np.uint64)
    for live, mode in (([], "vlb"), ([0], "rotor")):
        with pytest.raises(ValueError) as got:
            spray_paths(ev, dq, live, mode=mode)
        with pytest.raises(ValueError) as want:
            ref_fabric.spray_paths(ev, dq, live, mode=mode)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("alpha", [1.0, 0.3, 0.2])
def test_elephant_detector_transitions_equal_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    streams = rng.choice([5e6, 20e6, 28e6, 40e6, 60e6], size=(60, 6)) * rng.uniform(
        0.5, 1.5, (60, 6))
    port = ElephantDetector(6, ElephantConfig(hi_Bps=30e6, lo_Bps=15e6, alpha=alpha))
    ref = ref_fabric.ElephantDetector(6, ref_fabric.ElephantConfig(
        hi_Bps=30e6, lo_Bps=15e6, alpha=alpha))
    for row in streams:
        assert np.array_equal(port.update(row, 1.0), ref.update(row, 1.0))
        assert np.array_equal(port.ewma_Bps, ref.ewma_Bps)
    assert port.transitions == ref.transitions > 0
    assert np.array_equal(port.ever_elephant, ref.ever_elephant)


def test_elephant_hysteresis_holds_inside_the_band():
    det = ElephantDetector(1, ElephantConfig(hi_Bps=30e6, lo_Bps=15e6, alpha=1.0))
    det.update([40e6], 1.0)
    for i in range(20):
        det.update([20e6 if i % 2 else 28e6], 1.0)
        assert det.elephant[0]
    assert det.transitions == 1


@pytest.mark.parametrize("make", [
    lambda m: m.ElephantConfig(hi_Bps=1.0, lo_Bps=2.0),
    lambda m: m.ElephantConfig(alpha=0.0),
    lambda m: m.ElephantDetector(4).update(np.zeros(3), 1.0),
])
def test_detector_validation_equals_reference(make):
    with pytest.raises(ValueError) as got:
        make(port_fabric)
    with pytest.raises(ValueError) as want:
        make(ref_fabric)
    assert str(got.value) == str(want.value)


# -- whole runs ------------------------------------------------------------------

@pytest.mark.parametrize("leg", sorted(LEGS))
def test_preset_report_equals_reference(legs, leg):
    _port, _ref, got, want = legs[leg]
    assert _comparable(got) == _comparable(want)
    assert got.violations == [] and got.bundles_completed > 0


def test_preset_event_members_equal_reference(legs):
    for leg in LEGS:
        port, ref, _, _ = legs[leg]
        assert dict(port.event_members) == dict(ref.event_members), leg


def test_gate_vlb_beats_direct_on_max_lb_load(legs):
    vlb, direct = legs["vlb"][2], legs["direct"][2]
    assert vlb.max_lb_load_frac <= direct.max_lb_load_frac
    assert direct.max_lb_load_frac > 1.5 / direct.k_lbs


def test_gate_isolation_cuts_mice_p99(legs):
    on, off = legs["isolated"][2], legs["shared"][2]
    assert on.elephants_detected == 1 and off.elephants_detected == 1
    assert on.mice_p99_s < off.mice_p99_s
    assert on.mice_completed > 0 and on.elephant_completed > 0


def test_gate_lb_failure_is_hitless_and_respray_identical(legs):
    r = legs["failure"][2]
    assert r.lbs_killed and r.bundles_lost == 0 and r.bundles_completed == r.bundles_sent
    sc = get_fabric_scenario("lb_node_failure")
    again = FabricSim(sc.build_config(device="cpu"), scenario=sc).run()
    assert _comparable(again) == _comparable(r)


def test_gate_lane_partition(legs):
    """Isolation on: the reserved calendars route only to reserved members."""
    sim = legs["isolated"][0]
    reserved = set(sim.reserved_members)
    assert any(iid % 2 == 1 for iid, _ in sim.event_members)
    for (iid, _ev), members in sim.event_members.items():
        if iid % 2 == 1:
            assert members <= reserved


def _lossless(mod, link, **kw):
    base = dict(
        steps=12, k_lbs=3, n_members=9, n_daqs=4, triggers_per_step=3,
        mean_bundle_bytes=6_000, seed=5,
        daq_uplink=link(rate_Bps=0.0), lb_ingress=link(rate_Bps=0.0),
        lb_fabric=link(rate_Bps=0.0), member_link=link(rate_Bps=0.0),
        queue_capacity_s=100.0)
    base.update(kw)
    return mod.FabricConfig(**base)


def _port_cfg(**kw):
    return _lossless(port_fabric, LinkConfig, device="cpu", **kw)


def test_lossless_two_hop_serves_everything_and_keeps_affinity():
    sim = FabricSim(_port_cfg())
    r = sim.run()
    assert r.violations == [] and r.segments_served == r.segments_sent
    assert r.bundles_completed == r.bundles_sent
    assert sim.event_members and all(len(ms) == 1 for ms in sim.event_members.values())


def test_lossy_links_account_every_segment_as_reference():
    def links(lc):
        return dict(daq_uplink=lc(rate_Bps=0.0, loss_prob=0.03, seed=1),
                    lb_fabric=lc(rate_Bps=0.0, loss_prob=0.05, seed=2),
                    member_link=lc(rate_Bps=0.0, loss_prob=0.03, seed=3))
    got = FabricSim(_port_cfg(**links(LinkConfig))).run()
    want = ref_fabric.FabricSim(_lossless(ref_fabric, RefLinkConfig,
                                          **links(RefLinkConfig))).run()
    assert _comparable(got) == _comparable(want)
    assert got.violations == [] and got.lost_uplink > 0 and got.lost_fabric > 0
    assert got.bundles_completed + got.bundles_lost == got.bundles_sent


def test_direct_mode_never_takes_the_fabric_hop():
    r = FabricSim(_port_cfg(mode="direct",
                            lb_fabric=LinkConfig(rate_Bps=0.0, loss_prob=1.0))).run()
    assert r.violations == [] and r.lost_fabric == 0


def test_torch_queue_engine_equals_np():
    sc = get_fabric_scenario("elephant_mice")
    runs = [FabricSim(sc.build_config(steps=20, device="cpu", queue_engine=q),
                      scenario=sc).run() for q in ("np", "torch")]
    assert _comparable(runs[0]) == _comparable(runs[1])


# -- controld --------------------------------------------------------------------

def test_controld_lifecycle_and_failure_drain_equal_reference():
    sims = []
    for mod, link, extra in ((port_fabric, LinkConfig, dict(device="cpu")),
                             (ref_fabric, RefLinkConfig, {})):
        cfg = _lossless(mod, link, controld=True, steps=10, **extra)
        sim = mod.FabricSim(cfg)
        assert sim.fabric_id == "f000000" and len(sim.daemon.sessions) == 2 * cfg.k_lbs
        for i in range(5):
            sim.step(i)
        victim = sim.live[0]
        sim.kill_lb(victim)
        assert all(tok not in sim.daemon.sessions for tok in sim.tokens[victim])
        for i in range(5, 10):
            sim.step(i)
        st = sim.client.status()
        assert len(st["sessions"]) == 2 * (cfg.k_lbs - 1)
        assert len(st["fabrics"][sim.fabric_id]["tokens"]) == 2 * (cfg.k_lbs - 1)
        sims.append(sim)
    port, ref = sims
    assert port.daemon.state_digest() == ref.daemon.state_digest()
    assert port.tokens == ref.tokens


def test_controld_fabric_digest_and_report_equal_reference():
    """elephant_mice as a ReserveFabric tenant: the daemon's digest and the
    whole report equal the reference's; the daemon's calendars route as the
    local ones do."""
    port, ref, got, want = _pair("elephant_mice", controld=True, steps=25)
    assert port.daemon.state_digest() == ref.daemon.state_digest()
    assert _comparable(got) == _comparable(want)
    sc = get_fabric_scenario("elephant_mice")
    local = FabricSim(sc.build_config(device="cpu", steps=25), scenario=sc).run()
    assert got.violations == []
    assert got.mice_p99_s == local.mice_p99_s and got.lb_load_bytes == local.lb_load_bytes


def test_kill_last_lb_refused():
    sim = FabricSim(_port_cfg(k_lbs=1, mode="direct"))
    with pytest.raises(ValueError, match="last live"):
        sim.kill_lb(0)


@pytest.mark.parametrize("kw", [dict(reserved_fraction=1.5), dict(k_lbs=0),
                                dict(n_members=1), "daq_scale"])
def test_config_validation_equals_reference(kw):
    def build(mod, extra):
        if kw == "daq_scale":
            link = LinkConfig if mod is not ref_fabric else RefLinkConfig
            return mod.FabricSim(dataclasses.replace(_lossless(mod, link, **extra),
                                                     daq_scale=np.ones(3)))
        return mod.FabricSim(mod.FabricConfig(**kw, **extra))
    with pytest.raises(ValueError) as got:
        build(port_fabric, dict(device="cpu"))
    with pytest.raises(ValueError) as want:
        build(ref_fabric, {})
    assert str(got.value) == str(want.value)


def test_tier_k8_tables_take_the_global_route_design():
    """bench_fabric's widest tier (K = 8: 16 calendars of 64 member slots)
    is above a block's shared memory: the card routes it with lb_route's
    "global" design; the presets' K = 4 take the shared one."""
    from repro_torch.kernels.lb_route import _design
    for k, design in ((4, "shared"), (8, "global")):
        sc = get_fabric_scenario("vlb_spray")
        sim = FabricSim(sc.build_config(steps=1, k_lbs=k, device="cpu"), scenario=sc)
        t = sim._dp_cache.get().tables
        n_inst, n_members = t.member_node.shape
        assert (n_inst, n_members) == (2 * k, 64)
        assert _design(n_inst, t.calendars.shape[1], n_members) == design


# -- the driver ------------------------------------------------------------------

def _reference_driver():
    spec = importlib.util.spec_from_file_location("run_fabric_ref",
                                                  ROOT / "scripts" / "run_fabric.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--scenario", "lb_node_failure", "--steps", "12", "--metrics-registry"],
    ["--scenario", "vlb_spray", "--steps", "10", "--k-lbs", "8", "--seed", "3"],
])
def test_driver_summary_equals_reference(argv, tmp_path, capsys):
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    rc_ref = _reference_driver().main(argv + ["--json", str(want_p)])
    rc = port_run.main(argv + ["--device", "cpu", "--json", str(got_p)])
    capsys.readouterr()
    assert rc == rc_ref == 0
    assert _strip(json.loads(got_p.read_text())) == _strip(json.loads(want_p.read_text()))


def test_driver_trace_export_equals_reference(tmp_path, capsys):
    """The primary leg's spans (per-LB, per-class aux; the fabric hop),
    byte-equal as Perfetto JSON."""
    argv = ["--scenario", "lb_node_failure", "--steps", "12"]
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    assert _reference_driver().main(argv + ["--trace-out", str(want_p)]) == 0
    assert port_run.main(argv + ["--device", "cpu", "--trace-out", str(got_p)]) == 0
    capsys.readouterr()
    assert got_p.read_bytes() == want_p.read_bytes() and len(got_p.read_bytes()) > 1000


class TestDeviceDefault:
    """The fabric's entry points default to the card and raise without
    CUDA; ``device="cpu"`` runs the plain path."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_points_raise(self, capsys):
        sc = get_fabric_scenario("vlb_spray")
        for make in (lambda: FabricSim(FabricConfig(steps=1)),
                     lambda: FabricSim(sc.build_config(steps=1), scenario=sc),
                     lambda: port_run.main(["--scenario", "vlb_spray", "--steps", "1"])):
            with pytest.raises(RuntimeError, match="cuda"):
                make()
        assert FabricConfig().device == "cuda"
        assert port_run.parse_args([]).device == "cuda"

    def test_cpu_when_asked(self):
        r = FabricSim(_port_cfg(steps=2)).run()
        assert r.segments_sent > 0 and r.violations == []
