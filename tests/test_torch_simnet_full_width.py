"""The ``--compare-frozen`` comparison at the smoke's full-width straggler
traffic (16 members, 16 DAQs, 128 triggers of 64 kB bundles a window, 10 GbE
member links, the farm's cost at 0.55 of its capacity) on the CPU: the
port's closed and frozen legs against the JAX package's host engine on the
same config.

At this traffic the reference's own closed loop trails frozen weights on
p99 after a few reweights, where at the straggler preset's size it wins, so
the preset's gate outcome here is the reference's policy, not the port's.
This test holds the port to the reference's two legs (counters exact,
latencies within rel 1e-9) and to the same gate outcome at 12 windows.
"""
import dataclasses

import pytest

from repro_torch.simnet import run as port_run

WINDOWS = 12
N_MEMBERS = 16
REL = 1e-9


def _full_width(build_config, mtu_payload, link_config, **extra):
    return build_config(
        steps=WINDOWS, n_members=N_MEMBERS, n_daqs=16, triggers_per_step=128,
        mean_bundle_bytes=64_000, mtu_payload=mtu_payload,
        member_link=link_config(rate_Bps=1.25e9, prop_delay_s=5e-5, jitter_s=2e-5),
        service_per_byte_s=0.55 * N_MEMBERS / 1.024e9, engine="host", controld=True,
        **extra)


def _reference_legs():
    from repro.data.segmentation import DEFAULT_MTU_PAYLOAD
    from repro.simnet import get_scenario
    from repro.simnet.links import LinkConfig
    from repro.simnet.sim import Simulator

    scn = get_scenario("straggler")
    return {frozen: Simulator(_full_width(scn.build_config, DEFAULT_MTU_PAYLOAD, LinkConfig,
                                          frozen_weights=frozen),
                              dataclasses.replace(scn)).run()
            for frozen in (False, True)}


def _assert_close(got, want, path):
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


def _comparable(report):
    d = report.to_dict(with_traces=True)
    d.pop("wall_s")
    d.pop("packets_per_sec")
    return d


def test_full_width_compare_frozen_equals_reference():
    from repro_torch.data.segmentation import DEFAULT_MTU_PAYLOAD
    from repro_torch.simnet.links import LinkConfig

    want = _reference_legs()
    scn = port_run.get_scenario("straggler")
    cfg = _full_width(scn.build_config, DEFAULT_MTU_PAYLOAD, LinkConfig, device="cpu")
    report, _ = port_run.run_leg(cfg, scn)
    legs = port_run.Legs(cfg, scn, report)
    block, bad = port_run.frozen_compare(legs)
    got = {False: report, True: legs.get(frozen=True)}
    for frozen in (False, True):
        _assert_close(_comparable(got[frozen]), _comparable(want[frozen]), f"frozen={frozen}")
    gain = want[True].latency_p99_s - want[False].latency_p99_s
    assert block["p99_gain_vs_frozen_s"] == round(gain, 9)
    assert bool(bad) == (gain <= 0)
    print(f"\nfull width, {WINDOWS} windows: closed p99 {want[False].latency_p99_s!r} s, "
          f"frozen p99 {want[True].latency_p99_s!r} s (reference == port), "
          f"gate {'holds' if not bad else 'does not hold'}")
