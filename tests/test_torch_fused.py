"""repro_torch.simnet.fused on the CPU (the kernels' plain versions): the
fused engine against the port's host engine and against the JAX package's
host engine, its superblock split, its scope and its program counters.

The JAX package's own fused engine does not import under the installed jax
(``from jax.experimental import enable_x64``), so the reference here is
``repro.simnet`` with ``engine="host"``, at the tolerances of the JAX
package's ``tests/test_fused.py``."""
import ast
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

import repro.simnet as ref_simnet
from repro_torch.core.calendar import build_calendar as host_calendar
from repro_torch.kernels.ref import build_calendar_ref, np_sum
from repro_torch.kernels.seq_cumsum import seq_cumsum
from repro_torch.simnet import Simulator, fused, get_scenario
from repro_torch.simnet.fused import FusedEngine, unsupported_reason
from repro_torch.simnet.links import LinkConfig
from repro_torch.simnet.sim import SimConfig

ROOT = Path(__file__).resolve().parents[1]
EXACT_COUNTERS = [
    "packets_sent", "packets_delivered", "packets_lost_wan",
    "packets_lost_downlink", "packets_dropped_queue",
    "packets_discarded_invalid", "duplicates_absorbed",
    "bundles_sent", "bundles_completed", "bundles_pending",
    "bundles_timed_out", "bundles_vanished", "epoch_switches",
]
CLOSE_FIELDS = ["latency_p50_s", "latency_p99_s", "latency_max_s", "latency_mean_s"]


def _run(name, engine, steps=60, **extra):
    scn = get_scenario(name)
    cfg = scn.build_config(steps=steps, engine=engine, device="cpu", **extra)
    return Simulator(cfg, dataclasses.replace(scn)).run()


def _reference(name, steps=60, **extra):
    scn = ref_simnet.get_scenario(name)
    cfg = scn.build_config(steps=steps, engine="host", **extra)
    return ref_simnet.Simulator(cfg, dataclasses.replace(scn)).run()


def _assert_parity(rf, rh):
    """The JAX package's host-vs-fused contract (tests/test_fused.py)."""
    for f in EXACT_COUNTERS:
        assert getattr(rf, f) == getattr(rh, f), f
    for f in CLOSE_FIELDS:
        assert getattr(rf, f) == pytest.approx(getattr(rh, f), rel=1e-9, abs=1e-12), f
    assert rf.per_member_segments == rh.per_member_segments
    assert set(rf.final_weights) == set(rh.final_weights)
    for m, w in rh.final_weights.items():
        assert rf.final_weights[m] == pytest.approx(w, abs=1e-6), m
    assert not rh.violations and not rf.violations
    assert len(rf.weight_trajectory) == len(rh.weight_trajectory)
    for (sh, wh), (sf, wf) in zip(rh.weight_trajectory, rf.weight_trajectory):
        assert sh == sf and set(wh) == set(wf)
        for m in wh:
            assert wf[m] == pytest.approx(wh[m], abs=1e-3), (sh, m)


@pytest.mark.parametrize("scenario", ["baseline", "straggler", "correlated_loss"])
def test_fused_matches_both_host_engines(scenario):
    rf = _run(scenario, "fused")
    rh = _run(scenario, "host")
    assert rf.engine == "fused" and rh.engine == "host"
    _assert_parity(rf, rh)
    _assert_parity(rf, _reference(scenario))


def test_frozen_weights_parity():
    rf = _run("baseline", "fused", steps=40, frozen_weights=True)
    for rh in (_run("baseline", "host", steps=40, frozen_weights=True),
               _reference("baseline", steps=40, frozen_weights=True)):
        assert rf.epoch_switches == rh.epoch_switches == 0
        for f in EXACT_COUNTERS:
            assert getattr(rf, f) == getattr(rh, f), f


def test_fill_trace_parity():
    rf, rh = _run("baseline", "fused", steps=30), _reference("baseline", steps=30)
    assert len(rf.queue_fill_trace) == len(rh.queue_fill_trace)
    for (th, fh), (tf, ff) in zip(rh.queue_fill_trace, rf.queue_fill_trace):
        assert tf == pytest.approx(th, rel=1e-9)
        assert ff == pytest.approx(fh, abs=1e-3)


@pytest.mark.parametrize("seed,steps", [(0, 8), (123, 16), (40961, 19)])
def test_superblock_split_is_unobservable(seed, steps):
    """K=1 (one run per window) and K=8 share the carried state: identical
    final digests and reports."""
    engines = [FusedEngine(Simulator(SimConfig(steps=steps, seed=seed, device="cpu")),
                           superblock=k) for k in (1, 8)]
    r1, r8 = (e.run() for e in engines)
    assert engines[0].state_digest() == engines[1].state_digest()
    assert [e.n_superblocks for e in engines] == [steps, -(-steps // 8)]
    for f in EXACT_COUNTERS:
        assert getattr(r1, f) == getattr(r8, f), f
    assert r1.latency_p99_s == r8.latency_p99_s
    assert r1.final_weights == r8.final_weights
    assert r1.weight_trajectory == r8.weight_trajectory


def _reference_unsupported_reason():
    """The JAX package's ``unsupported_reason``, lifted out of its module
    (which does not import under the installed jax)."""
    src = (ROOT / "src" / "repro" / "simnet" / "fused.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "unsupported_reason")
    ns = {"Optional": Optional, "_STABLE_ARGSORT_MAX": 16}
    exec(compile(ast.Module([fn], []), "ref_fused", "exec"), ns)
    return ns["unsupported_reason"]


@pytest.mark.parametrize("case", [
    dict(), dict(controld=True), dict(n_instances=2, n_daqs=4), dict(stale_after_s=1.0),
    dict(n_members=17), dict(n_members=16), dict(timeout_windows=0),
    dict(steps=(1 << 31) // 7), dict(n_daqs=1 << 16), "burst", "elephant", "link_flap",
    "lease_churn", "straggler"])
def test_scope_strings_equal_reference(case):
    ref_reason = _reference_unsupported_reason()
    if isinstance(case, str):
        scn, ref_scn = get_scenario(case), ref_simnet.get_scenario(case)
        got = unsupported_reason(scn.build_config(steps=6), scn)
        want = ref_reason(ref_scn.build_config(steps=6), ref_scn)
    else:
        got = unsupported_reason(SimConfig(**case))
        want = ref_reason(ref_simnet.SimConfig(**case))
    assert got == want


def test_out_of_scope_runs_on_the_host_engine():
    scn = get_scenario("burst")
    calls0 = fused.FUSED_STEP_CALLS
    r = Simulator(scn.build_config(steps=6, device="cpu"), dataclasses.replace(scn)).run()
    assert r.engine == "host" and fused.FUSED_STEP_CALLS == calls0


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        Simulator(SimConfig(steps=2, engine="gpu", device="cpu")).run()


def test_one_program_one_run_per_superblock():
    # a distinctive shape (n_members=5, triggers=3) so this test owns its
    # program even mid-suite
    base = SimConfig(steps=16, n_members=5, triggers_per_step=3, device="cpu")
    cfgs = [
        base,
        dataclasses.replace(base, member_link=LinkConfig(
            rate_Bps=25e6, prop_delay_s=1e-4, jitter_s=2e-5)),
        dataclasses.replace(base, service_per_packet_s=8e-5),
        dataclasses.replace(base, frozen_weights=True),
    ]
    calls0, traces0 = fused.FUSED_STEP_CALLS, fused.FUSED_TRACES
    for cfg in cfgs:
        assert Simulator(cfg).run().engine == "fused"
    assert fused.FUSED_TRACES - traces0 == 1
    assert fused.FUSED_STEP_CALLS - calls0 == 2 * len(cfgs)


def test_host_loop_never_touches_fused_counters():
    calls0, traces0 = fused.FUSED_STEP_CALLS, fused.FUSED_TRACES
    Simulator(SimConfig(steps=4, engine="host", device="cpu")).run()
    assert (fused.FUSED_STEP_CALLS, fused.FUSED_TRACES) == (calls0, traces0)


@pytest.mark.parametrize("n", [1, 5, 4097, 16_384])
def test_plain_running_sum_is_numpy_cumsum(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 7e-6, n) * rng.choice([1.0, 1e-3, 1e3], n)
    np.testing.assert_array_equal(seq_cumsum(torch.from_numpy(x)).numpy(), np.cumsum(x))


# past 128 lanes numpy sums the two halves of the vector, each pairwise
@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 17, 32, 127, 128, 129, 200, 256, 511, 512])
def test_np_sum_is_numpy_sum(m):
    x = np.random.default_rng(m).uniform(0, 3, m) * np.random.default_rng(m + 1).choice(
        [1.0, 1e-3, 1e5], m)
    assert float(np_sum(torch.from_numpy(x), m)) == float(np.sum(x))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 13, 16])
def test_plain_calendar_equals_host_calendar(m, ties):
    """The fused calendar is the host's (``core.calendar.build_calendar``)
    slot for slot, also when equal weights tie in the quota remainders."""
    w = np.random.default_rng(m).uniform(0.05, 8.0, m)
    if ties:
        w = np.repeat(w[: (m + 2) // 3], 3)[:m]
    out = torch.full((512,), -1, dtype=torch.int32)
    got = build_calendar_ref(torch.from_numpy(w), torch.tensor([True]), out)
    want = host_calendar(np.arange(m, dtype=np.int32), w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert build_calendar_ref(torch.from_numpy(w), torch.tensor([False]),
                              torch.full((512,), -1, dtype=torch.int32)).eq(-1).all()
