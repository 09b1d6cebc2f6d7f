"""The port's serving engine on the CPU against the JAX package's, from the
same prompts and the same weights (the dense, moe, hybrid and ssm smoke
configs): the front door (event numbers, entropy, one batched route per
tick), the routing, the lanes, the greedy tokens and the stats are equal; a drained replica gets no new work; lanes are
isolated; the launcher runs; and nothing runs on the CPU by default."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _lib
from repro_torch.launch import serve as t_launch
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeConfig, ServingEngine

FIELDS = ("rid", "event_number", "entropy", "member", "node", "lane", "output", "done")


def _engines(n_replicas, max_len, lane_bits=1, arch="yi_6b"):
    cfg = j_smoke(arch)
    tree = JM.init_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, tree),
                                  get_smoke_config(arch), "cpu")
    j = JEngine(cfg, JServeConfig(n_replicas=n_replicas, lane_bits=lane_bits,
                                  max_len=max_len), tree)
    t = ServingEngine(get_smoke_config(arch),
                      ServeConfig(n_replicas=n_replicas, lane_bits=lane_bits,
                                  max_len=max_len, device="cpu"), params)
    return j, t


def _view(reqs):
    return [{f: getattr(r, f) for f in FIELDS} for r in reqs]


def _submit(eng, rng, n, lo, hi, max_new):
    return [eng.submit(rng.integers(0, 256, int(rng.integers(lo, hi))), max_new_tokens=max_new)
            for _ in range(n)]


def test_engine_equals_jax_engine():
    j, t = _engines(2, 64)
    jr = _submit(j, np.random.default_rng(0), 9, 4, 10, 6)
    tr = _submit(t, np.random.default_rng(0), 9, 4, 10, 6)
    j.run_until_done(300)
    t.run_until_done(300)
    assert _view(tr) == _view(jr)
    assert t.stats == j.stats
    assert all(r.done and len(r.output) == 6 for r in tr)
    assert len(t.stats["routed"]) == 2 and t.stats["route_calls"] == 1


def test_drain_equals_jax_engine():
    """examples/serve_lb.py: 12 requests over 3 replicas, then replica 1 is
    weighted to 0 in the next epoch; 12 more requests never reach it."""
    j, t = _engines(3, 96)
    views, deltas = [], []
    for eng in (j, t):
        rng = np.random.default_rng(0)
        reqs = _submit(eng, rng, 12, 4, 12, 8)
        eng.run_until_done()
        eng.cp.weights[1] = 0.0
        eng.cp.schedule_epoch(eng.next_event, boundary=eng.next_event)
        before = dict(eng.stats["routed"])
        reqs += [eng.submit(rng.integers(0, 256, 6), max_new_tokens=6) for _ in range(12)]
        eng.run_until_done()
        deltas.append({k: eng.stats["routed"].get(k, 0) - before.get(k, 0) for k in (0, 1, 2)})
        views.append(_view(reqs))
    assert views[1] == views[0]
    assert deltas[1] == deltas[0] and deltas[1][1] == 0
    assert all(v["done"] for v in views[1])


def test_lane_isolation():
    """Two concurrent requests in different lanes don't corrupt each other:
    outputs equal the solo runs."""
    _, eng = _engines(2, 64)
    p1, p2 = np.arange(6), np.arange(6)[::-1].copy()
    solo1 = eng.submit(p1, max_new_tokens=5)
    eng.run_until_done(100)
    solo2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(100)
    r1 = eng.submit(p1, max_new_tokens=5)
    r2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(200)
    assert r1.output == solo1.output
    assert r2.output == solo2.output


@pytest.mark.parametrize("lane_bits", [1, 2])
def test_moe_engine_equals_jax_engine(lane_bits):
    """The Mixtral smoke config behind the front door: the same routes,
    lanes and greedy tokens as the JAX engine, with prompts past the
    16-token window (plain attention, a ring of 16 slots). Each decode
    step feeds every lane, idle ones too, into the shared expert capacity,
    as the reference does (at 4 lanes n*k = 8 meets the floor of 8)."""
    j, t = _engines(2, 64, lane_bits=lane_bits, arch="mixtral_8x22b")
    jr = _submit(j, np.random.default_rng(3), 9, 4, 24, 6)
    tr = _submit(t, np.random.default_rng(3), 9, 4, 24, 6)
    j.run_until_done(300)
    t.run_until_done(300)
    assert _view(tr) == _view(jr)
    assert t.stats == j.stats
    assert any(len(r.prompt) > 16 for r in tr) and any(len(r.prompt) <= 16 for r in tr)
    assert all(r.done and len(r.output) == 6 for r in tr)


def test_moe_lane_isolation():
    """Lanes share the experts' capacity in a decode step; at 2 lanes
    nothing drops, so two concurrent requests equal their solo runs."""
    _, eng = _engines(2, 64, arch="arctic_480b")
    p1, p2 = np.arange(6), np.arange(6)[::-1].copy()
    solo1 = eng.submit(p1, max_new_tokens=5)
    eng.run_until_done(100)
    solo2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(100)
    r1 = eng.submit(p1, max_new_tokens=5)
    r2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(200)
    assert r1.output == solo1.output
    assert r2.output == solo2.output


@pytest.mark.parametrize("lane_bits", [1, 2])
@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
def test_hybrid_and_ssm_engines_equal_jax_engine(arch, lane_bits):
    """The Zamba2 and RWKV6 smoke configs behind the front door: the same
    routes, lanes, greedy tokens and stats as the JAX engine at 2 and 4
    lanes a replica (each lane's Mamba2, RWKV6 and KV states written along
    the lane axis)."""
    j, t = _engines(2, 64, lane_bits=lane_bits, arch=arch)
    jr = _submit(j, np.random.default_rng(4), 9, 4, 24, 6)
    tr = _submit(t, np.random.default_rng(4), 9, 4, 24, 6)
    j.run_until_done(300)
    t.run_until_done(300)
    assert _view(tr) == _view(jr)
    assert t.stats == j.stats
    assert all(r.done and len(r.output) == 6 for r in tr)


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
def test_hybrid_and_ssm_lane_isolation(arch):
    """A lane's recurrent state is its own: two concurrent requests equal
    their solo runs."""
    _, eng = _engines(2, 64, arch=arch)
    p1, p2 = np.arange(6), np.arange(6)[::-1].copy()
    solo1 = eng.submit(p1, max_new_tokens=5)
    eng.run_until_done(100)
    solo2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(100)
    r1 = eng.submit(p1, max_new_tokens=5)
    r2 = eng.submit(p2, max_new_tokens=5)
    eng.run_until_done(200)
    assert r1.output == solo1.output
    assert r2.output == solo2.output


def test_rebalance_closes_the_loop():
    """With ``rebalance_every`` the engine reweights from decode telemetry
    and garbage-collects drained epochs; requests still all complete."""
    cfg = get_smoke_config("yi_6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    eng = ServingEngine(cfg, ServeConfig(n_replicas=2, lane_bits=1, max_len=64,
                                         rebalance_every=2, device="cpu"), params)
    eng.hub.report_step(1, step_time=1.0, backlog=8, processed=1)  # replica 1 looks slow
    reqs = _submit(eng, np.random.default_rng(2), 8, 4, 10, 5)
    eng.run_until_done(300)
    assert eng.stats["rebalances"] >= 1
    assert all(r.done and len(r.output) == 5 for r in reqs)


def test_prefill_counts_no_kernel_launch_on_the_cpu():
    _, eng = _engines(2, 64)
    _lib.reset_launches()
    eng.submit(np.arange(7), max_new_tokens=2)
    eng.run_until_done(50)
    assert all(n == 0 for n in _lib.LAUNCHES.values())


def test_launcher_on_the_cpu(capsys):
    eng = t_launch.main(["--arch", "yi-6b", "--requests", "4", "--max-new", "3",
                         "--device", "cpu"])
    assert eng.stats["completed"] == 4
    assert "served 4 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_launcher_runs_the_moe_archs_on_the_cpu(capsys, arch):
    eng = t_launch.main(["--arch", arch, "--requests", "4", "--max-new", "3",
                         "--device", "cpu"])
    assert eng.stats["completed"] == 4 and eng.mcfg.family == "moe"
    assert "served 4 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch,family", [("zamba2-2.7b", "hybrid"), ("rwkv6-7b", "ssm")])
def test_launcher_runs_the_hybrid_and_ssm_archs_on_the_cpu(capsys, arch, family):
    eng = t_launch.main(["--arch", arch, "--requests", "4", "--max-new", "3",
                         "--device", "cpu"])
    assert eng.stats["completed"] == 4 and eng.mcfg.family == family
    assert "served 4 requests / 12 tokens" in capsys.readouterr().out


def test_engine_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    cfg = get_smoke_config("yi_6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, ServeConfig(), params)


@pytest.mark.parametrize("greedy", [True, False])
def test_serve_config_takes_greedy(greedy):
    """``greedy`` as in the reference's ServeConfig (unused there too:
    decoding always takes the argmax); its default is the reference's."""
    assert ServeConfig(greedy=greedy).greedy is greedy
    assert ServeConfig().greedy == JServeConfig().greedy


# -- controld mode ------------------------------------------------------------

PINNED_NOW = 1_000.0  # the daemons' clock in the controld tests (leases, spans)


@pytest.fixture
def pinned_controld(monkeypatch):
    """Both daemons on one fixed clock, and every decode step reported as
    the same time in both engines.

    The daemon's default clock is wall time (``time.time``, bound as the
    default of ``ControlDaemon(clock=...)``), and a lease deadline is part of
    ``state_digest``; the engines look ``ControlDaemon`` up by name, so each
    name is patched to a daemon on the pinned clock. A decode step's time is
    wall time in both packages too, and it reaches the policy (the replica's
    rate and fill) and the daemon's state, so it is pinned at the hub."""
    import functools

    import repro.controld as ref_controld
    from repro_torch.serve import engine as port_engine

    monkeypatch.setattr(ref_controld, "ControlDaemon", functools.partial(
        ref_controld.ControlDaemon, clock=lambda: PINNED_NOW))
    monkeypatch.setattr(port_engine, "ControlDaemon", functools.partial(
        port_engine.ControlDaemon, clock=lambda: PINNED_NOW))

    def pin_step_times(eng):
        report = eng.hub.report_step

        def pinned(m, step_time, **kw):
            return report(m, step_time=0.01 * (m + 1), **kw)

        eng.hub.report_step = pinned
        return eng

    return pin_step_times


def _controld_engines(pin, metrics=None, **serve):
    cfg = j_smoke("yi_6b")
    tree = JM.init_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, tree),
                                  get_smoke_config("yi_6b"), "cpu")
    kw = dict(n_replicas=3, lane_bits=1, max_len=64, rebalance_every=2,
              use_controld=True, **serve)
    regs = metrics or (None, None)
    j = pin(JEngine(cfg, JServeConfig(**kw), tree, metrics=regs[0]))
    t = pin(ServingEngine(get_smoke_config("yi_6b"), ServeConfig(device="cpu", **kw), params,
                          metrics=regs[1]))
    return j, t


def _serve_both(j, t, n=10):
    out = []
    for eng in (j, t):
        # one prompt length: the reference compiles one prefill per length
        reqs = _submit(eng, np.random.default_rng(3), n, 6, 7, 4)
        eng.run_until_done(400)
        out.append(_view(reqs))
    return out


@pytest.mark.parametrize("policy", ["proportional", "pid"])
def test_controld_mode_equals_reference(pinned_controld, policy):
    """The engine as a tenant of the daemon, traced and with a registry:
    the same requests get the same routes and tokens, the same rebalances
    happen, and the daemons end with the same state digest; the daemon's
    spans (one trace id per rebalance window) equal the reference's but for
    their durations (wall-clock handling time in both packages); the
    registry's counters and gauges are equal, and so is the decode
    histogram's count (its sum and buckets are wall time)."""
    from repro.telemetry.registry import MetricsRegistry as JRegistry
    from repro_torch.telemetry.registry import MetricsRegistry

    regs = (JRegistry(), MetricsRegistry())
    j, t = _controld_engines(pinned_controld, metrics=regs, controld_policy=policy,
                             trace=True)
    assert t.daemon is not None and t.token == j.token
    jr, tr = _serve_both(j, t, n=8)
    assert tr == jr
    assert t.stats == j.stats and t.stats["rebalances"] >= 1
    assert all(r["done"] for r in tr)
    assert t.daemon.state_digest() == j.daemon.state_digest()

    assert t.trace.stage_names == j.trace.stage_names
    got, want = t.trace.spans(), j.trace.spans()
    assert len(want["key"]) > 0
    for k in want:
        if k != "t1":
            assert np.array_equal(got[k], want[k]), k
    assert all(int(k) >> 62 == 1 for k in got["key"])
    assert all(t.trace.stage_names[int(i)].startswith("controld.") for i in got["stage"])

    want, got = regs[0].sample(), regs[1].sample()
    assert sorted(got) == sorted(want)
    wall = [k for k in want if k.startswith("serve_decode_step_seconds_sum")]
    assert wall
    assert {k: v for k, v in got.items() if k not in wall} == \
        {k: v for k, v in want.items() if k not in wall}
    assert got["serve_requests_total"] == got["serve_completed_total"] == 8
    assert got["serve_decode_step_seconds_count"] > 0
    assert [ln.split(" ")[0] for ln in regs[1].render().splitlines()] == \
        [ln.split(" ")[0] for ln in regs[0].render().splitlines()]


def test_metrics_without_controld_equal_reference():
    from repro.telemetry.registry import MetricsRegistry as JRegistry
    from repro_torch.telemetry.registry import MetricsRegistry

    cfg = j_smoke("yi_6b")
    tree = JM.init_params(jax.random.PRNGKey(0), cfg)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, tree),
                                  get_smoke_config("yi_6b"), "cpu")
    regs = (JRegistry(), MetricsRegistry())
    j = JEngine(cfg, JServeConfig(n_replicas=2, max_len=64), tree, metrics=regs[0])
    t = ServingEngine(get_smoke_config("yi_6b"), ServeConfig(n_replicas=2, max_len=64,
                                                             device="cpu"),
                      params, metrics=regs[1])
    jr, tr = _serve_both(j, t, n=5)
    assert tr == jr and t.daemon is None and t.trace is None
    want, got = regs[0].sample(), regs[1].sample()
    for k in ("serve_requests_total", "serve_completed_total", "serve_queue_depth",
              "serve_active_slots", "serve_decode_step_seconds_count"):
        assert got[k] == want[k], k


def test_serve_config_controld_fields_equal_reference():
    ref, port = JServeConfig(), ServeConfig()
    for f in ("use_controld", "controld_policy", "lease_s", "trace", "rebalance_every"):
        assert getattr(port, f) == getattr(ref, f), f
