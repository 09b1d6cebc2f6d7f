"""The port's telemetry (``repro_torch.telemetry``: registry, export, trace,
traceview) against the JAX package's: the same calls on both give
byte-equal Prometheus text, JSONL rows and Perfetto JSON, and the same
sampling decisions, keys and critical paths."""
import json
import urllib.request

import numpy as np
import pytest

import repro.telemetry.export as jexport
import repro.telemetry.metrics as jmetrics
import repro.telemetry.registry as jreg
import repro.telemetry.trace as jtrace
import repro.telemetry.traceview as jview
import repro_torch.telemetry.export as texport
import repro_torch.telemetry.metrics as tmetrics
import repro_torch.telemetry.registry as treg
import repro_torch.telemetry.trace as ttrace
import repro_torch.telemetry.traceview as tview


def _golden_registry(reg_mod):
    """``tests/test_observability.py``'s golden registry."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("kind",))
    c.labels(kind="get").inc(3)
    c.labels(kind="put").inc()
    reg.gauge("temp", "temperature").set(1.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(2.0)
    return reg


def _busy_registry(reg_mod):
    """Every metric kind, labels that need escaping, default buckets, a
    callback gauge, one that raises (NaN) and a removed child."""
    rng = np.random.default_rng(5)
    reg = reg_mod.MetricsRegistry()
    fam = reg.counter("events_total", "events by kind", labelnames=("kind", "site"))
    for k in range(7):
        fam.labels(kind=f"k{k % 3}", site='a"b\\c\nd' if k == 4 else "s").inc(k + 0.5)
    g = reg.gauge("fill", "queue fill", labelnames=("member",))
    for m in range(5):
        g.labels(member=str(m)).set(float(rng.random()))
    g.remove(member="2")
    reg.gauge("cb", "callback").set_function(lambda: 2.25)
    reg.gauge("broken", "raises at scrape").set_function(lambda: 1 / 0)
    lat = reg.histogram("lat_seconds", "e2e latency", buckets=reg_mod.LATENCY_BUCKETS_S)
    lat.observe_many(rng.exponential(3e-3, 500))
    lat.observe(12.0)
    size = reg.histogram("batch_size", "members per frame", buckets=reg_mod.SIZE_BUCKETS)
    for v in rng.integers(1, 5000, 40):
        size.observe(float(v))
    return reg


@pytest.mark.parametrize("build", [_golden_registry, _busy_registry])
def test_prometheus_text_byte_equal(build):
    j, t = build(jreg), build(treg)
    assert t.render() == j.render()
    assert t.sample() == pytest.approx(j.sample(), nan_ok=True)
    assert json.dumps(t.sample(), sort_keys=True) == json.dumps(j.sample(), sort_keys=True)


def test_bucket_layouts_equal():
    assert treg.LATENCY_BUCKETS_S == jreg.LATENCY_BUCKETS_S
    assert treg.SIZE_BUCKETS == jreg.SIZE_BUCKETS
    for args in [(1.0, 100.0, 1), (1e-6, 10.0, 4), (0.5, 512.0, 3)]:
        assert treg.log_buckets(*args[:2], per_decade=args[2]) == jreg.log_buckets(
            *args[:2], per_decade=args[2])


def test_metrics_module_re_exports_the_registry():
    for name in ("LATENCY_BUCKETS_S", "SIZE_BUCKETS", "Counter", "Gauge", "Histogram",
                 "MetricsRegistry", "log_buckets"):
        assert hasattr(jmetrics, name)
        assert getattr(tmetrics, name) is getattr(treg, name)


def test_time_series_jsonl_equal(tmp_path):
    rows = {}
    for name, reg_mod, exp in (("j", jreg, jexport), ("t", treg, texport)):
        reg = _busy_registry(reg_mod)
        path = tmp_path / f"{name}.jsonl"
        with exp.TimeSeriesWriter(str(path), reg) as w:
            for step in range(3):
                reg.counter("steps_total").inc()
                w.write(step=step, t_sim=0.25 * step)
        rows[name] = path.read_bytes()
    assert rows["t"] == rows["j"]
    assert len(rows["t"].splitlines()) == 3


def test_http_metrics_endpoint_serves_the_registry():
    reg = _golden_registry(treg)
    server, port = texport.start_http_server(reg, host="127.0.0.1", port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
    finally:
        server.shutdown()
        server.server_close()
    assert body == _golden_registry(jreg).render()
    assert ctype == texport.CONTENT_TYPE == jexport.CONTENT_TYPE


def test_ids_and_keys_equal():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**63, 4096, dtype=np.int64).astype(np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 4096).astype(np.uint64)
    assert np.array_equal(ttrace.mix64(x), jtrace.mix64(x))
    for k in (0, 1, 0xDEADBEEF, (1 << 62) | 17, 2**64 - 1):
        assert ttrace.trace_id(k) == jtrace.trace_id(k)
        assert ttrace.parse_trace_id(ttrace.trace_id(k)) == k
    ev, daq = rng.integers(0, 1 << 40, 300), rng.integers(0, 1 << 16, 300)
    assert np.array_equal(ttrace.bundle_key(ev, daq), jtrace.bundle_key(ev, daq))
    assert ttrace.STAGES == jtrace.STAGES
    assert ttrace.BUNDLE_PID == jtrace.BUNDLE_PID


def _golden_buffer(mod):
    """``tests/test_trace.py``'s golden Perfetto buffer."""
    tb = mod.TraceBuffer(mod.TraceConfig(head_rate=1.0, tail_k=4))
    ks = mod.bundle_key([1, 2], [0, 1])
    tb.record_window("emit_wait", ks, [0.0, 0.001], [0.002, 0.003])
    tb.record_window("uplink", ks, [0.002, 0.003], [0.004, 0.0055],
                     pid=np.asarray([0, 1], np.uint64), aux=[0, 1])
    tb.complete_window(ks, [0.0, 0.001], [0.01, 0.02])
    tb.end_window()
    return tb


def _sampled_buffer(mod, head_rate, tail_k, seed):
    """A few windows of random bundles, head-sampled at ``head_rate`` with a
    top-``tail_k`` tail reservoir, compacting every other window; some
    bundles never complete."""
    rng = np.random.default_rng(seed)
    tb = mod.TraceBuffer(mod.TraceConfig(head_rate=head_rate, tail_k=tail_k, seed=seed,
                                         compact_every=2))
    pid0 = 0
    for w in range(6):
        n = 40
        ks = mod.bundle_key(np.arange(w * n, (w + 1) * n), rng.integers(0, 4, n))
        t0 = w * 0.01 + rng.random(n) * 1e-3
        t1 = t0 + rng.exponential(2e-3, n)
        t2 = t1 + rng.exponential(1e-3, n)
        tb.record_window("emit_wait", ks, t0, t1)
        pid = np.uint64(pid0) + np.arange(n, dtype=np.uint64)
        pid0 += n
        tb.record_window("wan", ks, t1, t2, pid=pid, aux=rng.integers(0, 8, n))
        tb.record_window("custom_stage", ks[::3], t1[::3], t2[::3])
        done = rng.random(n) < 0.8
        tb.complete_window(ks[done], t0[done], t2[done] + 1e-4)
        tb.end_window()
    return tb


@pytest.mark.parametrize("head_rate,tail_k,seed", [(1.0, 4, 0), (0.3, 5, 1),
                                                   (0.0, 3, 2), (0.05, 0, 3)])
def test_sampling_decisions_and_exports_equal(head_rate, tail_k, seed):
    j = _sampled_buffer(jtrace, head_rate, tail_k, seed)
    t = _sampled_buffer(ttrace, head_rate, tail_k, seed)
    keys = jtrace.bundle_key(np.arange(500), np.arange(500) % 7)
    assert np.array_equal(t.head_sampled(keys), j.head_sampled(keys))
    assert np.array_equal(t.tail_keys(), j.tail_keys())
    assert np.array_equal(t.retained_keys(), j.retained_keys())
    js, ts = j.spans(), t.spans()
    assert js.keys() == ts.keys()
    for k in js:
        assert np.array_equal(ts[k], js[k]), k
    assert t.to_perfetto_json() == j.to_perfetto_json()
    assert json.dumps(t.to_summary(), sort_keys=True) == json.dumps(j.to_summary(),
                                                                    sort_keys=True)
    assert t.exemplars(jreg.LATENCY_BUCKETS_S) == j.exemplars(jreg.LATENCY_BUCKETS_S)


def test_perfetto_golden_bytes_equal():
    assert _golden_buffer(ttrace).to_perfetto_json() == _golden_buffer(jtrace).to_perfetto_json()


def test_summary_round_trip_equal():
    j = _sampled_buffer(jtrace, 0.5, 4, 7)
    t = ttrace.TraceBuffer.from_summary(j.to_summary())
    assert t.to_perfetto_json() == j.to_perfetto_json()


def test_traceview_equal_on_a_traced_simulation():
    """The critical-path views over the same traced host-engine run."""
    import dataclasses

    import repro.simnet as J
    import repro_torch.simnet as T
    kw = dict(steps=10, triggers_per_step=16, n_daqs=2, n_members=4,
              mean_bundle_bytes=6_000, trace=True, trace_tail_k=8, engine="host")
    js, ts = J.get_scenario("straggler"), T.get_scenario("straggler")
    jsim = J.Simulator(js.build_config(**kw), dataclasses.replace(js))
    tsim = T.Simulator(ts.build_config(device="cpu", **kw), dataclasses.replace(ts))
    jsim.run()
    tsim.run()
    jb, tb = jsim.trace, tsim.trace
    assert tb.to_perfetto_json() == jb.to_perfetto_json()
    assert json.dumps(tview.summary_json(tb), sort_keys=True) == json.dumps(
        jview.summary_json(jb), sort_keys=True)
    for p in (50.0, 90.0, 99.0):
        key = jview.percentile_key(jb, p)
        assert tview.percentile_key(tb, p) == key
        assert tview.critical_path(tb, key) == jview.critical_path(jb, key)
        assert tview.reconcile(tb, key) == jview.reconcile(jb, key)
        d = tview.stage_decomposition(tb, p)
        assert d == jview.stage_decomposition(jb, p)
        assert tview.format_table(d) == jview.format_table(d)
