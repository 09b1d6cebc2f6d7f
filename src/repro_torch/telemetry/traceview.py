"""Critical-path analysis over ``trace.TraceBuffer`` span sets.

A bundle's *critical path* is the chain of the packet copy whose service
completion defined the bundle's completion time (the first-served copy of
the last-finishing segment): uplink -> WAN -> LB [-> fabric] -> downlink ->
farm wait -> service. By construction the chain partitions
``[t_emit, t_done]`` exactly, so the stage sums reconcile with the
measured E2E latency to machine precision — ``reconcile()`` is the gate
the JAX package's ``scripts/analyze_trace.py`` enforces (<1%).

Percentile selection uses the *complete* completion table (every bundle's
E2E is recorded; sampling only filters spans), so "the p99 bundle" is the
true p99, and the tail-biased reservoir guarantees its waterfall was
retained.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.trace import BUNDLE_PID, TraceBuffer, trace_id

#: stages that sit on the critical path, in pipeline order
PATH_STAGES = ("uplink", "wan", "lb", "fabric", "downlink",
               "farm_wait", "service", "reassembly")


def critical_path(tb: TraceBuffer, key: int) -> Optional[List[Tuple[str, float]]]:
    """``[(stage, seconds), ...]`` along the bundle's critical chain, or
    None if the bundle's spans were not retained / it never completed."""
    return _critical_path(tb, key, tb.spans(), tb.completions())


def _critical_path(tb, key, sp, completions):
    """``critical_path`` on the span set and completion table read once by
    a caller that walks many bundles."""
    ks, te, td = completions
    hit = np.flatnonzero(ks == np.uint64(key))
    if len(hit) == 0:
        return None
    t_done = float(td[hit[0]])
    # the bundle's rows: spans are sorted by key, so they are one slice, in
    # the order a mask over all spans would give them
    lo, hi = np.searchsorted(sp["key"], np.uint64(key), side="left"), \
        np.searchsorted(sp["key"], np.uint64(key), side="right")
    if lo == hi:
        return None
    st, pid, t0, t1 = (sp["stage"][lo:hi], sp["pid"][lo:hi],
                       sp["t0"][lo:hi], sp["t1"][lo:hi])
    svc_id = tb.stage_id("service")
    # critical copy: the service span ending exactly at t_done (duplicate
    # copies of the same segment can finish later; they are off-path)
    svc = np.flatnonzero((st == svc_id) & (t1 <= t_done + 1e-12))
    if len(svc) == 0:
        return None
    crit = svc[np.lexsort((pid[svc], t1[svc]))[-1]]
    chain = np.flatnonzero((pid == pid[crit]) & (pid[crit] < BUNDLE_PID))
    chain = chain[np.argsort(t0[chain], kind="stable")]
    path = [(tb.stage_names[int(st[i])], float(t1[i] - t0[i]))
            for i in chain]
    # reassembly residual: completion minus the critical service finish
    path.append(("reassembly", t_done - float(t1[crit])))
    return path


def reconcile(tb: TraceBuffer, key: int) -> Optional[Tuple[float, float, float]]:
    """(stage_sum, e2e, relative_error) for one bundle's critical path."""
    return _reconcile(tb, key, tb.spans(), tb.completions())


def _reconcile(tb, key, sp, completions):
    path = _critical_path(tb, key, sp, completions)
    if path is None:
        return None
    ks, te, td = completions
    i = np.flatnonzero(ks == np.uint64(key))[0]
    e2e = float(td[i] - te[i])
    ssum = float(sum(d for _, d in path))
    rel = abs(ssum - e2e) / e2e if e2e > 0 else 0.0
    return ssum, e2e, rel


def percentile_key(tb: TraceBuffer, percentile: float) -> Optional[int]:
    """The retained completed bundle nearest the requested E2E percentile
    (preferring the slower side, so p100/p99.9 land on retained tails)."""
    ks, te, td = tb.completions()
    if len(ks) == 0:
        return None
    e2e = td - te
    pv = float(np.percentile(e2e, percentile))
    rk, re2e = tb.retained_completions()
    if len(rk) == 0:
        return None
    at_or_above = re2e >= pv
    if at_or_above.any():
        cand = np.flatnonzero(at_or_above)
        pick = cand[np.lexsort((rk[cand], re2e[cand]))[0]]  # slowest side, min
    else:
        pick = int(np.lexsort((rk, -re2e))[0])              # closest below
    return int(rk[pick])


def stage_decomposition(tb: TraceBuffer, percentile: float) -> Optional[dict]:
    """The analyzer's payload: the percentile bundle's waterfall plus the
    mean decomposition over the tail band (every retained bundle at or
    above the percentile value)."""
    key = percentile_key(tb, percentile)
    if key is None:
        return None
    sp, completions = tb.spans(), tb.completions()
    rec = _reconcile(tb, key, sp, completions)
    path = _critical_path(tb, key, sp, completions)
    if rec is None or path is None:
        return None
    ks, te, td = completions
    e2e_all = td - te
    pv = float(np.percentile(e2e_all, percentile))
    rk, re2e = tb.retained_completions()
    band = rk[re2e >= pv]
    agg: Dict[str, List[float]] = {}
    for k in band[:256]:                      # bounded host work
        p = _critical_path(tb, int(k), sp, completions)
        if p is None:
            continue
        for sname, dur in p:
            agg.setdefault(sname, []).append(dur)
    band_mean = {s: float(np.mean(v)) for s, v in agg.items()}
    stages = {s: d for s, d in path}
    dominant = max(stages, key=lambda s: stages[s])
    return dict(percentile=percentile, percentile_value_s=pv,
                key=int(key), trace_id=trace_id(key),
                e2e_s=rec[1], stage_sum_s=rec[0], reconcile_rel_err=rec[2],
                stages=stages, dominant=dominant,
                band_n=int(len(band)), band_mean=band_mean)


def format_table(d: dict) -> str:
    """Human-readable stage-decomposition table."""
    lines = [
        f"p{d['percentile']:g} bundle {d['trace_id']}  "
        f"e2e={d['e2e_s'] * 1e3:.3f}ms  "
        f"(percentile value {d['percentile_value_s'] * 1e3:.3f}ms, "
        f"band n={d['band_n']})",
        f"{'stage':<12} {'ms':>10} {'% of e2e':>9} {'band mean ms':>13}",
    ]
    e2e = d["e2e_s"] or 1.0
    for s in PATH_STAGES:
        if s not in d["stages"]:
            continue
        dur = d["stages"][s]
        bm = d["band_mean"].get(s)
        lines.append(
            f"{s:<12} {dur * 1e3:>10.4f} {100.0 * dur / e2e:>8.1f}% "
            f"{(bm * 1e3 if bm is not None else float('nan')):>13.4f}")
    lines.append(
        f"{'sum':<12} {d['stage_sum_s'] * 1e3:>10.4f} "
        f"{100.0 * d['stage_sum_s'] / e2e:>8.1f}% "
        f"(reconciles to {d['reconcile_rel_err'] * 100:.4f}%)")
    lines.append(f"dominant stage: {d['dominant']} "
                 f"({d['stages'][d['dominant']] * 1e3:.4f}ms, "
                 f"{100.0 * d['stages'][d['dominant']] / e2e:.1f}% of e2e)")
    return "\n".join(lines)


def summary_json(tb: TraceBuffer, percentiles=(50.0, 99.0)) -> dict:
    """Compact per-stage breakdown for the bench-trend dashboard."""
    out: dict = dict(windows=tb.windows, n_spans=int(len(tb.spans()["key"])),
                     n_completions=int(len(tb.completions()[0])),
                     percentiles={})
    for p in percentiles:
        d = stage_decomposition(tb, p)
        if d is not None:
            out["percentiles"][f"p{p:g}"] = dict(
                e2e_s=d["e2e_s"], trace_id=d["trace_id"],
                dominant=d["dominant"], stages=d["stages"])
    return out
