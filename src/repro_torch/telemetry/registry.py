"""Metrics registry: counters, gauges, histograms -> Prometheus text format.

The live-telemetry surface the paper's LB host implies but our repro lacked:
every long-running component (``controld`` daemon, socket server, simnet /
serve loops) registers its counters and histograms here, and the registry
renders the Prometheus text-exposition format (v0.0.4) for the ``/metrics``
endpoint (``telemetry.export.start_http_server``) or a flat sample dict for
JSONL time-series emission (``telemetry.export.TimeSeriesWriter``).

Hot-path contract (the JAX package's bench_metrics gates this at <5% on the batched heartbeat
path): a counter ``inc`` is one attribute add, a histogram ``observe`` is one
bisect + three adds, and ``observe_many`` ingests a whole window of latencies
as a single ``np.searchsorted`` + ``bincount``. Gauges can be *callbacks*
(``set_function``) so occupancy-style metrics cost nothing until scrape time.
Updates are plain Python ops under the GIL — approximately atomic, which is
the right trade for monitoring data (a scrape racing an increment reads a
value at most one update stale, never a corrupt one).

Latency histograms share one fixed log-spaced bucket layout
(``LATENCY_BUCKETS_S``: 1 us .. 10 s, 4 buckets per decade) so series from
different subsystems are comparable and dashboards can overlay them.
"""
from __future__ import annotations

import re
from bisect import bisect_left
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Fixed log-spaced bucket upper bounds from ``lo`` to ``hi`` inclusive."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError("need 0 < lo < hi and per_decade > 0")
    n = int(round(np.log10(hi / lo) * per_decade))
    edges = [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]
    return tuple(edges)


#: the shared latency layout: 1 us .. 10 s, 4 buckets/decade (29 edges)
LATENCY_BUCKETS_S = log_buckets(1e-6, 10.0, per_decade=4)

#: power-of-two size layout for batch/pipeline-depth histograms
SIZE_BUCKETS = tuple(float(1 << i) for i in range(15))  # 1 .. 16384


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.10g}"


def _fmt_le(e: float) -> str:
    return f"{float(e):.6g}"


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Optional[tuple] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _CounterChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_value", "_fn")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Collect-time callback: the gauge costs nothing until scraped."""
        self._fn = fn

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")  # a scrape must never crash the server
        return self._value


class _HistogramChild:
    __slots__ = ("buckets", "_counts", "_sum", "_count", "_exemplars")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        # bucket index -> (trace_id, value): cross-reference into the
        # tracing layer (telemetry.trace); rendered as an OpenMetrics-style
        # exemplar suffix only when present, so the plain text format (and
        # its golden test) is unchanged without tracing
        self._exemplars: dict = {}

    def observe(self, v: float) -> None:
        self._counts[bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1

    def observe_many(self, values) -> None:
        """One window of samples in one vectorized pass."""
        arr = np.asarray(values, np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.buckets, arr, side="left")
        add = np.bincount(idx, minlength=len(self.buckets) + 1)
        for i in np.flatnonzero(add):
            self._counts[i] += int(add[i])
        self._sum += float(arr.sum())
        self._count += int(arr.size)

    def put_exemplars(self, values, trace_ids) -> None:
        """Link sampled trace ids to the buckets their values land in (the
        last value per bucket wins — freshest exemplar, one vectorized
        bucketing pass per window)."""
        arr = np.asarray(values, np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.buckets, arr, side="left")
        for i, b in enumerate(idx):
            self._exemplars[int(b)] = (trace_ids[i], float(arr[i]))

    def value(self) -> tuple:
        return (tuple(self._counts), self._sum, self._count)


class _Family:
    """A named metric family; labeled children keyed by label-value tuple.

    A family declared without labels is bound straight to one child, so
    ``registry.counter("x_total").inc()`` works without a ``labels()`` hop.
    """

    kind = "untyped"
    child_cls: type = _CounterChild

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self.child_cls()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def remove(self, **kv) -> None:
        """Drop one labeled child (e.g. a freed controld session)."""
        key = tuple(str(kv[n]) for n in self.labelnames)
        self._children.pop(key, None)

    def _bound(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...)")
        return self._children[()]

    # -- unlabeled convenience pass-throughs ----------------------------------
    def inc(self, amount: float = 1.0) -> None:
        self._bound().inc(amount)

    def samples(self):
        for key in sorted(self._children):
            yield key, self._children[key]


class Counter(_Family):
    kind = "counter"
    child_cls = _CounterChild

    def value(self) -> float:
        return self._bound().value()


class Gauge(_Family):
    kind = "gauge"
    child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._bound().set(v)

    def dec(self, amount: float = 1.0) -> None:
        self._bound().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._bound().set_function(fn)

    def value(self) -> float:
        return self._bound().value()


class Histogram(_Family):
    kind = "histogram"
    child_cls = _HistogramChild

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Optional[tuple] = None):
        self.buckets = tuple(sorted(buckets)) if buckets else LATENCY_BUCKETS_S
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._bound().observe(v)

    def observe_many(self, values) -> None:
        self._bound().observe_many(values)

    def put_exemplars(self, values, trace_ids) -> None:
        self._bound().put_exemplars(values, trace_ids)


class MetricsRegistry:
    """Get-or-create registry over named metric families.

    ``counter``/``gauge``/``histogram`` are idempotent: asking again with the
    same name returns the existing family (kind and labelnames must match —
    a name collision across kinds is a bug, not a merge)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Iterable[str], **kw) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.labelnames}")
            return fam
        fam = cls(name, help, labelnames, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[tuple] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def unregister(self, name: str) -> None:
        self._families.pop(name, None)

    # -- exposition -----------------------------------------------------------
    def render(self) -> str:
        """Prometheus text-exposition format (version 0.0.4), families
        sorted by name, children by label values — deterministic, so a
        golden test can pin the exact bytes."""
        out = []
        for name in sorted(self._families):
            fam = self._families[name]
            out.append(f"# HELP {name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.samples():
                ls = _labelstr(fam.labelnames, key)
                if fam.kind == "histogram":
                    counts, total, count = child.value()
                    ex = getattr(child, "_exemplars", {})
                    cum = 0
                    for bi, (edge, c) in enumerate(zip(fam.buckets, counts)):
                        cum += c
                        line = (
                            f"{name}_bucket"
                            f"{_labelstr(fam.labelnames, key, ('le', _fmt_le(edge)))}"
                            f" {cum}")
                        if bi in ex:
                            tid, val = ex[bi]
                            line += (f' # {{trace_id="{_escape_label(str(tid))}"}}'
                                     f" {_fmt(val)}")
                        out.append(line)
                    out.append(
                        f"{name}_bucket"
                        f"{_labelstr(fam.labelnames, key, ('le', '+Inf'))}"
                        f" {count}")
                    out.append(f"{name}_sum{ls} {_fmt(total)}")
                    out.append(f"{name}_count{ls} {count}")
                else:
                    out.append(f"{name}{ls} {_fmt(child.value())}")
        return "\n".join(out) + "\n"

    def sample(self) -> dict:
        """Flat ``{series: value}`` snapshot for JSONL time-series rows.
        Histograms contribute ``_count`` and ``_sum`` (bucket vectors stay
        out of the time series — the /metrics endpoint serves those)."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            for key, child in fam.samples():
                ls = _labelstr(fam.labelnames, key)
                if fam.kind == "histogram":
                    _counts, total, count = child.value()
                    out[f"{name}_count{ls}"] = count
                    out[f"{name}_sum{ls}"] = total
                else:
                    out[f"{name}{ls}"] = child.value()
        return out
