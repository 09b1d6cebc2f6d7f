"""Per-bundle distributed tracing: a vectorized flight recorder.

Every stage the plant already computes as arrays — DAQ emission wait,
uplink serialization, WAN prop+jitter, the LB's fixed-latency hop, the
fabric inter-LB hop, downlink FIFO wait, Lindley farm-queue wait, service
time, reassembly completion — lands here as struct-of-arrays span buffers:
one ``record_window(stage, bundle_ids, t_start, t_end)`` call per stage per
window, never per-packet Python. Engines differ only in *when* they call
it: the host simulator records inline as each window's arrays materialize;
the fused engine returns the masked stage-time arrays from the donated
device program and materializes the identical span set post-hoc
(tests/test_trace.py asserts set equality on ``baseline``/``straggler``).

Sampling policy (both engines, bit-identical):

* **Head sampling** — deterministic ``mix64`` over the *event number*
  (``fabric.spray``'s splitmix64 finalizer), salted with the trace seed and
  compared against ``head_rate * 2^64``. A bundle's fate is a pure function
  of (event, seed): no RNG state, no ordering dependence, identical across
  engines and runs.
* **Tail-biased sampling** — a top-k reservoir over completed-bundle E2E
  latency always retains the K slowest bundles of the run (ties broken by
  bundle key, so retention is insertion-order independent). The p99.9
  waterfall is therefore always available even at ``head_rate=0``.

Span identity: ``key`` packs the bundle id ``(event << 16) | daq``; ``pid``
identifies one physical packet copy (a monotone delivered-row counter both
engines derive identically), with bundle-level spans (emission wait,
reassembly) using ``BUNDLE_PID + key``. ``aux`` carries a stage-specific
attribute (fabric: the stacked-calendar ``instance_id = lb*2 + class``;
farm stages: the member id).

Export is Chrome trace-event JSON (``to_perfetto()``; open the file in
ui.perfetto.dev) with one "process" per bundle and one "thread" per packet
copy; ``to_perfetto_json()`` is canonical bytes, golden-tested. Completion
latencies are recorded for *every* bundle (retention only filters spans),
so percentile selection in ``traceview`` is exact, not sample-biased.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# splitmix64 finalizer (the same hash fabric.spray uses), defined locally:
# telemetry sits below both simnet and fabric in the import graph, so it
# must not import from either (fabric.sim imports this module).
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping arithmetic)."""
    z = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        z = z + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


#: core pipeline stages, in pipeline order. Index = stage id. Extra stages
#: (e.g. per-message controld spans) are registered on first use.
STAGES: Tuple[str, ...] = (
    "emit_wait", "uplink", "wan", "lb", "fabric", "downlink",
    "farm_wait", "service", "reassembly",
)

#: pid namespace for bundle-level spans (emission wait, reassembly): the
#: packet-copy counter never reaches 2^63, so ``BUNDLE_PID + key`` cannot
#: collide with a row pid.
BUNDLE_PID = np.uint64(1) << np.uint64(63)

_SEED_SALT = np.uint64(0xA24BAED4963EE407)


def trace_id(key: int) -> str:
    """The wire/display form of a bundle key — 16 hex digits."""
    return f"{int(key):016x}"


def parse_trace_id(s: str) -> int:
    return int(s, 16)


def bundle_key(event_number, daq_id) -> np.ndarray:
    """Pack (event, daq) into the u64 bundle key, vectorized."""
    ev = np.asarray(event_number, np.uint64)
    dq = np.asarray(daq_id, np.uint64)
    return (ev << np.uint64(16)) | dq


@dataclasses.dataclass
class TraceConfig:
    """Sampling knobs. ``head_rate=1.0`` keeps every bundle's spans."""

    head_rate: float = 1.0
    tail_k: int = 64
    seed: int = 0
    compact_every: int = 256   # windows between span-buffer compactions


class TraceBuffer:
    """SoA span buffers + completion table + sampling/retention."""

    def __init__(self, cfg: Optional[TraceConfig] = None):
        self.cfg = cfg or TraceConfig()
        self.stage_names: List[str] = list(STAGES)
        self._stage_ids: Dict[str, int] = {s: i for i, s in enumerate(STAGES)}
        # span chunks: parallel lists of (stage u16, key u64, pid u64,
        # t0 f64, t1 f64, aux i64) arrays — appended per record_window call
        self._chunks: List[Tuple[np.ndarray, ...]] = []
        # completion chunks: (key u64, t_emit f64, t_done f64)
        self._done: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.windows = 0
        self.n_recorded = 0          # spans ever recorded (pre-compaction)
        self._salt = mix64(np.uint64(self.cfg.seed) ^ _SEED_SALT)
        rate = min(max(float(self.cfg.head_rate), 0.0), 1.0)
        # head threshold in u64 hash space; rate=1.0 keeps everything
        self._thresh = (np.uint64(0xFFFFFFFFFFFFFFFF) if rate >= 1.0
                        else np.uint64(int(rate * float(2**64))))
        self._keep_all = rate >= 1.0
        #: set by ``from_summary``: the retained keys are those with spans
        self._summary_keys: Optional[np.ndarray] = None

    # -- sampling ----------------------------------------------------------
    def stage_id(self, name: str) -> int:
        sid = self._stage_ids.get(name)
        if sid is None:
            sid = len(self.stage_names)
            self.stage_names.append(name)
            self._stage_ids[name] = sid
        return sid

    def head_sampled(self, keys: np.ndarray) -> np.ndarray:
        """Deterministic head-sampling mask: mix64 over the event number."""
        if self._keep_all:
            return np.ones(np.shape(keys), bool)
        ev = np.asarray(keys, np.uint64) >> np.uint64(16)
        with np.errstate(over="ignore"):
            h = mix64(ev ^ self._salt)
        return h <= self._thresh

    # -- recording (one call per stage per window) -------------------------
    def record_window(self, stage, keys, t_start, t_end,
                      pid=None, aux=None) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        n = len(keys)
        if n == 0:
            return
        sid = stage if isinstance(stage, int) else self.stage_id(stage)
        t0 = np.broadcast_to(np.asarray(t_start, np.float64), (n,))
        t1 = np.broadcast_to(np.asarray(t_end, np.float64), (n,))
        if pid is None:
            p = (keys + BUNDLE_PID).astype(np.uint64)
        else:
            p = np.broadcast_to(np.asarray(pid, np.uint64), (n,))
        a = (np.full((n,), -1, np.int64) if aux is None
             else np.broadcast_to(np.asarray(aux, np.int64), (n,)))
        self._chunks.append((np.full((n,), sid, np.uint16), keys.copy(),
                             p.copy(), t0.copy(), t1.copy(), a.copy()))
        self.n_recorded += n

    def complete_window(self, keys, t_emit, t_done) -> None:
        """Register completed bundles (every one, retained or not)."""
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        if len(keys) == 0:
            return
        self._done.append((keys.copy(),
                           np.asarray(t_emit, np.float64).copy(),
                           np.asarray(t_done, np.float64).copy()))

    def end_window(self) -> None:
        self.windows += 1
        ce = self.cfg.compact_every
        if ce and self.windows % ce == 0:
            self._compact()

    # -- retention ---------------------------------------------------------
    def completions(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(key, t_emit, t_done) over every completed bundle, append order."""
        if not self._done:
            z = np.zeros((0,), np.uint64)
            return z, np.zeros((0,)), np.zeros((0,))
        ks = np.concatenate([c[0] for c in self._done])
        te = np.concatenate([c[1] for c in self._done])
        td = np.concatenate([c[2] for c in self._done])
        return ks, te, td

    def tail_keys(self) -> np.ndarray:
        """The K slowest completed bundles — deterministic under ties
        (sorted by (e2e, key) descending), independent of append order."""
        ks, te, td = self.completions()
        if len(ks) == 0 or self.cfg.tail_k <= 0:
            return np.zeros((0,), np.uint64)
        e2e = td - te
        order = np.lexsort((ks, e2e))[::-1]     # e2e desc, key desc on ties
        return ks[order[:self.cfg.tail_k]]

    def retained_keys(self) -> np.ndarray:
        """head-sampled ∪ tail top-k, over every key ever seen (for a
        buffer read from a summary: the keys whose spans it holds)."""
        if self._summary_keys is not None:
            return self._summary_keys
        seen = [c[1] for c in self._chunks]
        if self._done:
            seen.append(np.concatenate([c[0] for c in self._done]))
        if not seen:
            return np.zeros((0,), np.uint64)
        keys = np.unique(np.concatenate(seen))
        keep = self.head_sampled(keys)
        tail = self.tail_keys()
        if len(tail):
            keep |= np.isin(keys, tail)
        return keys[keep]

    def _compact(self) -> None:
        """Drop spans of completed-and-unretained bundles. Safe: the head
        set is fixed, an evicted reservoir bundle never re-enters, and
        incomplete bundles are kept until they complete or the run ends."""
        if not self._chunks:
            return
        done_k, te, td = self.completions()
        if len(done_k) == 0:
            return
        e2e = td - te
        order = np.lexsort((done_k, e2e))[::-1]
        tail = done_k[order[:self.cfg.tail_k]] if self.cfg.tail_k > 0 \
            else np.zeros((0,), np.uint64)
        st, ky, pi, t0, t1, ax = [np.concatenate([c[i] for c in self._chunks])
                                  for i in range(6)]
        drop = np.isin(ky, done_k) & ~self.head_sampled(ky)
        if len(tail):
            drop &= ~np.isin(ky, tail)
        keep = ~drop
        self._chunks = [(st[keep], ky[keep], pi[keep], t0[keep], t1[keep],
                         ax[keep])]

    # -- materialized output ----------------------------------------------
    def spans(self) -> Dict[str, np.ndarray]:
        """Retained spans in canonical order (key, pid, t0, stage) — the
        parity-comparable form: engines may record in different orders but
        land on the same sorted set."""
        if not self._chunks:
            z = np.zeros((0,), np.uint64)
            return dict(stage=np.zeros((0,), np.uint16), key=z, pid=z,
                        t0=np.zeros((0,)), t1=np.zeros((0,)),
                        aux=np.zeros((0,), np.int64))
        st, ky, pi, t0, t1, ax = [np.concatenate([c[i] for c in self._chunks])
                                  for i in range(6)]
        keep = np.isin(ky, self.retained_keys())
        st, ky, pi, t0, t1, ax = (st[keep], ky[keep], pi[keep], t0[keep],
                                  t1[keep], ax[keep])
        order = np.lexsort((st, t0, pi, ky))
        return dict(stage=st[order], key=ky[order], pid=pi[order],
                    t0=t0[order], t1=t1[order], aux=ax[order])

    def retained_completions(self) -> Tuple[np.ndarray, np.ndarray]:
        """(key, e2e) of retained completed bundles, sorted by key."""
        ks, te, td = self.completions()
        if len(ks) == 0:
            return ks, np.zeros((0,))
        keep = np.isin(ks, self.retained_keys())
        ks, e2e = ks[keep], (td - te)[keep]
        order = np.argsort(ks, kind="stable")
        return ks[order], e2e[order]

    # -- exemplars: LATENCY_BUCKETS_S bucket -> a sampled trace id ---------
    def exemplars(self, buckets) -> Dict[int, Tuple[str, float]]:
        """Per histogram bucket (index into ``buckets``), the retained
        completed bundle with the largest E2E falling in that bucket —
        ``{bucket_idx: (trace_id, e2e_seconds)}``. Deterministic (max e2e,
        ties by key)."""
        ks, e2e = self.retained_completions()
        out: Dict[int, Tuple[str, float]] = {}
        if len(ks) == 0:
            return out
        b = np.searchsorted(np.asarray(buckets, np.float64), e2e,
                            side="left")
        order = np.lexsort((ks, e2e))       # ascending: last-in wins = max
        for i in order:
            out[int(b[i])] = (trace_id(ks[i]), float(e2e[i]))
        return out

    # -- Chrome trace-event / Perfetto export ------------------------------
    def to_perfetto(self) -> dict:
        """Chrome trace-event JSON (dict form): one complete-event ("X")
        per span, pid = bundle key, tid = packet copy (0 for bundle-level
        spans), timestamps in microseconds of virtual time."""
        sp = self.spans()
        events = []
        for i in range(len(sp["key"])):
            key = int(sp["key"][i])
            pid_raw = int(sp["pid"][i])
            tid = 0 if pid_raw >= int(BUNDLE_PID) else pid_raw + 1
            ev = dict(
                name=self.stage_names[int(sp["stage"][i])],
                cat="bundle", ph="X",
                ts=round(float(sp["t0"][i]) * 1e6, 3),
                dur=round(float(sp["t1"][i] - sp["t0"][i]) * 1e6, 3),
                pid=key, tid=tid,
                args=dict(trace_id=trace_id(key),
                          event=key >> 16, daq=key & 0xFFFF),
            )
            if int(sp["aux"][i]) >= 0:
                ev["args"]["aux"] = int(sp["aux"][i])
            events.append(ev)
        return dict(displayTimeUnit="ns", traceEvents=events)

    def to_perfetto_json(self) -> bytes:
        """Canonical bytes of ``to_perfetto()`` — golden-tested: keys
        sorted, compact separators, deterministic span order."""
        return json.dumps(self.to_perfetto(), sort_keys=True,
                          separators=(",", ":")).encode()

    # -- persistence for analyze_trace -------------------------------------
    def to_summary(self) -> dict:
        """Raw retained spans + all completions, JSON-serializable — the
        lossless form the JAX package's ``scripts/analyze_trace.py`` consumes."""
        sp = self.spans()
        ks, te, td = self.completions()
        return dict(
            stage_names=self.stage_names,
            windows=self.windows,
            n_recorded=self.n_recorded,
            spans=dict(stage=sp["stage"].tolist(),
                       key=[int(k) for k in sp["key"]],
                       pid=[int(p) for p in sp["pid"]],
                       t0=sp["t0"].tolist(), t1=sp["t1"].tolist(),
                       aux=sp["aux"].tolist()),
            completions=dict(key=[int(k) for k in ks],
                             t_emit=te.tolist(), t_done=td.tolist()),
        )

    @classmethod
    def from_summary(cls, d: dict) -> "TraceBuffer":
        """A summary back as a buffer. The summary holds the spans of the
        retained bundles and every completion, so the retained bundles are
        those whose spans it holds: a head-sampled trace reloads to the
        live tables (the JAX package's reader counts every completion as
        retained, and finds no spans for an unsampled percentile bundle)."""
        tb = cls(TraceConfig(head_rate=1.0, tail_k=0, compact_every=0))
        tb.stage_names = list(d["stage_names"])
        tb._stage_ids = {s: i for i, s in enumerate(tb.stage_names)}
        tb.windows = int(d.get("windows", 0))
        tb.n_recorded = int(d.get("n_recorded", 0))
        sp = d["spans"]
        if sp["key"]:
            tb._chunks.append((
                np.asarray(sp["stage"], np.uint16),
                np.asarray(sp["key"], np.uint64),
                np.asarray(sp["pid"], np.uint64),
                np.asarray(sp["t0"], np.float64),
                np.asarray(sp["t1"], np.float64),
                np.asarray(sp["aux"], np.int64)))
        tb._summary_keys = np.unique(np.asarray(sp["key"], np.uint64))
        c = d["completions"]
        if c["key"]:
            tb._done.append((np.asarray(c["key"], np.uint64),
                             np.asarray(c["t_emit"], np.float64),
                             np.asarray(c["t_done"], np.float64)))
        return tb
