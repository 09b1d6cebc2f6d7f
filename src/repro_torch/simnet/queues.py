"""Bounded per-CN receive queues with a per-member service-rate model.

Each member is a single-server FIFO (the paper's CN NIC + reassembly daemon).
Service time of a segment on member *m* is

    s = per_packet_s[m] + bytes * per_byte_s[m]

and the queue state is the Lindley backlog ``W`` (seconds of unfinished
work). At an arrival at time *t*:

    W <- max(W - (t - t_last), 0)                # server drains in real time
    drop-tail:  W + s > capacity_s  -> dropped (accounted, never silent)
    accept:     depart = t + W + s;  W <- W + s

Rows are sorted by ``(member, arrival)`` once. Engines: ``np`` (the host
default: a dense ``[n_members, T]`` scan of T steps of [M]-wide arithmetic,
as in the JAX package) and ``torch`` (the sorted rows go to ``device`` and
the ``farm_serve`` kernel walks each member's rows there; on the CPU its
plain version runs). Both run in float64 and agree exactly; the JAX
package's ``jnp`` engine runs in float32 unless x64 is enabled.

Occupancy is *measured*, not synthetic: ``fill() = W / capacity_s`` is what
feeds ``TelemetryHub`` — the control plane reacts to the same queue state
that determines latency.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.farm_serve import farm_serve


@dataclasses.dataclass
class FarmConfig:
    """Per-member service model. Arrays are length ``n_members``."""

    n_members: int
    per_packet_s: np.ndarray   # fixed per-segment cost [M]
    per_byte_s: np.ndarray     # byte-proportional cost [M]
    capacity_s: np.ndarray     # drop-tail bound on backlog (work-seconds) [M]

    @classmethod
    def uniform(cls, n_members: int, per_packet_s: float = 2e-5,
                per_byte_s: float = 1.25e-7, capacity_s: float = 0.05,
                scale: np.ndarray | None = None) -> "FarmConfig":
        """Homogeneous farm; ``scale[m] > 1`` makes member m slower (its
        service times stretch — a straggler or a weak node)."""
        s = np.ones((n_members,)) if scale is None else np.asarray(scale, np.float64)
        return cls(
            n_members=n_members,
            per_packet_s=np.full((n_members,), per_packet_s) * s,
            per_byte_s=np.full((n_members,), per_byte_s) * s,
            capacity_s=np.full((n_members,), float(capacity_s)),
        )


@dataclasses.dataclass
class ServeResult:
    """Per-row outcomes plus per-member aggregates for one window."""

    depart: np.ndarray     # float64[N] service-completion time (inf if dropped)
    dropped: np.ndarray    # bool[N]
    busy_s: np.ndarray     # float64[M] work accepted this window
    accepted: np.ndarray   # int64[M]
    w_end: np.ndarray      # float64[M] backlog at each member's last arrival
    w_max: np.ndarray      # float64[M] peak backlog seen this window


def _serve_np(tm, sm, valid, w0, t0, cap_s):
    """The scan, numpy engine: T steps of [M]-wide arithmetic."""
    n_members, t_cols = tm.shape
    w, t_last, w_max = w0.copy(), t0.copy(), w0.copy()
    dep = np.full((n_members, t_cols), np.inf)
    drop = np.zeros((n_members, t_cols), bool)
    for j in range(t_cols):
        v = valid[:, j]
        # server time never rewinds: a next-window arrival that jitter pushed
        # before the previous window's last arrival queues at t_last instead
        # of manufacturing phantom backlog decay/growth
        t = np.where(v, np.maximum(tm[:, j], t_last), t_last)
        w = np.maximum(w - (t - t_last), 0.0)
        s = sm[:, j]
        d = v & (w + s > cap_s)
        acc = v & ~d
        dep[:, j] = np.where(acc, t + w + s, np.inf)
        w = np.where(acc, w + s, w)
        w_max = np.maximum(w_max, w)
        t_last = t
        drop[:, j] = d
    return dep, drop, w, t_last, w_max


class FarmQueues:
    """Stateful farm of bounded FIFO queues; backlog carries across windows.

    ``backend="torch"`` runs the scan on ``device`` (the ``farm_serve``
    kernel on a CUDA device).
    """

    def __init__(self, cfg: FarmConfig, backend: str = "np", device="cuda"):
        if backend not in ("np", "torch"):
            raise ValueError(f"unknown queue engine {backend!r}")
        self.cfg = cfg
        self.backend = backend
        self.device = resolve_device(device)
        m = cfg.n_members
        self.w = np.zeros((m,), np.float64)        # backlog at t_last
        self.t_last = np.zeros((m,), np.float64)
        self.n_dropped = 0
        self.n_served = 0

    def service_time(self, member: np.ndarray, nbytes: np.ndarray) -> np.ndarray:
        return (self.cfg.per_packet_s[member]
                + np.asarray(nbytes, np.float64) * self.cfg.per_byte_s[member])

    def fill(self, now: float | None = None) -> np.ndarray:
        """Measured queue-fill fraction per member (backlog / capacity),
        decayed to ``now`` if given — this is what telemetry reports."""
        w = self.w
        if now is not None:
            w = np.maximum(w - np.maximum(now - self.t_last, 0.0), 0.0)
        return w / self.cfg.capacity_s

    def _serve_sorted_torch(self, t_s, s_s, counts):
        """The sorted rows through ``farm_serve`` on ``self.device``."""
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        dev = self.device
        as_t = lambda a, dt=torch.float64: torch.from_numpy(
            np.ascontiguousarray(a)).to(device=dev, dtype=dt)
        out = farm_serve(as_t(t_s), as_t(s_s), as_t(offsets, torch.int32), as_t(self.w),
                         as_t(self.t_last), as_t(self.cfg.capacity_s))
        return [x.cpu().numpy() for x in out]

    def serve(self, member: np.ndarray, t_arrive: np.ndarray,
              nbytes: np.ndarray) -> ServeResult:
        """Run one window through every member's queue."""
        m_count = self.cfg.n_members
        n = len(member)
        if n == 0:
            z = np.zeros((m_count,))
            return ServeResult(np.empty((0,)), np.zeros((0,), bool), z,
                               z.astype(np.int64), self.w.copy(), self.w.copy())
        svc = self.service_time(member, nbytes)
        order = np.lexsort((t_arrive, member))
        m_s, t_s, s_s = member[order], t_arrive[order], svc[order]
        counts = np.bincount(m_s, minlength=m_count)

        dep = np.empty((n,), np.float64)
        drop = np.empty((n,), bool)
        if self.backend == "torch":
            dep_s, drop_s, w, t_last, w_max = self._serve_sorted_torch(t_s, s_s, counts)
            dep[order], drop[order] = dep_s, drop_s
        else:
            t_cols = int(counts.max())
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            col = np.arange(n) - starts[m_s]
            tm = np.zeros((m_count, t_cols))
            sm = np.zeros((m_count, t_cols))
            valid = np.zeros((m_count, t_cols), bool)
            tm[m_s, col] = t_s
            sm[m_s, col] = s_s
            valid[m_s, col] = True
            dep_m, drop_m, w, t_last, w_max = _serve_np(
                tm, sm, valid, self.w, self.t_last, self.cfg.capacity_s)
            dep[order] = dep_m[m_s, col]
            drop[order] = drop_m[m_s, col]
        self.w, self.t_last = np.asarray(w).copy(), np.asarray(t_last).copy()

        acc_rows = ~drop
        busy = np.bincount(member[acc_rows], weights=svc[acc_rows],
                           minlength=m_count)
        accepted = np.bincount(member[acc_rows], minlength=m_count)
        self.n_dropped += int(drop.sum())
        self.n_served += int(acc_rows.sum())
        return ServeResult(dep, drop, busy, accepted.astype(np.int64),
                           self.w.copy(), np.asarray(w_max).copy())
