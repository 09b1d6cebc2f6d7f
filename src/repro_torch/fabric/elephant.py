"""Elephant-flow detection: per-stream EWMA byte rate with hysteresis.

RDNA Balance (PAPERS.md) isolates heavy flows by *strict source routing*
them onto paths mice never share. The detector here is its control half:
each DAQ stream's byte rate is tracked as an exponentially weighted moving
average, and a stream is promoted to *elephant* when the EWMA crosses
``hi_Bps`` — then stays one until it falls below ``lo_Bps``. The two
thresholds are the hysteresis band: a stream hovering between them keeps
its current class, so the classifier cannot flap packet classes (and with
them, calendar lanes) at the boundary. Promotion/demotion happens at
window boundaries only — mid-window every bundle of a stream shares one
class, which is what keeps the lane assignment per-bundle-atomic.

The port of the JAX package's ``repro/fabric/elephant.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ElephantConfig:
    """Hysteresis thresholds + smoothing for the per-stream rate EWMA."""

    hi_Bps: float = 30e6      # promote to elephant above this EWMA rate
    lo_Bps: float = 15e6      # demote below this (hysteresis band between)
    alpha: float = 0.3        # EWMA weight of the newest window

    def __post_init__(self) -> None:
        if not (self.hi_Bps > self.lo_Bps > 0.0):
            raise ValueError(
                f"need hi_Bps > lo_Bps > 0, got hi={self.hi_Bps!r} "
                f"lo={self.lo_Bps!r}")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha!r}")


class ElephantDetector:
    """Stateful per-stream classifier; one vectorized update per window."""

    def __init__(self, n_streams: int, cfg: ElephantConfig | None = None):
        self.cfg = cfg or ElephantConfig()
        self.n_streams = int(n_streams)
        self.ewma_Bps = np.zeros(self.n_streams, np.float64)
        self.elephant = np.zeros(self.n_streams, bool)
        self.ever_elephant = np.zeros(self.n_streams, bool)
        self.transitions = 0      # total class flips (flap telemetry)
        self.n_windows = 0

    def update(self, window_bytes: np.ndarray, window_s: float) -> np.ndarray:
        """Fold one window's per-stream byte counts into the EWMA and
        return the updated elephant mask (a copy; safe to keep)."""
        rate = np.asarray(window_bytes, np.float64) / max(window_s, 1e-12)
        if rate.shape != (self.n_streams,):
            raise ValueError(
                f"expected [{self.n_streams}] byte counts, got {rate.shape}")
        a = self.cfg.alpha
        self.ewma_Bps = a * rate + (1.0 - a) * self.ewma_Bps
        promote = ~self.elephant & (self.ewma_Bps > self.cfg.hi_Bps)
        demote = self.elephant & (self.ewma_Bps < self.cfg.lo_Bps)
        self.transitions += int(promote.sum()) + int(demote.sum())
        self.elephant = (self.elephant | promote) & ~demote
        self.ever_elephant |= self.elephant
        self.n_windows += 1
        return self.elephant.copy()
