"""Virtual time: a monotonic clock the simulator advances explicitly.

``now`` is a plain callable so it can be injected anywhere wall time is
consumed today (``TelemetryHub(clock=clock.now)``) — the hub, the control
plane and the scenario hooks all observe the *same* simulated instant.
"""
from __future__ import annotations


class VirtualClock:
    """Monotonic simulated time in seconds."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual time cannot go backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        """Advance to an absolute instant (no-op if already past it —
        pipeline stages may finish 'early' relative to the window edge)."""
        self._t = max(self._t, float(t))
        return self._t
