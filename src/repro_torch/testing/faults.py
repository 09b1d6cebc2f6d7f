"""Deterministic fault-injection harness for the control plane.

Robustness claims are only as good as the failures they were tested
against, and ad-hoc monkeypatching produces failures nobody can replay.
This module is the one place faults come from:

* **Crash points** — named locations threaded through the journal
  (``journal.append.write`` ...), the HA replication pipeline
  (``ha.leader.before_ship`` ...) and anything else that opts in call
  ``FaultInjector.crashpoint(name)``; the injector raises
  ``InjectedCrash`` on exactly the scheduled hits.  A crash-point sweep
  (tests/test_faults.py) kills the journal at *every* write/rename step
  and proves recovery from what is left on disk.
* **Torn writes** — ``torn_bytes`` truncates a payload at a
  deterministic fraction, modeling a process killed mid-``write(2)``.
* **Frame faults** — ``FaultyTransport`` wraps any controld transport
  and drops, duplicates or delays request/reply frames per a seeded
  schedule.  With client request-ids (idempotent resend) a dropped
  reply or a duplicated request must be invisible to daemon state.
* **Frozen clocks** — ``FrozenClock`` is a manually-advanced clock for
  lease/heartbeat timing tests.

Everything is driven by one seeded ``random.Random`` plus explicit hit
schedules, and every decision is appended to ``injector.log`` — same
seed, same call sequence => same failure schedule, byte for byte
(asserted by tests/test_faults.py), which is what lets the chaos
scenarios gate on digest equality.
"""
from __future__ import annotations

import random
from typing import Iterable, Optional


class InjectedCrash(RuntimeError):
    """A scheduled crash fired. Deliberately *not* a SessionError or
    TransportError subclass: production code must never swallow it."""


class FrozenClock:
    """A clock that only moves when told to — lease semantics in tests."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def __call__(self) -> float:  # usable directly as ``clock=...``
        return self._t


class FaultInjector:
    """One seeded source of scheduled failures.

    ``crash_at`` maps crash-point name -> which hit (1-based) should
    crash; ``torn_at`` maps a crash-point name -> fraction of the
    payload to keep (the rest is torn off).  Frame fault rates are
    probabilities evaluated on the seeded RNG in call order.  Every
    decision lands in ``log`` as ``(point, hit_index, action)`` so a
    schedule can be compared across runs.
    """

    def __init__(self, seed: int = 0,
                 crash_at: Optional[dict] = None,
                 torn_at: Optional[dict] = None,
                 drop_request: float = 0.0,
                 drop_reply: float = 0.0,
                 dup_request: float = 0.0,
                 delay_s: float = 0.0,
                 delay_rate: float = 0.0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.crash_at = dict(crash_at or {})
        self.torn_at = dict(torn_at or {})
        self.drop_request = float(drop_request)
        self.drop_reply = float(drop_reply)
        self.dup_request = float(dup_request)
        self.delay_s = float(delay_s)
        self.delay_rate = float(delay_rate)
        self.hits: dict[str, int] = {}
        self.log: list[tuple] = []

    # -- crash points ---------------------------------------------------------
    def crashpoint(self, name: str) -> None:
        """Count a hit on ``name``; raise ``InjectedCrash`` iff this hit
        is the scheduled one (``crash_at[name]``, 1-based)."""
        n = self.hits.get(name, 0) + 1
        self.hits[name] = n
        if self.crash_at.get(name) == n:
            self.log.append((name, n, "crash"))
            raise InjectedCrash(f"injected crash at {name} (hit {n})")
        self.log.append((name, n, "pass"))

    def torn_bytes(self, name: str, data: bytes) -> Optional[bytes]:
        """If ``name`` is scheduled for a torn write, return the prefix
        that 'made it to disk' (deterministic fraction); else None."""
        frac = self.torn_at.get(name)
        if frac is None:
            return None
        keep = max(0, min(len(data), int(len(data) * float(frac))))
        self.log.append((name, self.hits.get(name, 0), f"torn:{keep}"))
        return data[:keep]

    # -- frame fates ----------------------------------------------------------
    def frame_fate(self, point: str = "frame") -> str:
        """One deterministic fate draw for an outgoing request frame:
        ``deliver`` | ``drop_request`` | ``drop_reply`` | ``dup_request``
        (plus an independent ``delay`` draw via :meth:`frame_delay`)."""
        n = self.hits.get(point, 0) + 1
        self.hits[point] = n
        r = self.rng.random()
        edge = self.drop_request
        if r < edge:
            fate = "drop_request"
        elif r < (edge := edge + self.drop_reply):
            fate = "drop_reply"
        elif r < edge + self.dup_request:
            fate = "dup_request"
        else:
            fate = "deliver"
        self.log.append((point, n, fate))
        return fate

    def frame_delay(self) -> float:
        """Deterministic per-frame delay in seconds (0.0 = none)."""
        if self.delay_rate <= 0.0 or self.delay_s <= 0.0:
            return 0.0
        return self.delay_s if self.rng.random() < self.delay_rate else 0.0

    def schedule(self) -> tuple:
        """The full decision log as a hashable value (determinism gate:
        same seed + same call sequence => identical schedule)."""
        return tuple(self.log)


class FaultyTransport:
    """Wrap any controld transport (``call``/``call_many``/``close``)
    with seeded frame faults.

    * ``drop_request`` — the request never reaches the daemon; the
      caller sees a ``TransportError`` (as if the connection died).
    * ``drop_reply``   — the daemon handled the request but the reply
      is lost; the caller sees a ``TransportError``.  Only an
      idempotent resend (client request-ids) makes this safe.
    * ``dup_request``  — the request is delivered twice (a retransmit
      racing the original); the duplicate's reply is discarded.
    * delays           — ``sleep(delay)`` before delivery; pass the
      virtual clock's ``advance`` to model delay in simulated time.
    """

    def __init__(self, inner, injector: FaultInjector, sleep=None):
        # late import keeps repro_torch.testing importable without controld
        from repro_torch.controld.transport import TransportError
        self._TransportError = TransportError
        self.inner = inner
        self.injector = injector
        self.sleep = sleep

    def call(self, msg):
        inj = self.injector
        fate = inj.frame_fate()
        delay = inj.frame_delay()
        if delay and self.sleep is not None:
            self.sleep(delay)
        if fate == "drop_request":
            raise self._TransportError("injected fault: request dropped")
        if fate == "dup_request":
            self.inner.call(msg)  # the duplicate delivery
            return self.inner.call(msg)
        reply = self.inner.call(msg)
        if fate == "drop_reply":
            raise self._TransportError("injected fault: reply dropped")
        return reply

    def call_many(self, msgs) -> list:
        return [self.call(m) for m in msgs]

    def close(self) -> None:
        self.inner.close()


def crash_sweep(points: Iterable[str], run, check) -> list[str]:
    """Drive ``run(injector)`` once per crash point with a crash
    scheduled at that point's first hit, then call ``check(point)`` to
    assert recovery.  ``run`` must raise ``InjectedCrash`` through (the
    sweep asserts the point actually fired).  Returns the points that
    fired — a point that never fired is a sweep bug (stale name) and
    raises ``AssertionError``."""
    fired = []
    for point in points:
        inj = FaultInjector(seed=0, crash_at={point: 1})
        try:
            run(inj)
        except InjectedCrash:
            fired.append(point)
        else:
            raise AssertionError(
                f"crash point {point!r} never fired — stale sweep entry?")
        check(point)
    return fired
