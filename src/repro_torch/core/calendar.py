"""Weighted 512-slot Load Balance Calendar construction (paper §III-B.3).

"All (or any subset of) the Member IDs ... should be distributed into the 512
Calendar Slots available in the Calendar. Any members can occur between 0-512
times in the calendar. A member occurring more times in the calendar has a
higher 'weight' ... NOTE: All 512 slots MUST have a member assigned to them or
events that target the empty slot will be entirely discarded."

Because the slot index is ``event_number & 0x1FF`` and event numbers are
(required to be) uniform in their 9 LSBs, the traffic share of a member equals
its slot count / 512. We build calendars with:

  * exact largest-remainder quotas (counts sum to 512, proportional to weight
    within ±1 slot), and
  * smooth interleaved placement (deficit round-robin) so a member's slots are
    spread across the slot space rather than clustered — this keeps short
    event-number windows balanced too, not just the long-run average.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.protocol import CALENDAR_SLOTS


def quotas_from_weights(weights: np.ndarray, n_slots: int = CALENDAR_SLOTS) -> np.ndarray:
    """Largest-remainder apportionment of ``n_slots`` by weight.

    Members with weight 0 get 0 slots. Every member with positive weight gets
    at least one slot when feasible (n_positive <= n_slots).
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError("weights must be a non-empty 1-D array")
    if (w < 0).any():
        raise ValueError("weights must be non-negative")
    total = w.sum()
    if total <= 0:
        raise ValueError("at least one member must have positive weight")
    ideal = w / total * n_slots
    counts = np.floor(ideal).astype(np.int64)
    # Guarantee >=1 slot for active members (paper: a member absent from the
    # calendar simply receives no traffic; we keep active members reachable).
    active = w > 0
    if active.sum() > n_slots:
        raise ValueError(f"more active members ({int(active.sum())}) than slots ({n_slots})")
    counts[active & (counts == 0)] = 1
    # Largest-remainder fixup to land exactly on n_slots.
    rem = ideal - np.floor(ideal)
    while counts.sum() > n_slots:
        # Remove from the largest over-represented count (never below 1 for active).
        over = np.where(counts > 1, counts - ideal, -np.inf)
        counts[int(np.argmax(over))] -= 1
    order = np.argsort(-rem)
    i = 0
    while counts.sum() < n_slots:
        m = int(order[i % len(order)])
        if active[m]:
            counts[m] += 1
        i += 1
    assert counts.sum() == n_slots
    return counts


def build_calendar(
    member_ids: np.ndarray,
    weights: np.ndarray,
    n_slots: int = CALENDAR_SLOTS,
) -> np.ndarray:
    """Build an int32[n_slots] calendar: slot -> member id.

    Placement uses smooth weighted round-robin (deficit counters), producing a
    maximally interleaved pattern: e.g. weights [2, 1] over 6 slots give
    A B A A B A — not A A A A B B.
    """
    member_ids = np.asarray(member_ids, dtype=np.int32)
    counts = quotas_from_weights(weights, n_slots)
    credit = np.zeros(len(member_ids), dtype=np.float64)
    remaining = counts.astype(np.float64).copy()
    out = np.empty(n_slots, dtype=np.int32)
    for s in range(n_slots):
        credit += remaining
        pick = int(np.argmax(credit))
        out[s] = member_ids[pick]
        credit[pick] -= n_slots  # one full cycle of credit
        remaining[pick] = max(remaining[pick] - 0.0, 0.0)
    # The credit scheme above keeps proportions but can drift off exact
    # quotas; enforce exact counts with a corrective pass.
    out = _enforce_quotas(out, member_ids, counts)
    return out


def _enforce_quotas(cal: np.ndarray, member_ids: np.ndarray, counts: np.ndarray) -> np.ndarray:
    cal = cal.copy()
    want = {int(m): int(c) for m, c in zip(member_ids, counts)}
    have: dict[int, int] = {int(m): 0 for m in member_ids}
    for v in cal:
        have[int(v)] = have.get(int(v), 0) + 1
    surplus = [m for m in have if have[m] > want.get(m, 0)]
    deficit = [m for m in want if have.get(m, 0) < want[m]]
    if not surplus and not deficit:
        return cal
    # Replace surplus occurrences (evenly spaced) with deficit members.
    di = 0
    need = {m: want[m] - have.get(m, 0) for m in deficit}
    for i in range(len(cal)):
        m = int(cal[i])
        if have[m] > want.get(m, 0) and di < len(deficit):
            d = deficit[di]
            cal[i] = d
            have[m] -= 1
            need[d] -= 1
            have[d] = have.get(d, 0) + 1
            if need[d] == 0:
                di += 1
    return cal


def calendar_counts(cal: np.ndarray, n_members: int) -> np.ndarray:
    return np.bincount(np.asarray(cal, dtype=np.int64), minlength=n_members)


def max_run_length(cal: np.ndarray, member: int) -> int:
    """Longest run of consecutive slots owned by ``member`` (dispersion metric)."""
    best = cur = 0
    for v in np.asarray(cal):
        cur = cur + 1 if int(v) == member else 0
        best = max(best, cur)
    return best
