"""P4-faithful LPM (longest-prefix-match) machinery over the Event Number space.

The paper (§II-A, §III-C) programs Calendar *Epoch* boundaries as ranges over
the 64-bit Event Number, expressed — because P4 has no range matches — as a
set of prefix matches: "Compute a set of LPM prefix matches over the Event ID
space which describe the entire range of Event IDs from the start of the
current Epoch up to the start of the new Epoch."

This module implements that decomposition exactly (host side, python ints),
plus an LPM table with longest-prefix semantics. The device data plane uses an
equivalent sorted-boundary representation (core/tables.py); equivalence between
the two is property-tested in tests/test_lpm.py.
"""
from __future__ import annotations

import dataclasses

EVENT_BITS = 64
EVENT_SPACE = 1 << EVENT_BITS


@dataclasses.dataclass(frozen=True)
class Prefix:
    """A prefix match: matches keys whose top ``length`` bits equal value's."""

    value: int  # left-aligned: low (64 - length) bits are zero
    length: int  # 0..64; 0 is the wildcard

    def __post_init__(self):
        if not 0 <= self.length <= EVENT_BITS:
            raise ValueError(f"bad prefix length {self.length}")
        mask = self.mask
        if self.value & ~mask & (EVENT_SPACE - 1):
            raise ValueError("prefix value has bits below the prefix length")

    @property
    def mask(self) -> int:
        if self.length == 0:
            return 0
        return ((1 << self.length) - 1) << (EVENT_BITS - self.length)

    @property
    def lo(self) -> int:
        return self.value

    @property
    def hi(self) -> int:  # exclusive
        return self.value + (1 << (EVENT_BITS - self.length))

    def matches(self, key: int) -> bool:
        return (key & self.mask) == self.value


def range_to_prefixes(lo: int, hi: int) -> list[Prefix]:
    """Minimal prefix cover of the half-open range [lo, hi).

    Classic greedy: at each step emit the largest aligned power-of-two block
    starting at ``lo`` that fits inside the remaining range.
    """
    if not 0 <= lo <= hi <= EVENT_SPACE:
        raise ValueError(f"bad range [{lo}, {hi})")
    out: list[Prefix] = []
    while lo < hi:
        # Largest block size allowed by alignment of lo (lowest set bit).
        align = lo & -lo if lo else EVENT_SPACE
        size = align
        # Shrink to fit the remaining span.
        while size > hi - lo:
            size >>= 1
        length = EVENT_BITS - size.bit_length() + 1
        out.append(Prefix(value=lo, length=length))
        lo += size
    return out


@dataclasses.dataclass
class LPMTable:
    """Longest-prefix-match table: (prefix -> data), longest length wins.

    Mirrors the P4 'Calendar Epoch Assignment' table: keys are Event Numbers,
    data is the Calendar Epoch id. A wildcard (length-0) entry plays the role
    of the paper's wildcard match that is flipped to activate a new epoch.
    """

    entries: dict[Prefix, object] = dataclasses.field(default_factory=dict)

    def insert(self, prefix: Prefix, data) -> None:
        self.entries[prefix] = data

    def insert_range(self, lo: int, hi: int, data) -> list[Prefix]:
        ps = range_to_prefixes(lo, hi)
        for p in ps:
            self.insert(p, data)
        return ps

    def set_wildcard(self, data) -> None:
        self.insert(Prefix(0, 0), data)

    def delete(self, prefix: Prefix) -> None:
        del self.entries[prefix]

    def delete_many(self, prefixes) -> None:
        for p in prefixes:
            self.delete(p)

    def lookup(self, key: int):
        """Longest-prefix match; returns the entry data or None."""
        best = None
        best_len = -1
        for p, data in self.entries.items():
            if p.length > best_len and p.matches(key):
                best, best_len = data, p.length
        return best

    def boundaries(self) -> list[tuple[int, object]]:
        """Compile to a sorted list of (start_event, data) half-open segments.

        This is the equivalent dense representation the TPU data plane uses:
        segment i covers [start_i, start_{i+1}). Longest-prefix semantics are
        resolved here, once, at programming time.
        """
        # Collect all range edges.
        edges = {0, EVENT_SPACE}
        for p in self.entries:
            edges.add(p.lo)
            edges.add(p.hi)
        starts = sorted(edges)
        segs: list[tuple[int, object]] = []
        for s in starts[:-1]:
            segs.append((s, self.lookup(s)))
        # Merge adjacent segments with identical data.
        merged: list[tuple[int, object]] = []
        for s, d in segs:
            if merged and merged[-1][1] == d:
                continue
            merged.append((s, d))
        return merged
