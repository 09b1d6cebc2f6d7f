"""VLB spray plane: two-phase oblivious path selection across an LB tier.

Valiant load balancing (SNIPPETS §3, RotorNet lineage) routes every bundle
through a *random intermediate* LB before the hop to its owner: phase 1
spreads any traffic matrix — however skewed per-DAQ — uniformly over the
tier, and phase 2 restores event affinity. The guarantee is traffic-
*oblivious*: no LB carries more than ~2/K of the aggregate regardless of
which DAQs are hot, where direct per-DAQ hashing concentrates a hot DAQ's
entire stream on one tier member.

Both choices are pure hashes (splitmix64 finalizer over the event number),
computed **per bundle**, never per segment:

* the *owner* is a function of the event number alone, so every segment of
  an event — from any DAQ, in any window — lands at the same owning LB and
  one calendar decides its member (fabric-wide event affinity);
* the *intermediate* mixes in the DAQ id, so one event's bundles from
  different DAQs take decorrelated phase-1 paths, but all segments of one
  bundle share a path and arrive in FIFO order for reassembly.

Hashing over the **live** tier (rank-indexed, not id-modulo) is what makes
``lb_node_failure`` re-spray hit-less: kill a tier member and the same
hash keys re-index over the survivors — deterministically, so a re-run
reproduces the exact re-spray (the report-identical audit of the
``lb_node_failure`` scenario).

The port of the JAX package's ``repro/fabric/spray.py`` (numpy only, kept
as a copy so the port imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_DAQ_SALT = np.uint64(0xD6E8FEB86659FD93)


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping arithmetic)."""
    z = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        z = z + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


def spray_keys(event_numbers: np.ndarray, daq_ids: np.ndarray,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-bundle ``(bundle_key, owner_key)`` uint64 hash pair.

    ``owner_key`` depends on the event number only (fabric-wide event
    affinity); ``bundle_key`` mixes in the DAQ id so phase-1 spray is
    decorrelated across a single event's bundles.
    """
    ev = np.asarray(event_numbers, np.uint64)
    dq = np.asarray(daq_ids, np.uint64)
    s = np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        owner_key = mix64(ev ^ (s * _GOLDEN))
        bundle_key = mix64(ev ^ ((dq + np.uint64(1)) * _DAQ_SALT) ^ s)
    return bundle_key, owner_key


def spray_paths(event_numbers: np.ndarray, daq_ids: np.ndarray,
                live_lbs, *, mode: str = "vlb",
                seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Choose ``(intermediate_lb, owner_lb, entropy)`` for each bundle.

    ``live_lbs`` is the ordered list of surviving tier members; hashes
    index its *ranks*, so the mapping is deterministic for a given live
    set. ``mode='vlb'`` is the two-phase spray; ``mode='direct'`` is the
    strawman it is gated against — static per-DAQ assignment (one hop,
    intermediate == owner), the "hash the source" scheme that concentrates
    a hot DAQ on one LB. ``entropy`` (u16, from the bundle key) rides in
    the LB header so all of a bundle's segments pick the same lane.
    """
    live = np.asarray(live_lbs, np.int64)
    n_live = len(live)
    if n_live == 0:
        raise ValueError("no live LB instances to spray across")
    bundle_key, owner_key = spray_keys(event_numbers, daq_ids, seed)
    entropy = (bundle_key & np.uint64(0xFFFF)).astype(np.uint32)
    if mode == "direct":
        lb = live[(np.asarray(daq_ids, np.int64) % n_live)]
        return lb, lb, entropy
    if mode != "vlb":
        raise ValueError(f"unknown spray mode {mode!r}")
    n = np.uint64(n_live)
    inter = live[(bundle_key % n).astype(np.int64)]
    owner = live[(owner_key % n).astype(np.int64)]
    return inter, owner, entropy
