"""Synthetic DAQ event sources.

Models the paper's traffic: several DAQs observing the same triggers emit
Event Data Bundles tagged with a *common*, monotonically increasing Event
Number (hardware-trigger-synchronized, §II-A: "a common method to assign an
Event Number is to use the high resolution timestamp from the DAQ trigger").
Payloads here are token sequences (the framework trains LMs on the streamed
events), with per-DAQ variable bundle sizes as in fig. 7a.

Event numbers advance by a random stride (timestamp-like) while keeping the
9 LSBs uniform — the paper's requirement for statistically even balancing.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class EventBundle:
    event_number: int
    daq_id: int
    entropy: int
    payload: np.ndarray  # uint8 bytes (serialized tokens)


@dataclasses.dataclass
class DAQConfig:
    n_daqs: int = 5
    seq_len: int = 128
    vocab: int = 256
    mean_bundle_bytes: int = 24_000  # > 9KB MTU => multiple segments
    seed: int = 0
    timestamp_stride: tuple[int, int] = (1, 7)  # uniform stride range
    # Prefix payloads with the event's reproducible token sample (the LM
    # training flow decodes it). Traffic-only consumers (simnet) turn it
    # off — the per-event token RNG is the one per-trigger host cost.
    token_payload: bool = True


class DAQFleet:
    """Generates per-trigger bundles from all DAQs (synchronized numbers)."""

    def __init__(self, cfg: DAQConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.event_number = int(self.rng.integers(1, 1 << 20))

    def tokens_for_event(self, event_number: int) -> np.ndarray:
        r = np.random.default_rng(event_number)  # reproducible per event
        return r.integers(0, self.cfg.vocab, self.cfg.seq_len).astype(np.int32)

    def next_trigger(self) -> list[EventBundle]:
        """One hardware trigger: every DAQ emits a bundle for this event."""
        return self.bundle_window(1)

    def stream(self, n_triggers: int) -> Iterator[list[EventBundle]]:
        for _ in range(n_triggers):
            yield self.next_trigger()

    def bundle_window(self, n_triggers: int) -> list[EventBundle]:
        """One ingest window: all bundles of ``n_triggers`` triggers, flat —
        the unit the batched segmentation pass (``segment_bundles``) and the
        WAN ``deliver_batch`` consume (DESIGN.md §Ingest).

        Draws the whole window in one pass (strides, entropies, sizes, one
        payload blob); per-bundle work is an ``EventBundle`` wrapper around a
        blob slice, so traffic generation keeps up with the vectorized
        ingest path and the virtual-time simulator.
        """
        cfg = self.cfg
        t, d = n_triggers, cfg.n_daqs
        if t <= 0:
            return []
        lo, hi = cfg.timestamp_stride
        strides = self.rng.integers(lo, hi + 1, t)
        evs = self.event_number + np.concatenate(
            [[0], np.cumsum(strides[:-1])])
        self.event_number = int(self.event_number + strides.sum())
        ents = self.rng.integers(0, 1 << 16, t)
        nbytes = np.maximum(1024, self.rng.normal(
            cfg.mean_bundle_bytes, cfg.mean_bundle_bytes / 8,
            (t, d)).astype(np.int64))
        blob = self.rng.integers(0, 256, int(nbytes.sum()), dtype=np.uint8)
        bounds = np.concatenate([[0], np.cumsum(nbytes.reshape(-1))])
        out = []
        for k in range(t):
            tok_bytes = None
            if cfg.token_payload:
                tokens = self.tokens_for_event(int(evs[k]))
                tok_bytes = np.frombuffer(tokens.astype("<i4").tobytes(),
                                          np.uint8)
            for q in range(d):
                payload = blob[bounds[k * d + q]: bounds[k * d + q + 1]]
                if tok_bytes is not None:
                    # First bytes carry the token payload so CN-side
                    # reassembly can rebuild the training sample.
                    payload[: len(tok_bytes)] = tok_bytes
                out.append(EventBundle(int(evs[k]), q, int(ents[k]), payload))
        return out
