"""Application-layer segmentation & reassembly protocol (paper §II-C).

"A dedicated, application layer segmentation and reassembly protocol is
required. This protocol runs between the DAQ and the compute node. The load
balancer does not participate." Each segment carries the LB header (same
Event Number + same Entropy for all segments of a bundle => same CN, same
receive lane) plus an opaque-to-the-LB segmentation header:

    seg_hdr = (daq_id u16, seg_index u16, n_segs u16, payload_len u16)

The production representation is **batched**: a window of wire packets is a
``PacketBatch`` — struct-of-arrays with stacked ``uint32[N, 4]`` LB words,
seg-header columns and a padded ``uint8[N, mtu]`` payload matrix — built by
``segment_bundles`` in one vectorized pass per bundle batch (no per-packet
Python work; see DESIGN.md §Ingest). Reassembly of a batch is the sort-based
``repro_torch.data.reassembly.BatchReassembler``; completion is detected by
per-(event, daq) unique-segment counts, losses surface as incomplete buffers
(accounted + timed out), never as corrupt bundles.

``Segment``/``segment_bundle``/``Reassembler`` below are the per-packet
host-loop *reference* implementation: the oracle for round-trip parity tests
and the baseline that ``benchmarks/bench_ingest.py`` measures the batched
path against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.protocol import (
    MAX_SEGMENT_PAYLOAD,
    encode_headers,
    encode_seg_headers,
)
from repro_torch.data.daq import EventBundle

SEG_HDR_BYTES = 8
DEFAULT_MTU_PAYLOAD = MAX_SEGMENT_PAYLOAD - SEG_HDR_BYTES


def next_pow2(n: int, lo: int = 16) -> int:
    """Smallest power of two >= n (floor ``lo``) — the window padding grid
    that keeps device-call shapes (and so the jit cache) bounded."""
    p = lo
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class PacketBatch:
    """A window of wire packets as struct-of-arrays (one row per segment).

    ``headers`` are the LB protocol words consumed by ``DataPlane.route``;
    the seg-header columns (opaque to the LB) drive reassembly; ``payload``
    is row-padded to the batch's MTU payload width with ``payload_len`` valid
    bytes per row. ``event_number``/``entropy`` are host-side convenience
    columns (also encoded in ``headers``).
    """

    headers: np.ndarray       # uint32[N, 4]  LB words
    daq_id: np.ndarray        # int32[N]
    seg_index: np.ndarray     # int32[N]
    n_segs: np.ndarray        # int32[N]
    payload_len: np.ndarray   # int32[N]
    payload: np.ndarray       # uint8[N, mtu]
    event_number: np.ndarray  # uint64[N]
    entropy: np.ndarray       # uint32[N]

    def __len__(self) -> int:
        return int(self.headers.shape[0])

    @property
    def mtu_payload(self) -> int:
        return int(self.payload.shape[1])

    def seg_words(self) -> np.ndarray:
        """The uint32[N, 2] seg-header words (wire form of the columns)."""
        return encode_seg_headers(self.daq_id, self.seg_index, self.n_segs,
                                  self.payload_len)

    def take(self, idx) -> "PacketBatch":
        """Row gather (reorder / subset / duplicate)."""
        idx = np.asarray(idx)
        return PacketBatch(
            headers=self.headers[idx], daq_id=self.daq_id[idx],
            seg_index=self.seg_index[idx], n_segs=self.n_segs[idx],
            payload_len=self.payload_len[idx], payload=self.payload[idx],
            event_number=self.event_number[idx], entropy=self.entropy[idx],
        )

    @classmethod
    def empty(cls, mtu_payload: int = DEFAULT_MTU_PAYLOAD) -> "PacketBatch":
        return cls(
            headers=np.empty((0, 4), np.uint32),
            daq_id=np.empty((0,), np.int32),
            seg_index=np.empty((0,), np.int32),
            n_segs=np.empty((0,), np.int32),
            payload_len=np.empty((0,), np.int32),
            payload=np.empty((0, mtu_payload), np.uint8),
            event_number=np.empty((0,), np.uint64),
            entropy=np.empty((0,), np.uint32),
        )

    @classmethod
    def concat(cls, batches: Sequence["PacketBatch"]) -> "PacketBatch":
        batches = [b for b in batches if len(b) > 0]
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]  # shared arrays; PacketBatch ops never mutate
        widths = {b.mtu_payload for b in batches}
        if len(widths) > 1:
            raise ValueError(f"mixed mtu payload widths: {sorted(widths)}")
        return cls(**{
            f.name: np.concatenate([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(cls)
        })


def group_rows(keys: np.ndarray):
    """Partition row positions by key in ONE stable pass (unique + stable
    argsort of the inverse + cumsum bounds) — no per-group window rescan.

    ``keys`` is ``[N]`` or ``[N, K]`` (composite keys as columns). Returns
    ``(unique_keys, groups)`` where ``groups[i]`` holds the positions of
    ``unique_keys[i]`` in arrival order (the stable sort preserves it, which
    the reassembler's duplicate-first-copy tie-break relies on).
    """
    if keys.ndim == 1:
        uniq, inverse, counts = np.unique(
            keys, return_inverse=True, return_counts=True)
    else:
        uniq, inverse, counts = np.unique(
            keys, axis=0, return_inverse=True, return_counts=True)
    order = np.argsort(inverse.reshape(-1), kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    groups = [order[bounds[k] : bounds[k + 1]] for k in range(len(uniq))]
    return uniq, groups


def segment_bundles(bundles: Sequence[EventBundle],
                    mtu_payload: int = DEFAULT_MTU_PAYLOAD) -> PacketBatch:
    """Segment a batch of Event Data Bundles in one vectorized pass.

    Emits the whole window's packets at once: stacked LB header words plus
    seg-header columns. The payload matrix IS the (row-padded) byte stream —
    one C-level concatenate of each bundle's bytes plus its tail padding
    lands every bundle on consecutive mtu-wide rows; all per-*segment* work
    is array arithmetic.
    """
    if not bundles:
        return PacketBatch.empty(mtu_payload)
    lens = np.asarray([len(b.payload) for b in bundles], np.int64)
    evs = np.asarray([b.event_number for b in bundles], np.uint64)
    ents = np.asarray([b.entropy for b in bundles], np.uint32)
    daqs = np.asarray([b.daq_id for b in bundles], np.int32)
    n_segs = np.maximum(1, -(-lens // mtu_payload)).astype(np.int64)

    n = int(n_segs.sum())
    bid = np.repeat(np.arange(len(bundles)), n_segs)           # bundle of row
    first = np.repeat(np.cumsum(n_segs) - n_segs, n_segs)      # first row of bundle
    seg_index = (np.arange(n) - first).astype(np.int64)
    offset = seg_index * mtu_payload
    seg_len = np.minimum(mtu_payload, lens[bid] - offset)
    seg_len = np.maximum(seg_len, 0)

    # One C-level concatenate builds the whole byte stream: each bundle's
    # payload followed by its (usually tiny) tail padding to the row grid.
    zpad = np.zeros((mtu_payload,), np.uint8)
    tail = n_segs * mtu_payload - lens
    pieces = []
    for i, b in enumerate(bundles):
        pieces.append(b.payload)
        if tail[i]:
            pieces.append(zpad[: tail[i]])
    payload = np.concatenate(pieces).reshape(n, mtu_payload)

    return PacketBatch(
        headers=encode_headers(evs[bid], ents[bid]),
        daq_id=daqs[bid].astype(np.int32),
        seg_index=seg_index.astype(np.int32),
        n_segs=n_segs[bid].astype(np.int32),
        payload_len=seg_len.astype(np.int32),
        payload=payload,
        event_number=evs[bid],
        entropy=ents[bid].astype(np.uint32),
    )


def batch_from_segments(segments: Sequence["Segment"],
                        mtu_payload: int = DEFAULT_MTU_PAYLOAD) -> PacketBatch:
    """Pack per-packet ``Segment`` objects into a ``PacketBatch`` (test shim)."""
    if not segments:
        return PacketBatch.empty(mtu_payload)
    n = len(segments)
    payload = np.zeros((n, mtu_payload), np.uint8)
    plen = np.empty((n,), np.int32)
    for i, s in enumerate(segments):
        plen[i] = len(s.payload)
        payload[i, : plen[i]] = s.payload
    return PacketBatch(
        headers=np.stack([s.lb_words for s in segments]).astype(np.uint32),
        daq_id=np.asarray([s.daq_id for s in segments], np.int32),
        seg_index=np.asarray([s.seg_index for s in segments], np.int32),
        n_segs=np.asarray([s.n_segs for s in segments], np.int32),
        payload_len=plen,
        payload=payload,
        event_number=np.asarray([s.event_number for s in segments], np.uint64),
        entropy=np.asarray([s.entropy for s in segments], np.uint32),
    )


# ---------------------------------------------------------------------------
# Per-packet reference path (round-trip oracle + bench baseline).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Segment:
    """One wire packet: LB header words + segmentation header + payload."""

    lb_words: np.ndarray  # uint32[4]
    daq_id: int
    seg_index: int
    n_segs: int
    payload: np.ndarray   # uint8
    event_number: int     # host-side convenience (also in lb_words)
    entropy: int


def segment_bundle(bundle: EventBundle,
                   mtu_payload: int = DEFAULT_MTU_PAYLOAD) -> list[Segment]:
    """Split one Event Data Bundle into <=9KB segments, all sharing the
    bundle's (Event Number, Entropy). Per-packet reference; the batched path
    is ``segment_bundles``."""
    data = bundle.payload
    n_segs = max(1, -(-len(data) // mtu_payload))
    words = encode_headers(
        np.asarray([bundle.event_number], np.uint64),
        np.asarray([bundle.entropy], np.uint32),
    )[0]
    return [
        Segment(
            lb_words=words, daq_id=bundle.daq_id, seg_index=i, n_segs=n_segs,
            payload=data[i * mtu_payload : (i + 1) * mtu_payload],
            event_number=bundle.event_number, entropy=bundle.entropy,
        )
        for i in range(n_segs)
    ]


class Reassembler:
    """CN-side per-packet reference reassembler, one instance per receive
    lane (entropy/RSS lane: the paper's fix for the single-core reassembly
    bottleneck). The batched production path is
    ``repro_torch.data.reassembly.BatchReassembler``."""

    def __init__(self):
        self.buffers: dict[tuple[int, int], dict] = {}
        self.completed: list[tuple[tuple[int, int], np.ndarray]] = []
        self.n_duplicate = 0

    def push(self, seg: Segment) -> Optional[np.ndarray]:
        key = (seg.event_number, seg.daq_id)
        buf = self.buffers.get(key)
        if buf is None:
            buf = {"parts": {}, "n_segs": seg.n_segs}
            self.buffers[key] = buf
        if seg.seg_index in buf["parts"]:
            self.n_duplicate += 1
            return None
        buf["parts"][seg.seg_index] = seg.payload
        if len(buf["parts"]) == buf["n_segs"]:
            data = np.concatenate([buf["parts"][i] for i in range(buf["n_segs"])])
            del self.buffers[key]
            self.completed.append((key, data))
            return data
        return None

    @property
    def n_incomplete(self) -> int:
        return len(self.buffers)

    def drain_completed(self):
        out, self.completed = self.completed, []
        return out
