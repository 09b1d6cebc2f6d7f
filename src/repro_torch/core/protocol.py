"""EJ-FAT Load Balancer protocol header (paper fig. 2).

Wire layout (16 bytes, network order), carried after the UDP header::

    0               1               2               3
    +-------+-------+-------+-------+-------+-------+-------+-------+
    | 'L'   | 'B'   |Version|Proto  |     rsvd      |    Entropy    |
    +-------+-------+-------+-------+-------+-------+-------+-------+
    |                     Event Number (64 bit)                     |
    +---------------------------------------------------------------+

Packets are carried as ``[..., 4]`` header words

    word0 = magic(16) << 16 | version(8) << 8 | protocol(8)
    word1 = rsvd(16)  << 16 | entropy(16)
    word2 = event number high 32 bits
    word3 = event number low  32 bits

Host code builds them as numpy ``uint32``. PyTorch implements neither
shifts nor ordered compares on ``uint32``, so on the torch side a word
travels either as ``int32`` with the same bits (what the kernels read as
``uint32_t``) or as ``int64`` holding the unsigned value; ``as_u32``
turns the former into the latter. The tensor functions below accept both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# 'L' << 8 | 'B'  — also the LB UDP service port (paper §III-A: 19522 = 0x4C42).
MAGIC = 0x4C42
VERSION = 1
PROTOCOL = 1
LB_SERVICE_PORT = 19522

HEADER_WORDS = 4
HEADER_BYTES = 16
# Paper §II-C: 9KB max network packet size bounds a segment (headers included).
MAX_PACKET_BYTES = 9000
MAX_SEGMENT_PAYLOAD = MAX_PACKET_BYTES - HEADER_BYTES - 28  # IP(20) + UDP(8)

# Paper §III fig. 4: the 9 LSBs of the event number select the calendar slot.
CALENDAR_SLOT_BITS = 9
CALENDAR_SLOTS = 1 << CALENDAR_SLOT_BITS
SLOT_MASK = CALENDAR_SLOTS - 1

U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LBHeader:
    """Host-side view of one LB protocol header."""

    event_number: int
    entropy: int
    version: int = VERSION
    protocol: int = PROTOCOL
    rsvd: int = 0

    def words(self) -> np.ndarray:
        return encode_headers(
            np.asarray([self.event_number], dtype=np.uint64),
            np.asarray([self.entropy], dtype=np.uint32),
            version=self.version,
            protocol=self.protocol,
            rsvd=self.rsvd,
        )[0]


def split64(x) -> tuple[np.ndarray, np.ndarray]:
    """Split uint64 -> (hi, lo) uint32. Host-side helper."""
    x = np.asarray(x, dtype=np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join64(hi, lo) -> np.ndarray:
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def encode_headers(
    event_numbers: np.ndarray,
    entropy: np.ndarray,
    *,
    version: int = VERSION,
    protocol: int = PROTOCOL,
    rsvd: int = 0,
) -> np.ndarray:
    """Encode N headers into uint32[N, 4] wire words (host side, numpy)."""
    event_numbers = np.asarray(event_numbers, dtype=np.uint64)
    entropy = np.asarray(entropy, dtype=np.uint32)
    if event_numbers.shape != entropy.shape:
        raise ValueError("event_numbers and entropy must have matching shapes")
    n = event_numbers.shape[0]
    out = np.empty((n, HEADER_WORDS), dtype=np.uint32)
    out[:, 0] = (MAGIC << 16) | ((version & 0xFF) << 8) | (protocol & 0xFF)
    out[:, 1] = ((rsvd & 0xFFFF) << 16) | (entropy & 0xFFFF)
    hi, lo = split64(event_numbers)
    out[:, 2] = hi
    out[:, 3] = lo
    return out


def encode_seg_headers(daq_id, seg_index, n_segs, payload_len) -> np.ndarray:
    """Encode N segmentation headers into uint32[N, 2] words (host side).

    The segmentation header (paper §II-C) is opaque to the LB and rides after
    the LB header: ``(daq_id u16, seg_index u16, n_segs u16, payload_len u16)``
    packed as

        word0 = daq_id(16) << 16 | seg_index(16)
        word1 = n_segs(16) << 16 | payload_len(16)
    """
    daq_id = np.asarray(daq_id, np.uint32)
    seg_index = np.asarray(seg_index, np.uint32)
    n_segs = np.asarray(n_segs, np.uint32)
    payload_len = np.asarray(payload_len, np.uint32)
    out = np.empty(daq_id.shape + (2,), np.uint32)
    out[..., 0] = ((daq_id & 0xFFFF) << 16) | (seg_index & 0xFFFF)
    out[..., 1] = ((n_segs & 0xFFFF) << 16) | (payload_len & 0xFFFF)
    return out


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 host words -> an int32 tensor with the same bits on ``device``
    (no copy on the host: a view, then one transfer)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (bit pattern) or int64 words -> int64 holding the u32 value."""
    return x.to(torch.int64) & U32_MASK


def decode_seg_headers(words: torch.Tensor) -> dict:
    """Decode seg-header words -> dict of int64 field tensors."""
    w = as_u32(words)
    w0 = w[..., 0]
    w1 = w[..., 1]
    return {
        "daq_id": (w0 >> 16) & 0xFFFF,
        "seg_index": w0 & 0xFFFF,
        "n_segs": (w1 >> 16) & 0xFFFF,
        "payload_len": w1 & 0xFFFF,
    }


def decode_fields(words: torch.Tensor) -> dict:
    """Decode header words -> dict of int64 field tensors: magic, version,
    protocol, rsvd, entropy, event_hi, event_lo (unsigned values)."""
    w = as_u32(words)
    w0 = w[..., 0]
    w1 = w[..., 1]
    return {
        "magic": (w0 >> 16) & 0xFFFF,
        "version": (w0 >> 8) & 0xFF,
        "protocol": w0 & 0xFF,
        "rsvd": (w1 >> 16) & 0xFFFF,
        "entropy": w1 & 0xFFFF,
        "event_hi": w[..., 2],
        "event_lo": w[..., 3],
    }


def validate(words: torch.Tensor) -> torch.Tensor:
    """Parser validation (paper §III-A): magic and version must match.

    Returns a bool tensor; packets failing validation are discarded upstream.
    No parsing is done on any bytes beyond the LB header.
    """
    f = decode_fields(words)
    return (f["magic"] == MAGIC) & (f["version"] == VERSION)


def event_slot(event_lo):
    """Calendar slot = 9 LSBs of the event number (paper fig. 4)."""
    return event_lo & SLOT_MASK
