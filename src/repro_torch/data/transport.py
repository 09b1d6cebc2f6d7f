"""UDP-over-WAN simulation: serialization, random path delay, reordering and
loss injection (paper fig. 7b: "packet serialization and random path delays
are built into the traffic generator"). Unidirectional, no backpressure, no
retransmit (paper §I-B.6).

Both delivery paths draw from the SAME per-window threefry stream
(``draw_window``: one ``fold_in`` per window, loss as one mask, duplication
as a masked row copy, reordering as a single jitter-keyed permutation).
The draws are bit-identical to the JAX package's ``jax.random`` stream
(``data/prng.py``), so under the same seed and window sequence the port
delivers the same packets in the same order as the reference.
``deliver_batch`` applies the plan to a ``PacketBatch`` with one row gather;
``deliver`` applies the identical plan to a per-packet list.

Duplicate ordering: a duplicate models the *same* serialized packet taking a
second (never earlier) path, so its sort key is the original's key plus a
strictly non-negative extra delay — a duplicate can never overtake the first
copy (ties break original-first).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import prng
from repro_torch.data.segmentation import PacketBatch, next_pow2
from repro_torch.device import resolve_device


@dataclasses.dataclass
class TransportConfig:
    reorder_window: int = 32      # max positions a packet can be displaced
    loss_prob: float = 0.0
    duplicate_prob: float = 0.0
    seed: int = 0


def uniform_block(seed: int, window: int, m: int, device) -> np.ndarray:
    """``float64[4, m]`` uniforms in [0, 1) for one window, drawn as float32
    on ``device`` (``m`` is padded to a power of two by the caller, as in
    the reference, so the draws line up element for element)."""
    key = prng.fold_in(prng.prng_key(seed), window)
    return prng.uniform(key, (4, m), device).cpu().numpy().astype(np.float64)


def draw_window(seed: int, window: int, n: int, *, loss_prob: float,
                duplicate_prob: float, jitter_scale: float, device="cuda"):
    """The per-window randomness both delivery paths share: one fold_in per
    window, then a loss mask, a duplicate mask (only surviving packets can
    duplicate) and two non-negative delay draws in ``[0, jitter_scale)`` —
    ``jitter`` delays the original copy, ``extra`` is the duplicate's
    additional (never negative) path delay.

    Returns host arrays ``(keep, dup, jitter, extra)``.
    """
    u = uniform_block(seed, window, next_pow2(n), resolve_device(device))[:, :n]
    keep = u[0] >= loss_prob
    dup = keep & (u[1] < duplicate_prob)
    w = float(max(jitter_scale, 0.0))
    jitter = u[2] * w
    extra = u[3] * w
    return keep, dup, jitter, extra


def delivery_order(keep: np.ndarray, dup: np.ndarray, key_orig: np.ndarray,
                   key_dup: np.ndarray):
    """Assemble one window's delivery plan from masks + delay keys.

    Surviving originals and duplicate copies are concatenated and sorted by
    delay key with originals winning ties — the one implementation of the
    duplicate-never-overtakes-its-original rule. Returns
    ``(src, is_dup, keys)`` in delivery order.
    """
    src = np.concatenate([np.flatnonzero(keep), np.flatnonzero(dup)])
    is_dup = np.concatenate(
        [np.zeros(int(keep.sum()), bool), np.ones(int(dup.sum()), bool)])
    keys = np.concatenate([key_orig[keep], key_dup[dup]])
    order = np.lexsort((is_dup, keys))
    return src[order], is_dup[order], keys[order]


class WANTransport:
    """Applies loss/duplication/reordering to a packet sequence.

    The random draws run on ``device`` (default ``"cuda"``; raises when CUDA
    is missing). ``last_delivery`` exposes per-output-row bookkeeping from
    the most recent call — ``(src_index, is_dup)`` arrays aligned with the
    delivered order.
    """

    def __init__(self, cfg: TransportConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_lost = 0
        self.n_dup = 0
        self._window = 0
        self.last_delivery: tuple[np.ndarray, np.ndarray] | None = None

    def _plan(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """One window's delivery plan: ``(src, is_dup)`` in delivery order.
        Shared by both paths; advances the window counter and the counters."""
        keep, dup, jitter, extra = draw_window(
            self.cfg.seed, self._window, n,
            loss_prob=self.cfg.loss_prob,
            duplicate_prob=self.cfg.duplicate_prob,
            jitter_scale=self.cfg.reorder_window, device=self.device)
        self._window += 1
        idx = np.arange(n, dtype=np.float64)
        key_orig = idx + jitter

        self.n_lost += int((~keep).sum())
        self.n_dup += int(dup.sum())
        src, is_dup, _keys = delivery_order(keep, dup, key_orig,
                                            key_orig + extra)
        self.last_delivery = (src, is_dup)
        return self.last_delivery

    # -- batched path (one vectorized pass per window) ------------------------
    def deliver_batch(self, batch: PacketBatch) -> PacketBatch:
        """Loss mask + duplicate copy + jitter-keyed permutation, one pass."""
        n = len(batch)
        if n == 0:
            self.last_delivery = (np.empty((0,), np.int64),
                                  np.zeros((0,), bool))
            return batch
        src, _ = self._plan(n)
        return batch.take(src)

    # -- per-packet reference path --------------------------------------------
    def deliver(self, packets: list) -> list:
        """List form of the identical plan (reference pipeline and tests)."""
        if not packets:
            self.last_delivery = (np.empty((0,), np.int64),
                                  np.zeros((0,), bool))
            return []
        src, _ = self._plan(len(packets))
        return [packets[i] for i in src]
