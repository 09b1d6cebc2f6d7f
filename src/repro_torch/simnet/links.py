"""Virtual-time link model: FIFO serialization, propagation, jitter, loss.

A link is a token-bucket-rate FIFO: packet *i* leaves the head-end at

    dep_i = max(t_ready_i, dep_{i-1}) + bytes_i / rate

and arrives ``prop_delay + jitter`` later. The recurrence is vectorized with
the cumsum/cummax identity

    dep_i = c_i + max_{j<=i}(t_j - c_{j-1}),   c = cumsum(bytes / rate)

(one ``cumsum`` + one running max per window; seeded with the carried
``busy_until`` so serialization state flows across windows). The per-link
form (``fifo_departures_multi``) sorts rows by ``(link, t_ready)`` once and
runs the same identity segment-wise.

Serialization stays numpy, as in the JAX package. Loss, duplication and
jitter draw from the shared per-window threefry stream of
``data.transport.draw_window`` on the link's ``device``, bit-identical to the
reference's ``jax.random`` draws, so the same seed delivers the same packets
at the same instants. Correlated loss is a Gilbert-Elliott two-state chain
whose sojourns are geometric, generated vectorized as alternating run
lengths; only the current state carries across windows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import prng
from repro_torch.data.segmentation import next_pow2
from repro_torch.data.transport import delivery_order, draw_window
from repro_torch.device import resolve_device


def fifo_departures(t_ready: np.ndarray, tx_s: np.ndarray,
                    busy_until: float = -np.inf) -> tuple[np.ndarray, float]:
    """Head-end departure times for one FIFO link, rows in service order.

    ``tx_s`` is each packet's transmit (serialization) time; zeros model an
    infinite-rate link. Returns ``(departures, new_busy_until)``.
    """
    n = len(t_ready)
    if n == 0:
        return np.empty((0,), np.float64), busy_until
    c = np.cumsum(tx_s, dtype=np.float64)
    a = np.asarray(t_ready, np.float64) - (c - tx_s)
    a[0] = max(a[0], busy_until)
    dep = c + np.maximum.accumulate(a)
    return dep, float(dep[-1])


def fifo_departures_multi(link: np.ndarray, t_ready: np.ndarray,
                          tx_s: np.ndarray,
                          busy_until: np.ndarray) -> np.ndarray:
    """Per-link FIFO serialization in one segmented pass.

    Sorts rows by ``(link, t_ready)``, applies the cumsum/cummax identity
    within each link's segment (running max segmented by the offset trick),
    seeds each segment with that link's carried ``busy_until`` and updates it
    in place. Returns per-row departures in the caller's row order.
    """
    n = len(link)
    if n == 0:
        return np.empty((0,), np.float64)
    order = np.lexsort((t_ready, link))
    lk = link[order]
    t = np.asarray(t_ready, np.float64)[order]
    s = np.asarray(tx_s, np.float64)[order]
    new = np.ones((n,), bool)
    new[1:] = lk[1:] != lk[:-1]
    gid = np.cumsum(new) - 1
    cs = np.cumsum(s)
    seg_base = cs[new] - s[new]                  # exclusive cumsum at starts
    c = cs - seg_base[gid]                       # segmented inclusive cumsum
    a = t - (c - s)
    a[new] = np.maximum(a[new], busy_until[lk[new]])
    # Segmented running max: add a per-segment offset larger than the value
    # span so earlier segments can never dominate, accumulate, subtract.
    span = float(a.max() - a.min()) + 1.0
    off = gid * span
    dep_sorted = c + (np.maximum.accumulate(a + off) - off)
    last = np.flatnonzero(np.concatenate([new[1:], [True]]))
    busy_until[lk[last]] = np.maximum(busy_until[lk[last]], dep_sorted[last])
    dep = np.empty((n,), np.float64)
    dep[order] = dep_sorted
    return dep


def gilbert_elliott_states(seed: int, window: int, n: int, *, p_gb: float,
                           p_bg: float, start_bad: bool,
                           device="cuda") -> tuple[np.ndarray, bool]:
    """Per-packet bad-state mask from a two-state Markov chain, vectorized.

    Sojourn lengths are geometric, so the whole window's states are built as
    alternating geometric run lengths (inverse-CDF over one uniform draw per
    potential run; n+1 runs always cover n packets). The uniforms are the
    reference's ``jax.random.uniform(fold_in(PRNGKey(seed ^ 0x6E5), window),
    minval=1e-12)`` draw, made on ``device``. Memorylessness means only the
    final state needs to carry across windows.
    """
    if n == 0:
        return np.zeros((0,), bool), start_bad
    key = prng.fold_in(prng.prng_key(seed ^ 0x6E5), window)
    u = prng.uniform(key, (next_pow2(n + 1),), resolve_device(device),
                     minval=1e-12, maxval=1.0).cpu().numpy().astype(np.float64)[: n + 1]
    k = np.arange(n + 1)
    bad = (k % 2 == 1) if not start_bad else (k % 2 == 0)
    p_exit = np.where(bad, p_bg, p_gb)
    with np.errstate(divide="ignore"):
        lengths = np.where(
            p_exit <= 0.0, n,  # absorbing: one run covers the window
            1 + np.floor(np.log(u) / np.log1p(-np.clip(p_exit, 1e-12, 1.0))))
    bounds = np.cumsum(lengths)
    run_of_packet = np.searchsorted(bounds, np.arange(n), side="right")
    run_of_packet = np.minimum(run_of_packet, n)
    states = bad[run_of_packet]
    return states, bool(states[-1])


@dataclasses.dataclass
class LinkConfig:
    """One link's fixed parameters (scenario hooks may mutate them mid-run)."""

    rate_Bps: float = 0.0          # serialization rate; 0 = infinite (no FIFO wait)
    prop_delay_s: float = 0.0
    jitter_s: float = 0.0          # uniform extra path delay in [0, jitter_s)
    loss_prob: float = 0.0
    duplicate_prob: float = 0.0
    # Gilbert-Elliott correlated loss: active when bad_loss_prob > 0.
    p_good_to_bad: float = 0.0
    p_bad_to_good: float = 0.1
    bad_loss_prob: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class LinkDelivery:
    """One window's deliveries in arrival order (struct-of-arrays)."""

    src: np.ndarray        # int64[K] input row of each delivered packet
    is_dup: np.ndarray     # bool[K]
    t_arrive: np.ndarray   # float64[K]
    n_lost: int


class Link:
    """A stateful point-to-point link (DAQ uplinks aggregate, the WAN hop).

    ``transit`` serializes the window in emission order, applies loss
    (optionally Gilbert-Elliott correlated), duplication and jitter from the
    shared per-window stream (drawn on ``device``), and returns deliveries
    sorted by arrival time (duplicates tie-broken after their original).
    """

    def __init__(self, cfg: LinkConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.busy_until = -np.inf
        self.n_lost = 0
        self.n_dup = 0
        self._window = 0
        self._ge_bad = False

    def transit(self, t_emit: np.ndarray, nbytes: np.ndarray) -> LinkDelivery:
        cfg = self.cfg
        n = len(t_emit)
        window = self._window
        self._window += 1
        if n == 0:
            return LinkDelivery(np.empty((0,), np.int64),
                                np.zeros((0,), bool),
                                np.empty((0,), np.float64), 0)
        # emission order; only needed for serialization and the loss chain
        order = (np.argsort(t_emit, kind="stable")
                 if cfg.rate_Bps > 0 or cfg.bad_loss_prob > 0 else None)
        if cfg.rate_Bps > 0:
            tx = np.asarray(nbytes, np.float64) / cfg.rate_Bps
            dep_sorted, self.busy_until = fifo_departures(
                np.asarray(t_emit, np.float64)[order], tx[order],
                self.busy_until)
            dep = np.empty((n,), np.float64)
            dep[order] = dep_sorted
        else:
            # infinite rate: no serialization queue, no cross-window coupling
            dep = np.asarray(t_emit, np.float64)

        loss_p: float | np.ndarray = cfg.loss_prob
        if cfg.bad_loss_prob > 0:
            bad, self._ge_bad = gilbert_elliott_states(
                cfg.seed, window, n, p_gb=cfg.p_good_to_bad,
                p_bg=cfg.p_bad_to_good, start_bad=self._ge_bad,
                device=self.device)
            # chain runs in emission order; map state back to row order
            bad_rows = np.empty((n,), bool)
            bad_rows[order] = bad
            loss_p = np.where(bad_rows, cfg.bad_loss_prob, cfg.loss_prob)
        keep, dup, jitter, extra = draw_window(
            cfg.seed, window, n, loss_prob=loss_p,
            duplicate_prob=cfg.duplicate_prob, jitter_scale=cfg.jitter_s,
            device=self.device)

        arrive = dep + cfg.prop_delay_s + jitter
        self.n_lost += int((~keep).sum())
        self.n_dup += int(dup.sum())
        src, is_dup, t_arr = delivery_order(keep, dup, arrive, arrive + extra)
        return LinkDelivery(src, is_dup, t_arr, int((~keep).sum()))


class LinkSet:
    """A bank of per-destination links (LB -> CN downlinks), vectorized.

    One segmented serialization pass over all links per window; per-link
    rate/loss live in arrays so scenario hooks can flap a single member's
    link mid-run. Downlinks do not duplicate (the LB emits each packet
    once); loss models a dirty edge link.
    """

    def __init__(self, cfgs: list[LinkConfig], device="cuda"):
        self.device = resolve_device(device)
        self.n_links = len(cfgs)
        self.rate_Bps = np.asarray([c.rate_Bps for c in cfgs], np.float64)
        self.prop_delay_s = np.asarray([c.prop_delay_s for c in cfgs], np.float64)
        self.jitter_s = np.asarray([c.jitter_s for c in cfgs], np.float64)
        self.loss_prob = np.asarray([c.loss_prob for c in cfgs], np.float64)
        if any(c.duplicate_prob for c in cfgs):
            raise ValueError("downlinks do not duplicate")
        if any(c.bad_loss_prob for c in cfgs):
            raise ValueError("LinkSet does not model correlated "
                             "(Gilbert-Elliott) loss; use a Link per "
                             "destination if a downlink needs it")
        self.seed = cfgs[0].seed if cfgs else 0
        self.busy_until = np.full((self.n_links,), -np.inf)
        self.n_lost = 0
        self._window = 0

    def transit(self, link: np.ndarray, t_ready: np.ndarray,
                nbytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns ``(t_arrive, keep)`` aligned with the input rows (lost
        rows have ``keep=False``; their arrival time is meaningless)."""
        n = len(link)
        window = self._window
        self._window += 1
        if n == 0:
            return np.empty((0,), np.float64), np.zeros((0,), bool)
        if (self.rate_Bps > 0).all():
            tx = np.asarray(nbytes, np.float64) / self.rate_Bps[link]
            dep = fifo_departures_multi(link, t_ready, tx, self.busy_until)
        else:
            rate = self.rate_Bps[link]
            tx = np.where(rate > 0,
                          np.asarray(nbytes, np.float64)
                          / np.where(rate > 0, rate, 1.0), 0.0)
            dep = fifo_departures_multi(link, t_ready, tx, self.busy_until)
            # zero-rate links serialize nothing: no wait, no carried state
            free = self.rate_Bps[link] <= 0
            dep = np.where(free, np.asarray(t_ready, np.float64), dep)
            self.busy_until[self.rate_Bps <= 0] = -np.inf
        keep, _dup, jitter, _extra = draw_window(
            self.seed, window, n, loss_prob=self.loss_prob[link],
            duplicate_prob=0.0, jitter_scale=1.0, device=self.device)
        t_arr = dep + self.prop_delay_s[link] + jitter * self.jitter_s[link]
        self.n_lost += int((~keep).sum())
        return t_arr, keep
