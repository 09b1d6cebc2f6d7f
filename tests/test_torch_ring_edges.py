"""The plain versions that the simulator's two ring kernels (``farm_serve``,
``seq_cumsum``) are held against on the card, against the JAX package's
numpy engines on the edges of the kernels' rings: ``farm_serve`` against
``repro.simnet.queues._serve_np`` with members across several 256-row
tiles, starting at odd rows, all rows in one member, 300 members, empty
members between full ones and rows past the last member; ``seq_cumsum``
against ``np.cumsum`` at a 1024-row tile's size and beside it, at 2^20
rows, and with zeros, negatives and -0.0 first (bit for bit). All exactly
equal."""
import numpy as np
import pytest
import torch

from repro.simnet.queues import _serve_np
from repro_torch.kernels.farm_serve import farm_serve
from repro_torch.kernels.seq_cumsum import seq_cumsum
from torch_helpers import FARM_RING_EDGES, SCAN_RING_SIZES, serve_case, signed_sum_input


def _serve_reference(args):
    """The numpy engine on the rows laid out as its [member, column] matrix,
    its outputs laid back onto the rows (rows of no member: inf, False)."""
    t, s, offsets, w0, t0, cap = (a.numpy() for a in args)
    counts = np.diff(offsets)
    cols = int(counts.max())
    tm, sm = np.zeros((len(counts), cols)), np.zeros((len(counts), cols))
    valid = np.arange(cols)[None, :] < counts[:, None]
    for m, (lo, c) in enumerate(zip(offsets[:-1], counts)):
        tm[m, :c], sm[m, :c] = t[lo:lo + c], s[lo:lo + c]
    dep, drop, w, t_last, w_max = _serve_np(tm, sm, valid, w0, t0, cap)
    dep_r, drop_r = np.full(len(t), np.inf), np.zeros(len(t), bool)
    for m, (lo, c) in enumerate(zip(offsets[:-1], counts)):
        dep_r[lo:lo + c], drop_r[lo:lo + c] = dep[m, :c], drop[m, :c]
    return dep_r, drop_r, w, t_last, w_max


@pytest.mark.parametrize("case", sorted(FARM_RING_EDGES))
def test_plain_farm_serve_equals_numpy_engine_on_ring_edges(case):
    args = serve_case(FARM_RING_EDGES[case], len(case), extra_rows=5)
    got = farm_serve(*args)
    want = _serve_reference(args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < int(got[1].sum()) < int(np.diff(args[2].numpy()).sum())  # both branches


@pytest.mark.parametrize("n", SCAN_RING_SIZES)
def test_plain_running_sum_on_ring_edges_is_numpy_cumsum(n):
    x = signed_sum_input(n, n)
    got = seq_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int64), np.cumsum(x).view(np.int64))


def test_plain_running_sum_keeps_negative_zero_first():
    x = np.array([-0.0, -0.0, 0.0, -1.5, 1.5, -0.0])
    got = seq_cumsum(torch.from_numpy(x)).numpy()
    want = np.cumsum(x)
    assert np.signbit(want[0]) and np.signbit(want[1]) and not np.signbit(want[2])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
