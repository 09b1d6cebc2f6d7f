"""The fused engine's calendar rebuild past one warp, on the CPU: the plain
``repro_torch.kernels.ref.build_calendar_ref`` (what the CUDA kernel
``csrc/simnet_kernels.cu::build_calendar_kernel`` is held to on the card)
against the port's host calendar and the JAX package's, at up to 512
members; a numpy model of the identities the kernel's design rests on
against the plain version, with the contract the kernel checks in place of
the quota walk (the round-robin meets every quota); the wrapper's refusals.

The card tests of the kernel itself are ``tests/test_torch_cuda.py``
(``test_build_calendar_*``)."""
import numpy as np
import pytest
import torch

from repro.core.calendar import build_calendar as jax_package_calendar
from repro_torch.core.calendar import _enforce_quotas
from repro_torch.core.calendar import build_calendar as host_calendar
from repro_torch.kernels.calendar import MAX_MEMBERS, MAX_SLOTS, build_calendar
from repro_torch.kernels.ref import build_calendar_ref, np_sum
from repro_torch.testing.hypo import given, settings, st
from torch_helpers import calendar_weights as weights

KEY_SHIFT = 10  # csrc/simnet_kernels.cu: kKeyShift
KINDS = ("random", "ties", "surplus", "equal", "log-uniform")


def plain(w, n_slots):
    out = torch.full((n_slots,), -1, dtype=torch.int32)
    return build_calendar_ref(torch.from_numpy(w), torch.tensor([True]), out).numpy()


def stable_rank(rem, decreasing):
    """Each member's stable rank by remainder, ties in member order, as
    count comparisons (one thread per member in the kernel)."""
    i = np.arange(rem.size)
    ahead = rem[None, :] > rem[:, None] if decreasing else rem[None, :] < rem[:, None]
    return (ahead | ((rem[None, :] == rem[:, None]) & (i[None, :] < i[:, None]))).sum(1)


def round_robin(cnt, n_slots):
    """The kernel's round-robin on integer keys credit << 10 | 1023 - member,
    one max a step: returns (calendar, largest |credit|). Asserts the credit
    bound the keys rely on, and the contract the kernel checks in place of
    the quota walk: every member is picked exactly its count."""
    m = cnt.size
    assert cnt.min() >= 1 and cnt.sum() == n_slots
    key = (1 << KEY_SHIFT) - 1 - np.arange(m, dtype=np.int64)  # credit 0
    cal = np.empty(n_slots, np.int64)
    worst = 0
    for sl in range(n_slots):
        key += cnt << KEY_SHIFT
        top = int(key.max())
        credit = top >> KEY_SHIFT  # the largest credit; the smallest is above -n_slots
        assert 1 <= credit <= m * n_slots
        cal[sl] = (1 << KEY_SHIFT) - 1 - (top & ((1 << KEY_SHIFT) - 1))
        key[key == top] -= n_slots << KEY_SHIFT
        low = int(key.min()) >> KEY_SHIFT
        assert low > -n_slots
        worst = max(worst, credit, -low)
    assert worst < 1 << (31 - KEY_SHIFT)  # so a key fits an int32
    # every credit stayed above -n_slots, so after n_slots steps each member
    # has at most (so, the counts summing to n_slots, exactly) its count
    assert np.array_equal(np.bincount(cal, minlength=m), cnt)
    return cal, worst


def kernel_model(w, n_slots):
    """The kernel's design in numpy: returns (calendar, largest |credit|,
    surplus steps). Each identity is the kernel's: an integer surplus key,
    the early end of the surplus loop, the deficit in closed form, integer
    round-robin keys (one max a step) and no quota walk (the round-robin
    meets every quota)."""
    m = w.size
    ideal = w / np_sum(w, m) * n_slots
    fl = np.floor(ideal)
    cnt = np.maximum(fl.astype(np.int64), 1)
    rem = ideal - fl
    total = int(cnt.sum())
    steps = max(total - n_slots, 0)
    if total > n_slots:  # surplus: key -(r << 10 | rank among those above 1)
        above = np.flatnonzero(cnt > 1)
        key = -stable_rank(rem[above], decreasing=False)
        c = cnt[above].copy()
        for _ in range(steps):  # ends once the counts reach n_slots
            k = int(np.argmax(key))
            assert (key == key[k]).sum() == 1
            c[k] -= 1
            key[k] = key[k] - (1 << KEY_SHIFT) if c[k] > 1 else np.iinfo(np.int64).min
        cnt[above] = c
    elif total < n_slots:  # deficit in closed form
        cnt = cnt + (stable_rank(rem, decreasing=True) < min(m, n_slots - total))
    cal, worst = round_robin(cnt, n_slots)
    return cal.astype(np.int32), worst, steps


# (members, slots) with M <= n_slots: one warp's edge (33), numpy's 128-lane
# block (129), the kernel's 512
SHAPES = [(m, n) for n in (100, 512) for m in (1, 5, 16, 33, 100, 129, 256, 511, 512)
          if m <= n]


@pytest.mark.parametrize("m,n_slots", SHAPES)
@pytest.mark.parametrize("kind", ["random", "ties", "dominant", "surplus", "equal"])
def test_plain_calendar_equals_host_calendar_past_one_warp(kind, m, n_slots):
    w = weights(m, kind, m * 7 + n_slots)
    np.testing.assert_array_equal(plain(w, n_slots),
                                  host_calendar(np.arange(m, dtype=np.int32), w, n_slots))


@pytest.mark.parametrize("m,n_slots", SHAPES)
def test_plain_calendar_equals_jax_package_calendar(m, n_slots):
    """Random uniform weights: no remainder tie straddles the quota cut, so
    the reference's unstable argsort picks as the stable one does."""
    w = weights(m, "random", m * 11 + n_slots)
    np.testing.assert_array_equal(
        plain(w, n_slots), jax_package_calendar(np.arange(m, dtype=np.int32), w, n_slots))


# (m, n_slots, kind, seed) with 1 <= m <= n_slots: m is drawn over [1, 512]
# and folded into [1, n_slots] (the front end has no dependent draws)
CALENDARS = st.tuples(
    st.sampled_from([1, 2, 31, 100, 256, 511, 512, 512]), st.integers(1, 512),
    st.sampled_from(KINDS), st.integers(0, 2**31),
).map(lambda c: (1 + (c[1] - 1) % c[0], c[0], c[2], c[3]))


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(CALENDARS)
def test_kernel_model_equals_plain_calendar(case):
    m, n_slots, kind, seed = case
    w = weights(m, kind, seed)
    got, worst, _ = kernel_model(w, n_slots)
    np.testing.assert_array_equal(got, plain(w, n_slots))
    assert worst <= m * n_slots


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(st.integers(1, 512), st.integers(0, 512), st.integers(0, 2**31))
def test_round_robin_meets_any_quotas(m, extra, seed):
    """The contract the kernel traps on, past the counts that weights give:
    for any counts >= 1 summing to n_slots <= 512, the round-robin picks
    each member exactly its count, so the host calendar's sequential walk
    (``core.calendar._enforce_quotas``) moves no slot."""
    n_slots = min(m + extra, 512)
    m = min(m, n_slots)
    rng = np.random.default_rng(seed)
    cnt = 1 + rng.multinomial(n_slots - m, rng.dirichlet(np.full(m, 0.5)))
    cal, _ = round_robin(cnt, n_slots)
    np.testing.assert_array_equal(
        _enforce_quotas(cal.astype(np.int32), np.arange(m, dtype=np.int32), cnt), cal)


@pytest.mark.parametrize("m,kind", [(512, "surplus"), (363, "surplus"), (512, "random"),
                                    (300, "ties"), (16, "ties")])
def test_kernel_model_long_surplus_loops(m, kind):
    """The surplus loop's longest runs (one dominant member over hundreds of
    members raised to one slot) against the plain version."""
    w = weights(m, kind, m)
    got, _, steps = kernel_model(w, 512)
    np.testing.assert_array_equal(got, plain(w, 512))
    if kind == "surplus":
        assert steps > m // 2


@pytest.mark.parametrize("m,n_slots", [(0, 512), (101, 100), (513, 513), (513, 512), (4, 513)])
def test_wrapper_refuses_what_the_kernel_does_not_take(m, n_slots):
    """M = 0, more members than slots, and M or n_slots past 512 are
    refused on the CPU as on the card."""
    assert MAX_MEMBERS == MAX_SLOTS == 512
    with pytest.raises(ValueError):
        build_calendar(torch.ones(m, dtype=torch.float64), torch.tensor([True]),
                       torch.zeros(n_slots, dtype=torch.int32))


def test_wrapper_takes_512_members_on_the_cpu():
    w = weights(512, "log-uniform", 3)
    out = build_calendar(torch.from_numpy(w), torch.tensor([True]),
                         torch.full((512,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), host_calendar(np.arange(512, dtype=np.int32),
                                                             w, 512))
    assert sorted(set(out.tolist())) == list(range(512))
