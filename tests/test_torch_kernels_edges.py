"""The plain versions that the CUDA kernels are held against on the card,
against the Pallas kernels in interpret mode (and ``repro.kernels.ref``) on
the boundary cases of the kernels' designs: ``dispatch_plan`` across its
4096-packet tiles, at 1024 members, past them (the kernel's chunks of 1024
members, up to 16,384) and with every packet to one member; ``lb_route``
with events on the epoch search's edges (segment starts, 2^32 boundaries,
the top of the u64 space), out-of-range instance ids and segments in any
order, single and stacked, and at the table sizes on both sides of the
kernel's two designs (shared memory, device memory). All exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.dispatch as j_dispatch
import repro.kernels.lb_route as j_lb
import repro.kernels.ref as j_ref
from repro.core.instance import VirtualLoadBalancer
from repro.core.tables import stack_tables as j_stack_tables
from repro_torch.core.tables import stack_tables
from repro_torch.kernels.dispatch import dispatch_plan
from repro_torch.kernels.lb_route import lb_route
from torch_helpers import (EDGE_BOUNDARIES, LB_TABLE_SHAPES, edge_headers, jax_tables_np,
                           port_tables, program, seg_starts, spread_program, to_np)


def _assert_all_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w).astype(to_np(g).dtype))


def _check_plan(member, m):
    got = dispatch_plan(torch.from_numpy(member), n_members=m)
    _assert_all_equal(
        got, j_dispatch.dispatch_plan(jnp.asarray(member), n_members=m, interpret=True),
        j_ref.dispatch_plan_ref(jnp.asarray(member), n_members=m))
    return got


class TestDispatchPlanTileEdges:
    @pytest.mark.parametrize("n", [4095, 4097, 8193])
    def test_around_the_tile(self, n):
        member = np.random.default_rng(n).integers(-2, 515, n).astype(np.int32)
        _check_plan(member, 512)

    def test_members_up_to_1023(self):
        member = np.random.default_rng(3).integers(-1, 1026, 5000).astype(np.int32)
        member[:4] = [1023, 0, 1024, 1023]
        pos, counts = _check_plan(member, 1024)
        assert int(counts[1023]) == int((member == 1023).sum())

    @pytest.mark.parametrize("m_one", [0, 511])
    def test_one_member_skew(self, m_one):
        member = np.full(8193, m_one, np.int32)
        pos, counts = _check_plan(member, 512)
        assert to_np(pos).tolist() == list(range(8193))
        assert int(counts[m_one]) == 8193 and int(counts.sum()) == 8193


class TestDispatchPlanMemberChunks:
    """Past the kernel's chunk of 1024 members (the card runs one grid row
    per chunk)."""

    @pytest.mark.parametrize("m", [1025, 2048, 4096, 16_384])
    def test_members_past_one_chunk(self, m):
        rng = np.random.default_rng(m)
        member = rng.integers(-2, m + 3, 4500).astype(np.int32)
        member[:6] = [1023, 1024, m - 1, m, 1024, 0]
        pos, counts = _check_plan(member, m)
        assert int(counts[1024]) == int((member == 1024).sum()) >= 2

    @pytest.mark.parametrize("m_one", [1023, 1024, 2047])
    def test_one_member_skew_at_chunk_edges(self, m_one):
        member = np.full(4097, m_one, np.int32)
        pos, counts = _check_plan(member, 2048)
        assert to_np(pos).tolist() == list(range(4097))
        assert int(counts[m_one]) == 4097 and int(counts.sum()) == 4097


def _edge_tables(stacked):
    """JAX tables with epoch switches on 2^32 boundaries (one instance, or
    four with 1-4 switches each), and the u64 starts of all instances."""
    if not stacked:
        jt = program(jcore, boundaries=EDGE_BOUNDARIES, switches=4).device_tables()
        return jt, seg_starts(jt.seg_start_hi, jt.seg_start_lo)
    vlb = VirtualLoadBalancer(max_members=32)
    for i in range(len(vlb.instances)):
        vlb.instances[i] = program(jcore, seed=i, switches=1 + i, boundaries=EDGE_BOUNDARIES)
    jt = vlb.device_tables()
    return jt, seg_starts(jt.seg_start_hi, jt.seg_start_lo)


def _shuffled(jt, seed):
    """The same tables with each instance's segment entries (start and row
    together) in a random order."""
    f = jax_tables_np(jt)
    rng = np.random.default_rng(seed)
    for k in ("seg_start_hi", "seg_start_lo", "seg_row"):
        f[k] = f[k].copy()
    lead = f["seg_row"].reshape(-1, f["seg_row"].shape[-1])
    for i in range(lead.shape[0]):
        perm = rng.permutation(lead.shape[1])
        for k in ("seg_start_hi", "seg_start_lo", "seg_row"):
            a = f[k].reshape(-1, f[k].shape[-1])
            a[i] = a[i][perm]
    return dataclasses.replace(jt, **{k: jnp.asarray(v) for k, v in f.items()})


def _port(jt, stacked):
    if not stacked:
        return port_tables(jt)
    n_inst = jt.seg_row.shape[0]
    return stack_tables([port_tables(dataclasses.replace(
        jt, **{k: v[i] for k, v in jax_tables_np(jt).items()})) for i in range(n_inst)])


class TestLBRouteEventEdges:
    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("stacked", [False, True])
    def test_edges_equal_pallas(self, stacked, shuffle):
        jt, starts = _edge_tables(stacked)
        if shuffle:
            jt = _shuffled(jt, seed=5)
        h = edge_headers(starts, 3001, seed=int(stacked))
        args_j = [jnp.asarray(h), jt]
        iid_t = None
        if stacked:  # ids below 0 and past the last instance are clipped
            iid = np.random.default_rng(2).integers(-3, 7, len(h)).astype(np.int32)
            args_j.append(jnp.asarray(iid))
            iid_t = torch.from_numpy(iid)
        got = lb_route(torch.from_numpy(h.view(np.int32)), _port(jt, stacked), iid_t)
        _assert_all_equal(got, j_lb.lb_route(*args_j, interpret=True),
                          j_ref.lb_route_ref(*args_j))
        assert 0 < int(got[3].sum()) < len(h)


class TestLBRouteTableSizes:
    """The largest stacked and single tables that fit a block's shared
    memory, one member slot past each, farm_1k's 4 x 4096, the fabric's
    14 x 64 and 16 x 64: live members on slots spread over the whole table."""

    @pytest.mark.parametrize("n_inst,max_members", LB_TABLE_SHAPES)
    def test_table_sizes_equal_pallas(self, n_inst, max_members):
        ems = [spread_program(jcore, max_members, n_live=min(max_members, 256), seed=i,
                              switches=1 + i % 3) for i in range(n_inst)]
        if n_inst == 1:
            jt = ems[0].device_tables()
        else:
            jt = j_stack_tables([em.device_tables() for em in ems])
        first = (jt.seg_start_hi[0], jt.seg_start_lo[0]) if n_inst > 1 else (
            jt.seg_start_hi, jt.seg_start_lo)
        h = edge_headers(seg_starts(*first), 2001, seed=max_members)
        args_j = [jnp.asarray(h), jt]
        iid_t = None
        if n_inst > 1:
            iid = np.random.default_rng(n_inst).integers(-1, n_inst + 1, len(h)).astype(np.int32)
            args_j.append(jnp.asarray(iid))
            iid_t = torch.from_numpy(iid)
        got = lb_route(torch.from_numpy(h.view(np.int32)), _port(jt, n_inst > 1), iid_t)
        _assert_all_equal(got, j_lb.lb_route(*args_j, interpret=True),
                          j_ref.lb_route_ref(*args_j))
        assert 0 < int(got[3].sum()) < len(h)
