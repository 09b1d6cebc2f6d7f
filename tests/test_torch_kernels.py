"""Port kernels vs the JAX package: for each kernel on the slice's path, the
port's wrapper on CPU tensors (its plain PyTorch version) against the Pallas
kernel in interpret mode and against ``repro.kernels.ref``, exactly equal.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.dispatch as j_dispatch
import repro.kernels.lb_route as j_lb
import repro.kernels.reassembly as j_reasm
import repro.kernels.ref as j_ref
from repro.core.instance import VirtualLoadBalancer
from repro_torch.core.tables import stack_tables
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.dispatch import dispatch_plan
from repro_torch.kernels.lb_route import lb_route
from repro_torch.kernels.reassembly import seg_masks
from torch_helpers import headers, port_tables, program, to_np


def _words(h):
    return torch.from_numpy(h.view(np.int32))


def _assert_all_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w).astype(to_np(g).dtype))


class TestLBRoute:
    @pytest.mark.parametrize("n", [1, 7, 2048, 5000])
    def test_single_instance(self, n):
        jt = program(jcore, seed=n).device_tables()
        h = headers(n, seed=n, corrupt_every=13, spread=1 << 41)
        got = lb_route(_words(h), port_tables(jt))
        _assert_all_equal(got, j_lb.lb_route(jnp.asarray(h), jt, interpret=True),
                          j_ref.lb_route_ref(jnp.asarray(h), jt))
        assert all(g.dtype == torch.int32 for g in got)

    @pytest.mark.parametrize("n", [1, 7, 2048, 5000])
    def test_four_instances(self, n):
        vlb = VirtualLoadBalancer(max_members=32)
        for i, em in enumerate(vlb.instances):
            vlb.instances[i] = program(jcore, seed=10 * n + i, switches=i % 3)
        jt = vlb.device_tables()
        h = headers(n, seed=n + 1, corrupt_every=11, spread=1 << 41)
        iid = np.random.default_rng(n).integers(-1, 5, n).astype(np.int32)  # clipped
        got = lb_route(_words(h), stack_tables(
            [port_tables(em.device_tables()) for em in vlb.instances]),
            torch.from_numpy(iid))
        _assert_all_equal(
            got, j_lb.lb_route(jnp.asarray(h), jt, jnp.asarray(iid), interpret=True),
            j_ref.lb_route_ref(jnp.asarray(h), jt, jnp.asarray(iid)))

    def test_corrupt_headers_never_route(self):
        jt = program(jcore).device_tables()
        h = headers(610, corrupt_every=61)
        member, node, lane, valid = lb_route(_words(h), port_tables(jt))
        bad = np.zeros(610, bool)
        bad[::61] = bad[1::61] = True
        assert not to_np(valid)[bad].any()
        assert (to_np(member)[bad] == -1).all() and (to_np(lane)[bad] == -1).all()

    def test_instance_id_rules(self):
        t = port_tables(program(jcore).device_tables())
        h = _words(headers(4))
        with pytest.raises(ValueError):
            lb_route(h, t, torch.zeros(4, dtype=torch.int32))
        with pytest.raises(ValueError):
            lb_route(h, stack_tables([t, t]))


class TestDispatchPlan:
    @pytest.mark.parametrize("n,m", [(1, 4), (7, 3), (1500, 8), (3000, 64)])
    def test_matches_pallas_and_ref(self, n, m):
        rng = np.random.default_rng(n)
        member = rng.integers(-1, m + 3, n).astype(np.int32)  # -1 and >= n_members
        got = dispatch_plan(torch.from_numpy(member), n_members=m)
        _assert_all_equal(
            got, j_dispatch.dispatch_plan(jnp.asarray(member), n_members=m, interpret=True),
            j_ref.dispatch_plan_ref(jnp.asarray(member), n_members=m))

    def test_edge_members(self):
        member = torch.tensor([2, -1, 9, 2, 3, -7, 2, 4], dtype=torch.int32)
        pos, counts = dispatch_plan(member, n_members=4)
        assert pos.tolist() == [0, -1, 0, 1, 0, -1, 2, 0]
        assert counts.tolist() == [0, 0, 3, 1]


class TestSegMasks:
    @pytest.mark.parametrize("n", [1, 9, 1024, 3000])
    def test_matches_pallas_and_ref(self, n):
        rng = np.random.default_rng(n)
        ev = np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.uint64) << np.uint64(20)
        hi, lo = jcore.split64(ev)
        daq = rng.integers(0, 2, n).astype(np.int32)
        seg = rng.integers(0, 3, n).astype(np.int32)
        valid = (rng.random(n) > 0.1).astype(np.int32)
        cols_t = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
                  for x in (valid, hi, lo, daq, seg)]
        cols_j = [jnp.asarray(x) for x in (valid.astype(np.uint32), hi, lo, daq, seg)]
        got = seg_masks(*cols_t)
        _assert_all_equal(got, j_reasm.seg_masks(*cols_j, interpret=True),
                          j_ref.seg_masks_ref(*cols_j))


class TestPlainVersionsAreTheCPUPath:
    def test_wrappers_take_ref_on_cpu(self):
        member = torch.tensor([0, 1, 0], dtype=torch.int32)
        assert [x.tolist() for x in dispatch_plan(member, n_members=2)] == \
            [x.tolist() for x in t_ref.dispatch_plan_ref(member, n_members=2)]
