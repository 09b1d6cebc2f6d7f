"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core.dataplane import DataPlane
from repro_torch.core.protocol import encode_headers, words_to_tensor
from repro_torch.data.reassembly import reassembly_plan
from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import dispatch_plan
from repro_torch.kernels.lb_route import lb_route
from repro_torch.kernels.reassembly import seg_masks

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _managers(n):
    rng = np.random.default_rng(0)
    ems = []
    for i in range(n):
        em = tcore.EpochManager(max_members=64)
        em.initialize({m: tcore.MemberSpec(node_id=m, base_lane=8 * m, lane_bits=m % 3)
                       for m in range(20)}, {m: float(rng.uniform(0.5, 2)) for m in range(20)})
        em.reconfigure({m: tcore.MemberSpec(node_id=m) for m in range(5, 30)},
                       {m: 1.0 for m in range(5, 30)}, boundary_event=(1 << 40) + i)
        ems.append(em)
    return ems


def _headers(n):
    rng = np.random.default_rng(n)
    h = encode_headers(rng.integers(0, 1 << 41, n).astype(np.uint64),
                       rng.integers(0, 1 << 16, n).astype(np.uint32))
    h[::17, 0] ^= np.uint32(0x1_0000)
    return h


@pytest.mark.parametrize("n", [1, 255, 257, 70_000])
@pytest.mark.parametrize("stacked", [False, True])
def test_lb_route_equals_plain(n, stacked):
    ems = _managers(4 if stacked else 1)
    make = (DataPlane.from_instances if stacked
            else lambda e, device: DataPlane.from_manager(e[0], device))
    gpu, cpu = make(ems, device="cuda"), make(ems, device="cpu")
    h = _headers(n)
    iid = (np.random.default_rng(1).integers(0, 4, n).astype(np.int32) if stacked else None)
    args = lambda dev: (words_to_tensor(h, dev), gpu.tables if dev == "cuda" else cpu.tables,
                        None if iid is None else torch.from_numpy(iid).to(dev))
    before = _lib.LAUNCHES["lb_route"]
    got = lb_route(*args("cuda"))
    assert _lib.LAUNCHES["lb_route"] == before + 1
    for g, w in zip(got, lb_route(*args("cpu"))):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,m", [(1, 1), (33, 4), (4097, 512), (300_000, 64)])
def test_dispatch_plan_equals_plain(n, m):
    member = torch.from_numpy(np.random.default_rng(n).integers(-2, m + 3, n).astype(np.int32))
    got = dispatch_plan(member.cuda(), n_members=m)
    for g, w in zip(got, dispatch_plan(member, n_members=m)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_seg_masks_and_plan_equal_plain(n):
    rng = np.random.default_rng(n)
    cols = [torch.from_numpy(x.astype(np.int64)) for x in (
        rng.integers(0, 3, n), rng.integers(0, max(n // 4, 1), n),
        rng.integers(0, 2, n), rng.integers(0, 3, n), rng.integers(1, 4, n))]
    valid = torch.from_numpy(rng.random(n) > 0.1)
    want = reassembly_plan(*cols, valid)
    got = reassembly_plan(*(c.cuda() for c in cols), valid.cuda())
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    c32 = [c.to(torch.int32) for c in cols[:4]]
    for g, w in zip(seg_masks(valid.int().cuda(), *(c.cuda() for c in c32)),
                    seg_masks(valid.int(), *c32)):
        assert torch.equal(g.cpu(), w)


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = DataPlane.from_manager(_managers(1)[0], device="cuda").tables
    h = words_to_tensor(_headers(8), "cuda")
    with pytest.raises(TypeError):
        lb_route(h.long(), t)
    with pytest.raises(ValueError):
        lb_route(h[:, :3], t)
    with pytest.raises(ValueError):
        dispatch_plan(torch.zeros(4, dtype=torch.int32, device="cuda"), n_members=5000)
