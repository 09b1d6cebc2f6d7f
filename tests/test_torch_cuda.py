"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core.dataplane import DataPlane
from repro_torch.core.protocol import encode_headers, words_to_tensor
from repro_torch.core.tables import device_tables_from_numpy, stack_tables
from repro_torch.data.reassembly import reassembly_plan
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import dispatch_plan
from repro_torch.kernels.flash_attention import _design, flash_attention
from repro_torch.kernels.lb_route import lb_route
from repro_torch.kernels.reassembly import seg_masks
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import model as M
from torch_helpers import EDGE_BOUNDARIES, edge_headers, program, seg_starts

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


def _plan_equal(member_cpu, m, got=None):
    if got is None:
        got = dispatch_plan(member_cpu.cuda(), n_members=m)
    for g, w in zip(got, dispatch_plan(member_cpu, n_members=m)):
        assert torch.equal(g.cpu(), w)


# around the 4096-packet tile and at 2^20 + 3 (256 full tiles and a ragged
# one: the look-back walks 256 predecessors), at 1, 512 and 1024 members
@pytest.mark.parametrize("m", [1, 512, 1024])
@pytest.mark.parametrize("n", [4095, 4096, 4097, (1 << 20) + 3])
def test_dispatch_plan_tiles_equal_plain(n, m):
    rng = np.random.default_rng(n + m)
    _plan_equal(torch.from_numpy(rng.integers(-2, m + 3, n).astype(np.int32)), m)


@pytest.mark.parametrize("n", [4097, (1 << 20) + 3])
def test_dispatch_plan_one_member_skew(n):
    """Every packet to member 511: the inclusive prefix reaches n."""
    member = torch.full((n,), 511, dtype=torch.int32)
    pos, counts = dispatch_plan(member.cuda(), n_members=512)
    assert torch.equal(pos.cpu(), torch.arange(n, dtype=torch.int32))
    assert int(counts[511]) == n and int(counts.sum()) == n
    _plan_equal(member, 512, (pos, counts))


def test_dispatch_plan_successive_calls():
    """Two calls in a row with different inputs: nothing of the first
    call's flags or tile counter leaks into the second."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-1, 70, 300_000).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 64, 300_000).astype(np.int32))
    got_a = dispatch_plan(a.cuda(), n_members=64)
    got_b = dispatch_plan(b.cuda(), n_members=64)
    _plan_equal(a, 64, got_a)
    _plan_equal(b, 64, got_b)


def test_dispatch_plan_graph_replays_equal_plain():
    """One call captured in a CUDA graph and replayed 5 times, each on new
    members copied into the captured input: every replay equals plain (a
    flag or tile counter not cleared on the stream would fail here)."""
    n, m = (1 << 18) + 5, 512
    rng = np.random.default_rng(21)
    static = torch.from_numpy(rng.integers(-1, m + 2, n).astype(np.int32)).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dispatch_plan(static, n_members=m)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dispatch_plan(static, n_members=m)
    for r in range(5):
        new = torch.from_numpy(rng.integers(-1, m + 2 - 3 * r, n).astype(np.int32))
        static.copy_(new)
        g.replay()
        torch.cuda.synchronize()
        _plan_equal(new, m, out)


def _edge_dataplanes(stacked):
    if stacked:
        ems = [program(tcore, max_members=64, seed=i, switches=1 + i,
                       boundaries=EDGE_BOUNDARIES) for i in range(4)]
        return (DataPlane.from_instances(ems, device="cuda"),
                DataPlane.from_instances(ems, device="cpu"))
    em = program(tcore, max_members=64, switches=4, boundaries=EDGE_BOUNDARIES)
    return DataPlane.from_manager(em, device="cuda"), DataPlane.from_manager(em, device="cpu")


# N at 1-5 packets (a tail of every length below one 4-packet group), at
# 4k + 3 and at 2^20 + 5 (many groups per thread of the persistent grid);
# events on the epoch search's edges; instance ids below 0 and past 3
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 4 * 1025 + 3, (1 << 20) + 5])
def test_lb_route_edges_equal_plain(n, stacked):
    gpu, cpu = _edge_dataplanes(stacked)
    t = cpu.tables
    h = edge_headers(seg_starts(t.seg_start_hi, t.seg_start_lo), n, seed=n)
    iid = (torch.from_numpy(np.random.default_rng(n).integers(-3, 7, n).astype(np.int32))
           if stacked else None)
    before = _lib.LAUNCHES["lb_route"]
    got = lb_route(words_to_tensor(h, "cuda"), gpu.tables,
                   None if iid is None else iid.cuda())
    assert _lib.LAUNCHES["lb_route"] == before + 1
    for g, w in zip(got, lb_route(words_to_tensor(h, "cpu"), t, iid)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("stacked", [False, True])
def test_lb_route_member_count_not_a_multiple_of_4(stacked):
    """30 member slots: the kernel stages the member table one member at a
    time (its 16-byte staging needs a multiple of 4)."""
    ems = [program(tcore, max_members=30, seed=i, switches=1 + i % 3,
                   boundaries=EDGE_BOUNDARIES) for i in range(4 if stacked else 1)]
    make = DataPlane.from_instances if stacked else (lambda e, device: DataPlane.from_manager(
        e[0], device))
    gpu, cpu = make(ems, device="cuda"), make(ems, device="cpu")
    n = 5003
    h = edge_headers(seg_starts(cpu.tables.seg_start_hi, cpu.tables.seg_start_lo), n, seed=3)
    iid = (torch.from_numpy(np.random.default_rng(5).integers(0, 4, n).astype(np.int32))
           if stacked else None)
    got = lb_route(words_to_tensor(h, "cuda"), gpu.tables, None if iid is None else iid.cuda())
    for g, w in zip(got, lb_route(words_to_tensor(h, "cpu"), cpu.tables, iid)):
        assert torch.equal(g.cpu(), w)


def test_lb_route_unaligned_instance_ids():
    """Instance ids that start off a 16-byte boundary (a view into a larger
    tensor) take the kernel's scalar loads and route the same."""
    gpu, cpu = _edge_dataplanes(True)
    n = 4099
    h = edge_headers(seg_starts(cpu.tables.seg_start_hi, cpu.tables.seg_start_lo), n)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 4, n + 1).astype(np.int32))
    got = lb_route(words_to_tensor(h, "cuda"), gpu.tables, ids.cuda()[1:])
    for g, w in zip(got, lb_route(words_to_tensor(h, "cpu"), cpu.tables, ids[1:])):
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
    # tables a block cannot hold in shared memory (4 x 4096 members: 328 KB)
    big = stack_tables([device_tables_from_numpy(dict(
        {k: v.cpu().numpy() for k, v in t.fields().items()},
        **{k: np.zeros(4096, np.int32) for k in ("member_node", "member_base_lane",
                                                  "member_lane_mask", "member_valid")}),
        "cuda")] * 4)
    with pytest.raises(ValueError, match="shared"):
        lb_route(h, big, torch.zeros(8, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="epoch segments"):  # the kernel takes 16
        lb_route(h, dataclasses.replace(t, seg_start_hi=t.seg_start_hi[:8],
                                        seg_start_lo=t.seg_start_lo[:8],
                                        seg_row=t.seg_row[:8]))


@pytest.fixture
def _full_f32():
    """fp32 references in full fp32 (no TF32) for the duration of a test."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _check_flash(b, t, hq, hkv, d, causal, dtype, atol, rtol, seed):
    """One call of the wrapper against the plain version; the launch counts
    show which design ran (wgmma for bf16 at d = 64 or 128, else mma)."""
    rng = np.random.default_rng(seed)
    mk = lambda h: (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                    .to("cuda", dtype))
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    before = dict(_lib.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert _design(dtype, d) == ("wgmma" if wgmma else "mma")
    assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (_lib.LAUNCHES["flash_attention_wgmma"]
            == before["flash_attention_wgmma"] + int(wgmma))
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# bf16: both kernels round P to bf16 before the PV product, ~4e-3 of error at
# most in the first causal rows (few keys); atol 5e-3 stays far under what a
# kernel letting padded keys into a non-causal softmax reads at small T
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 5e-3, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (32, 4), (32, 2), (48, 1)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("t", [1, 7, 64, 130, 1000])
def test_flash_attention_equals_plain(t, d, hq, hkv, causal, dtype, atol, rtol, _full_f32):
    _check_flash(2, t, hq, hkv, d, causal, dtype, atol, rtol, t * 1000 + d + hq)


# the wgmma design's edges: one 128-row tile exactly, one row short and one
# over; the Yi-6B prefill length; and B=2 at a ragged T, where a tensor map
# that is not bounded per batch would read batch 1's rows into batch 0's last
# tile. Heads: Yi-6B 32/4, ChatGLM3-6B 32/2, Granite-20B 48/1 (MQA)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(32, 4), (32, 2), (48, 1)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,t", [(1, 127), (1, 128), (1, 129), (1, 4096), (2, 1000)])
def test_flash_attention_wgmma_edges_equal_plain(b, t, d, hq, hkv, causal):
    _check_flash(b, t, hq, hkv, d, causal, torch.bfloat16, 5e-3, 2e-2, b * 7919 + t + d + hq)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16, device="cuda")
    with pytest.raises(ValueError):  # no instance for d = 24
        z = torch.zeros(1, 8, 4, 24, device="cuda")
        flash_attention(z, z, z)
    with pytest.raises(TypeError):  # mixed dtypes
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(TypeError):  # no fp16 instance
        flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("arch", ["yi_6b", "stablelm_3b"])
def test_smoke_prefill_on_the_card_equals_the_cpu(arch, _full_f32):
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 11)))
    out = {}
    for dev in ("cpu", "cuda"):
        st = M.init_decode_state(cfg, 2, 32, device=dev)
        logits, st = M.prefill(M.to_device(params, dev), {"tokens": toks.to(dev)}, st, cfg)
        logits2, _ = M.decode_step(M.to_device(params, dev), toks[:, 0].to(dev), st, cfg)
        out[dev] = (logits.cpu(), logits2.cpu())
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
