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
from repro_torch.kernels.flash_attention import _design as _flash_design
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lb_route import _design, lb_route, smem_bytes
from repro_torch.kernels.reassembly import seg_masks
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import model as M
from repro_torch.core.protocol import CALENDAR_SLOTS
from repro_torch.core.tables import MAX_EPOCH_ROWS
from torch_helpers import (CALENDAR_KINDS, EDGE_BOUNDARIES, FARM_RING_EDGES,
                           LB_TABLE_SHAPES, SCAN_RING_SIZES, calendar_weights, edge_headers,
                           program, seg_starts, serve_case, signed_sum_input, spread_program)

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


def _wide_dataplanes(n_inst, max_members):
    ems = [spread_program(tcore, max_members, n_live=min(max_members, 256), seed=i,
                          switches=1 + i % 3) for i in range(n_inst)]
    if n_inst == 1:
        return (DataPlane.from_manager(ems[0], device="cuda"),
                DataPlane.from_manager(ems[0], device="cpu"))
    return (DataPlane.from_instances(ems, device="cuda"),
            DataPlane.from_instances(ems, device="cpu"))


def _route_equal(gpu, cpu, n, seed):
    t = cpu.tables
    stacked = t.seg_row.ndim == 2
    h = edge_headers(seg_starts(t.seg_start_hi[0] if stacked else t.seg_start_hi,
                                t.seg_start_lo[0] if stacked else t.seg_start_lo), n, seed=seed)
    n_inst = t.seg_row.shape[0] if stacked else 1
    iid = (torch.from_numpy(np.random.default_rng(seed).integers(-1, n_inst + 1, n)
                            .astype(np.int32)) if stacked else None)
    got = lb_route(words_to_tensor(h, "cuda"), gpu.tables, None if iid is None else iid.cuda())
    for g, w in zip(got, lb_route(words_to_tensor(h, "cpu"), t, iid)):
        assert torch.equal(g.cpu(), w)


# the largest tables that fit a block's shared memory and one member slot
# past them, farm_1k (4 x 4096), the fabric at K = 7 and 8 LBs (2K x 64):
# the "global" design above the limit, counted under its own name too
@pytest.mark.parametrize("n_inst,max_members", LB_TABLE_SHAPES)
def test_lb_route_table_sizes_equal_plain(n_inst, max_members):
    gpu, cpu = _wide_dataplanes(n_inst, max_members)
    design = _design(n_inst, MAX_EPOCH_ROWS, max_members)
    lib = _lib.lib()
    for d in ("shared", "global"):  # the wrapper's formula is the kernel's
        assert smem_bytes(d, n_inst, MAX_EPOCH_ROWS, max_members) == lib.ejfat_lb_route_smem_bytes(
            ("shared", "global").index(d), n_inst, MAX_EPOCH_ROWS, CALENDAR_SLOTS, max_members)
    for n in (5, 4 * 1025 + 3, (1 << 20) + 5):
        before = dict(_lib.LAUNCHES)
        _route_equal(gpu, cpu, n, seed=n + max_members)
        assert _lib.LAUNCHES["lb_route"] == before["lb_route"] + 1
        assert (_lib.LAUNCHES["lb_route_global"]
                == before["lb_route_global"] + int(design == "global"))


def test_lb_route_farm_1k_zero_member_fields_equal_plain():
    """farm_1k's shape with every member field zero (no member valid): every
    packet is refused, as by the plain version."""
    t = DataPlane.from_manager(_managers(1)[0], device="cpu").tables
    fields = dict({k: v.numpy() for k, v in t.fields().items()},
                  **{k: np.zeros(4096, np.int32) for k in ("member_node", "member_base_lane",
                                                            "member_lane_mask", "member_valid")})
    big = lambda dev: stack_tables([device_tables_from_numpy(fields, dev)] * 4)
    h = words_to_tensor(_headers(70_000), "cuda")
    iid = torch.from_numpy(np.random.default_rng(3).integers(0, 4, 70_000)
                           .astype(np.int32)).cuda()
    got = lb_route(h, big("cuda"), iid)
    want = lb_route(h.cpu(), big("cpu"), iid.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[3].sum()) == 0


@pytest.mark.parametrize("n_inst,max_members", [(4, 2595), (4, 4096), (16, 64)])
def test_lb_route_graph_replays_equal_plain(n_inst, max_members):
    """One call captured in a CUDA graph (first call, the opt-in, on a side
    stream before capture) and replayed on new headers: both designs."""
    gpu, cpu = _wide_dataplanes(n_inst, max_members)
    n = (1 << 18) + 3
    starts = seg_starts(cpu.tables.seg_start_hi[0], cpu.tables.seg_start_lo[0])
    rng = np.random.default_rng(max_members)
    iid = torch.from_numpy(rng.integers(0, n_inst, n).astype(np.int32)).cuda()
    static = words_to_tensor(edge_headers(starts, n, seed=0), "cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lb_route(static, gpu.tables, iid)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lb_route(static, gpu.tables, iid)
    for r in range(3):
        h = words_to_tensor(edge_headers(starts, n, seed=r + 1), "cpu")
        static.copy_(h)
        g.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, lb_route(h, cpu.tables, iid.cpu())):
            assert torch.equal(got.cpu(), want)


# past one chunk of 1024 members: the grid's second dimension
@pytest.mark.parametrize("m", [1025, 2048, 4096, 16_384])
@pytest.mark.parametrize("n", [4097, (1 << 20) + 3])
def test_dispatch_plan_member_chunks_equal_plain(n, m):
    rng = np.random.default_rng(n + m)
    _plan_equal(torch.from_numpy(rng.integers(-2, m + 3, n).astype(np.int32)), m)


@pytest.mark.parametrize("member", [1023, 1024, 16_383])
def test_dispatch_plan_member_chunks_one_member_skew(member):
    n = (1 << 20) + 3
    m = 16_384
    pos, counts = dispatch_plan(torch.full((n,), member, dtype=torch.int32, device="cuda"),
                                n_members=m)
    assert torch.equal(pos.cpu(), torch.arange(n, dtype=torch.int32))
    assert int(counts[member]) == n and int(counts.sum()) == n


@pytest.mark.parametrize("m", [2048, 16_384])
def test_dispatch_plan_member_chunks_graph_replays_equal_plain(m):
    n = (1 << 18) + 5
    rng = np.random.default_rng(m)
    static = torch.from_numpy(rng.integers(-1, m + 2, n).astype(np.int32)).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dispatch_plan(static, n_members=m)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dispatch_plan(static, n_members=m)
    for r in range(4):
        new = torch.from_numpy(rng.integers(-1, m + 2 - 7 * r, n).astype(np.int32))
        static.copy_(new)
        g.replay()
        torch.cuda.synchronize()
        _plan_equal(new, m, out)


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
    with pytest.raises(ValueError):  # the reference refuses it too
        dispatch_plan(torch.zeros(4, dtype=torch.int32, device="cuda"), n_members=0)
    with pytest.raises(ValueError, match="epoch segments"):  # the kernel takes 16
        lb_route(h, dataclasses.replace(t, seg_start_hi=t.seg_start_hi[:8],
                                        seg_start_lo=t.seg_start_lo[:8],
                                        seg_row=t.seg_row[:8]))
    from repro_torch.kernels.calendar import build_calendar

    flag = torch.tensor([True], device="cuda")
    for m, n_slots in ((0, 512), (101, 100), (513, 513), (513, 512), (4, 513)):
        with pytest.raises(ValueError):  # M = 0, M > n_slots, M or n_slots > 512
            build_calendar(torch.ones(m, dtype=torch.float64, device="cuda"), flag,
                           torch.zeros(n_slots, dtype=torch.int32, device="cuda"))


@pytest.fixture
def _full_f32():
    """fp32 references in full fp32 (no TF32) for the duration of a test."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _check_flash(b, t, hq, hkv, d, causal, dtype, atol, rtol, seed):
    """One call of the wrapper against the plain version; the launch counts
    show which design ran (wgmma for bf16 at d = 64, 80 or 128, else mma)."""
    rng = np.random.default_rng(seed)
    mk = lambda h: (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                    .to("cuda", dtype))
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    before = dict(_lib.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16 and d in (64, 80, 128)
    assert _flash_design(dtype, d) == ("wgmma" if wgmma else "mma")
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
# tile. Heads: Yi-6B 32/4, ChatGLM3-6B 32/2, Granite-20B 48/1 (MQA),
# StableLM-3B and Zamba2's shared block 32/32 (MHA); d = 80 is their head dim,
# one wide and one narrow box per tile
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(32, 4), (32, 2), (48, 1), (32, 32)])
@pytest.mark.parametrize("d", [64, 80, 128])
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


@pytest.mark.parametrize("arch", ["yi_6b", "stablelm_3b", "mixtral_8x22b", "arctic_480b"])
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


FAMILY_ARCHS = ["llama_3_2_vision_90b", "hubert_xlarge", "zamba2_2_7b", "rwkv6_7b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_smoke_on_the_card_equals_the_cpu(arch, _full_f32):
    """The vlm, audio, hybrid and ssm smoke configs (fp32, TF32 off): the
    forward's logits on the card equal the CPU's; for the three decoders
    also a prefill (the vlm's with its vision tokens) and 3 decode steps."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.family == "audio":
        batch["embeds"] = torch.from_numpy(rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = M.to_device(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        got = [M.forward(p, b, cfg, remat=False)[0]]
        if cfg.family != "audio":
            st = M.init_decode_state(cfg, 2, 32, device=dev)
            logits, st = M.prefill(p, {**b, "tokens": b["tokens"][:, :10]}, st, cfg)
            got.append(logits)
            for i in range(10, 13):
                logits, st = M.decode_step(p, b["tokens"][:, i], st, cfg)
                got.append(logits)
        out[dev] = [g.cpu() for g in got]
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


# the families' prefill shapes: Zamba2's shared attention (32/32 heads, d = 80)
# and Llama-3.2-Vision's self layers (64/8, d = 128), both on the wgmma design
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", [(32, 32, 80), (64, 8, 128)])
def test_families_flash_attention_at_their_prefill_shape_equals_plain(hq, hkv, d, causal):
    _check_flash(1, 4096, hq, hkv, d, causal, torch.bfloat16, 5e-3, 2e-2, hq * 131 + d)


def test_flash_attention_refuses_autograd_on_the_card():
    """The kernel has no backward: under autograd it raises before any
    launch; under no_grad it launches."""
    q = torch.randn(1, 64, 4, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    before = _lib.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q, q.detach(), q.detach())
    assert _lib.LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        flash_attention(q, q, q)
    assert _lib.LAUNCHES["flash_attention"] == before + 1


def _loss_and_grads(cfg, params, batch):
    from repro_torch.tree import leaves

    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = M.train_loss(params, batch, cfg, remat=True, q_chunk=8, k_chunk=8)
    return loss.detach(), torch.autograd.grad(loss, ps)


def test_train_loss_backward_gives_every_leaf_a_gradient(_full_f32):
    """One backward of the smoke config on the card: every leaf's gradient
    finite and non-zero, no flash_attention launch, and loss and gradients
    within rtol/atol 2e-4 of the CPU's (float32, TF32 off)."""
    cfg = get_smoke_config("yi_6b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)))
    labels = toks.clone()
    labels[1, 5:9] = -1
    out = {}
    before = dict(_lib.LAUNCHES)
    for dev in ("cuda", "cpu"):
        out[dev] = _loss_and_grads(cfg, M.to_device(params, dev),
                                   {"tokens": toks.to(dev), "labels": labels.to(dev)})
    assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"]
    loss, grads = out["cuda"]
    assert torch.isfinite(loss)
    for g, w in zip(grads, out["cpu"][1]):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(loss.cpu(), out["cpu"][0], rtol=2e-4, atol=2e-4)


def test_smoke_trainer_with_lb_ingest_on_the_card_equals_the_cpu(tmp_path, _full_f32):
    """The trainer with LB ingest, from one checkpoint, 3 steps on the card
    and on the CPU: occupancy equal, loss and grad_norm within rtol 2e-4;
    lb_route launched once per step on the card."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("yi_6b")
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=True,
                        q_chunk=8, k_chunk=8)
    st = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    hist = {}
    for dev in ("cuda", "cpu"):
        d = str(tmp_path / dev)
        ckpt.save(d, 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
        tr = Trainer(cfg, tc, TrainerConfig(ckpt_dir=d, device=dev), mesh=Mesh(("data",), (1,)))
        tr.init_or_restore(torch.Generator(device=dev).manual_seed(5))
        before = _lib.LAUNCHES["lb_route"]
        hist[dev] = tr.run(3, batch=8, seq=16)
        if dev == "cuda":
            assert _lib.LAUNCHES["lb_route"] == before + 3
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert a["ingest_occupancy"] == b["ingest_occupancy"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-4)


TRAIN_FAMILY_ARCHS = ["mixtral_8x22b", "arctic_480b", "llama_3_2_vision_90b", "zamba2_2_7b",
                      "rwkv6_7b", "hubert_xlarge"]


@pytest.mark.parametrize("arch", TRAIN_FAMILY_ARCHS)
def test_family_trainer_step_with_lb_ingest_on_the_card_equals_the_cpu(tmp_path, arch,
                                                                       _full_f32):
    """One Trainer step with LB ingest of each non-dense smoke config (the
    vlm fed its vision embeddings), from one checkpoint on the card and on
    the CPU: occupancy equal, loss, grad_norm and lr within rtol/atol 2e-4;
    on the card lb_route launched once and dispatch_plan once for the
    ingest plus twice per MoE layer (forward and remat's recompute)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.testing.batches import with_vision
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(arch)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=True,
                        q_chunk=8, k_chunk=8)
    st = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    hist = {}
    for dev in ("cuda", "cpu"):
        d = str(tmp_path / dev)
        ckpt.save(d, 0, {"params": st["params"], "opt": st["opt"], "step": st["step"]})
        tr = Trainer(cfg, tc, TrainerConfig(ckpt_dir=d, device=dev), mesh=Mesh(("data",), (1,)))
        if cfg.family == "vlm":
            with_vision(tr)
        tr.init_or_restore(torch.Generator(device=dev).manual_seed(5))
        before = dict(_lib.LAUNCHES)
        hist[dev] = tr.run(1, batch=8, seq=16)
        if dev == "cuda":
            moe_layers = cfg.n_layers if cfg.family == "moe" else 0
            assert _lib.LAUNCHES["lb_route"] == before["lb_route"] + 1
            assert _lib.LAUNCHES["dispatch_plan"] == before["dispatch_plan"] + 1 + 2 * moe_layers
            assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"]
    a, b = hist["cuda"][0], hist["cpu"][0]
    assert a["ingest_occupancy"] == b["ingest_occupancy"] > 0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("arch,over", [("yi_6b", {}), ("mixtral_8x22b", {"capacity_factor": 0.5})])
def test_one_rank_nccl_step_equals_the_one_process_step(tmp_path, arch, over):
    """``jit_train_step`` over a one-rank NCCL group (a FileStore under
    tmp_path) against ``make_train_step`` with no group, from one init on
    the card, 2 steps with LB ingest under deterministic algorithms: every
    metric and every param bit for bit; lb_route and dispatch_plan launched
    in the step (and the MoE pack's dispatch_plan per layer)."""
    import os

    import torch.distributed as dist

    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.tree import leaves

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_smoke_config(arch).with_(**over)
    tc = TS.TrainConfig(adamw=O.AdamWConfig(lr=1e-3), remat=True, lb_ingest=True,
                        q_chunk=8, k_chunk=8)
    tables = program(tcore, n_members=4).device_tables("cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy(),
             "headers": encode_headers(rng.integers(0, 1 << 40, 8).astype(np.uint64),
                                       rng.integers(0, 1 << 16, 8).astype(np.uint32))}

    def two_steps(step, mesh_specs=None):
        st = TS.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tc, "cuda")
        if mesh_specs is not None:
            st = TS.shard_state(st, *mesh_specs)
        hist = []
        for _ in range(2):
            st, met = step(st, batch, tables)
            hist.append({k: float(v) for k, v in met.items()})
        return hist, [p.detach().cpu() for p in leaves(st["params"])]

    torch.use_deterministic_algorithms(True)
    try:
        plain = two_steps(TS.make_train_step(cfg, tc, Mesh(("data",), (1,)), 8))
        dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1)
            step = TS.jit_train_step(cfg, tc, mesh, TS.state_shapes(cfg, tc), global_batch=8)
            before = dict(_lib.LAUNCHES)
            got = two_steps(step, (step.specs, mesh))
            assert _lib.LAUNCHES["lb_route"] - before["lb_route"] == 2
            assert _lib.LAUNCHES["dispatch_plan"] - before["dispatch_plan"] >= 2
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    assert got[0] == plain[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], plain[1]))


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x22b", "zamba2_2_7b",
                                  "llama_3_2_vision_90b"])
def test_one_rank_nccl_serve_step_equals_the_one_process_step(tmp_path, arch):
    """``launch.serve_step`` over a one-rank NCCL group (a FileStore under
    tmp_path) on ``make_debug_mesh(1, 1)`` against ``prefill`` and
    ``decode_step`` with no group, on the card: the logits of the prefill
    and of 3 decode steps and every decode-state leaf bit for bit; the
    prefill launches ``flash_attention`` once per self-attention layer."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch import shardspecs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import flat_paths, stack

    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))
             .cuda()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(2, cfg.n_vision_tokens, cfg.d_model,
                                             generator=torch.Generator().manual_seed(1)).cuda()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2)).astype(np.int32)).cuda()

    def run(prefill, decode):
        logits, st = prefill(M.init_decode_state(cfg, 2, 16, "cuda"))
        out = [logits]
        for tok in toks:
            logits, st = decode(tok, st)
            out.append(logits)
        return out, st

    flat = lambda st: {k: stack(v) for k, v in flat_paths(shardspecs._as_tree(st)).items()
                       if v is not None}
    with torch.no_grad():
        plain, plain_state = run(lambda st: M.prefill(params, batch, st, cfg),
                                 lambda tk, st: M.decode_step(params, tk, st, cfg))
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        like = dict(M.init_decode_state(cfg, 2, 16, "cuda"))
        specs = SS.placement(cfg, mesh, params, like)
        mine = shd.shard_tree(params, specs["params"], mesh)
        step = SS.ServeStep(cfg, mesh, specs, global_batch=2)
        before = _lib.LAUNCHES["flash_attention"]
        got, state = run(lambda st: step.prefill(mine, batch, shardspecs.shard_state(
            st, specs["state"], mesh)), lambda tk, st: step.decode(mine, tk, st))
        flash = _lib.LAUNCHES["flash_attention"] - before
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    want = flat(plain_state)
    assert all(torch.equal(v, want[k]) for k, v in flat(state).items())
    if cfg.family == "hybrid":  # the shared block's applications
        n_attn = cfg.n_layers // cfg.attn_every
    elif cfg.family == "vlm":  # the self-attention layers
        n_attn = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    else:
        n_attn = cfg.n_layers
    assert flash == n_attn


# -- the MoE family: the expert pack through dispatch_plan ---------------------

def _moe_members(n_tokens, n_experts, top_k, groups, seed):
    """The pack's members as ``moe.pack_positions`` forms them: k-major
    expert choices per group, offset by ``group * E`` (a skewed router:
    a few experts take most tokens)."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(n_experts, 0.3))
    idx = np.stack([rng.choice(n_experts, top_k, replace=False, p=p)
                    for _ in range(n_tokens)])
    ng = n_tokens // groups
    member_g = idx.reshape(groups, ng, top_k).transpose(0, 2, 1).reshape(groups, -1)
    member_g = member_g + np.arange(groups)[:, None] * n_experts
    return torch.from_numpy(member_g.reshape(-1).astype(np.int32)).cuda()


# (tokens, experts, groups): a Mixtral prefill of 4000 tokens, a decode step
# of 4 lanes, an Arctic prefill over 128 experts, 4 dispatch groups
@pytest.mark.parametrize("n,e,g", [(4000, 8, 1), (4, 8, 1), (4000, 128, 1), (1024, 8, 4)])
def test_dispatch_plan_at_the_moe_shapes_equals_plain(n, e, g):
    from repro_torch.kernels.ref import dispatch_plan_ref

    member = _moe_members(n, e, 2, g, n + e + g)
    before = _lib.LAUNCHES["dispatch_plan"]
    got = dispatch_plan(member, n_members=g * e)
    assert _lib.LAUNCHES["dispatch_plan"] == before + 1
    want = dispatch_plan_ref(member, n_members=g * e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_top_k_keeps_lax_tie_order_on_the_card():
    from repro_torch.models.moe import top_k

    for probs in (torch.full((4096, 8), 0.125), torch.full((7, 128), 1 / 128),
                  torch.tensor([[0.1, 0.3, 0.3, 0.3, 0, 0, 0, 0]])):
        vals, idx = top_k(probs.cuda(), 2)
        cv, ci = top_k(probs, 2)
        assert torch.equal(idx.cpu(), ci) and torch.equal(vals.cpu(), cv)
    assert ci.tolist() == [[1, 2]]


@pytest.mark.parametrize("arch,groups", [("mixtral_8x22b", 1), ("mixtral_8x22b", 4),
                                         ("arctic_480b", 1)])
def test_moe_ffn_with_kernel_positions_equals_plain_positions(arch, groups, monkeypatch,
                                                              _full_f32):
    """One launch of dispatch_plan per call; the output, aux loss and drop
    count bit-equal to the same function with the plain version's
    positions, and the output within rtol 1e-5 of the CPU's, atol 1e-5 of
    its largest |value| (float32 sums of terms up to ~100 here, taken in
    another order by cuBLAS than on the CPU: 3e-5 apart on the card)."""
    from repro_torch.kernels import dispatch as disp
    from repro_torch.kernels.ref import dispatch_plan_ref
    from repro_torch.models import moe as MOE

    cfg = get_smoke_config(arch).with_(capacity_factor=0.5, moe_dispatch_groups=groups)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    p["router"] = p["router"] * 8  # skewed loads: capacity binds
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 32, cfg.d_model))
                         .astype(np.float32))
    pc, xc = M.tree_map(lambda t: t.cuda(), p), x.cuda()
    before = _lib.LAUNCHES["dispatch_plan"]
    y, aux = MOE.moe_ffn(pc, xc, cfg)
    assert _lib.LAUNCHES["dispatch_plan"] == before + 1
    monkeypatch.setattr(disp, "dispatch_plan", dispatch_plan_ref)
    y_p, aux_p = MOE.moe_ffn(pc, xc, cfg)
    assert _lib.LAUNCHES["dispatch_plan"] == before + 1
    assert torch.equal(y, y_p) and torch.equal(aux["aux_loss"], aux_p["aux_loss"])
    assert int(aux["dropped"]) == int(aux_p["dropped"]) > 0
    y_c, aux_c = MOE.moe_ffn(p, x, cfg)
    torch.testing.assert_close(y.cpu(), y_c, rtol=1e-5, atol=1e-5 * float(y_c.abs().max()))
    assert int(aux["dropped"]) == int(aux_c["dropped"])


def test_moe_train_loss_backward_on_the_card_equals_the_cpu(_full_f32):
    """The Mixtral smoke config's loss and every gradient (the router's
    too) on the card within rtol/atol 2e-4 of the CPU's; the remat'd
    forward launches dispatch_plan twice per layer (forward, recompute)."""
    cfg = get_smoke_config("mixtral_8x22b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)))
    out = {}
    before = _lib.LAUNCHES["dispatch_plan"]
    for dev in ("cuda", "cpu"):
        out[dev] = _loss_and_grads(cfg, M.to_device(params, dev),
                                   {"tokens": toks.to(dev), "labels": toks.to(dev)})
    assert _lib.LAUNCHES["dispatch_plan"] == before + 2 * cfg.n_layers
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=2e-4, atol=2e-4)


# -- the simulator's device helpers (farm_serve, seq_cumsum, build_calendar),
# -- the chain probe and the fused engine on the card ------------------------

def _serve_equal(args):
    from repro_torch.kernels.farm_serve import farm_serve

    before = _lib.LAUNCHES["farm_serve"]
    got = farm_serve(*(a.cuda() for a in args))
    assert _lib.LAUNCHES["farm_serve"] == before + 1
    want = farm_serve(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    return want


@pytest.mark.parametrize("counts", [[1], [0, 5, 0, 3], [7, 0], [400] * 16,
                                    np.random.default_rng(0).integers(0, 300, 64).tolist()])
def test_farm_serve_equals_plain(counts):
    _serve_equal(serve_case(counts, sum(counts)))


def test_farm_serve_every_row_dropped():
    args = serve_case([50, 20], 3, cap=1e-6)
    dep, drop, _, _, w_max = _serve_equal(args)
    # nothing accepted: no completion, and the peak backlog is the carried one
    assert bool(drop.all()) and bool(torch.isinf(dep).all()) and torch.equal(w_max, args[3])


def test_farm_serve_cap_hit_exactly():
    """w + s == cap is kept (drop-tail is strict), the next row is dropped."""
    f = lambda *a: torch.tensor(a, dtype=torch.float64)
    args = (f(1.0, 1.0), f(0.25, 0.25), torch.tensor([0, 2], dtype=torch.int32),
            f(0.0), f(0.0), f(0.25))
    dep, drop, w, _, _ = _serve_equal(args)
    assert drop.tolist() == [False, True] and dep[0] == 1.25 and float(w) == 0.25


def test_farm_serve_rows_before_t_last():
    _serve_equal(serve_case([30, 12, 0, 9], 5, before_t_last=True))


@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 16_384, 100_003])
def test_seq_cumsum_equals_numpy_order(n):
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 7e-6, n) * rng.choice([1.0, 1e-3, 1e3], n)
    before = _lib.LAUNCHES["seq_cumsum"]
    got = seq_cumsum(torch.from_numpy(x).cuda())
    assert _lib.LAUNCHES["seq_cumsum"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), np.cumsum(x))


@pytest.mark.parametrize("case", sorted(FARM_RING_EDGES))
def test_farm_serve_ring_edges_equal_plain(case):
    """Members across several ring tiles, at odd row offsets, all rows in
    one member, 300 members, empty members between full ones; 5 rows past
    the last member stay untouched (inf, not dropped)."""
    dep, drop, *_ = _serve_equal(serve_case(FARM_RING_EDGES[case], len(case), extra_rows=5))
    assert bool(torch.isinf(dep[-5:]).all()) and not bool(drop[-5:].any())


@pytest.mark.parametrize("n", SCAN_RING_SIZES)
def test_seq_cumsum_ring_edges_equal_numpy_bits(n):
    """Zeros, negatives and -0.0 first, bit for bit (np.cumsum's out[0] =
    x[0]: -0.0 stays -0.0)."""
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    x = signed_sum_input(n, n)
    before = _lib.LAUNCHES["seq_cumsum"]
    got = seq_cumsum(torch.from_numpy(x).cuda())
    assert _lib.LAUNCHES["seq_cumsum"] == before + 1
    want = np.cumsum(x)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int64), want.view(np.int64))
    assert torch.equal(seq_cumsum(torch.from_numpy(x)), got.cpu())


def test_farm_serve_and_seq_cumsum_in_a_graph_replay():
    """Both kernels captured in one CUDA graph (one launch each counted at
    capture), the outputs spoiled, then two replays: exactly the plain
    versions' outputs."""
    from repro_torch.kernels.farm_serve import farm_serve
    from repro_torch.kernels.seq_cumsum import seq_cumsum

    args = serve_case([1100, 0, 257, 3, 0, 600], 7, extra_rows=3)
    x = signed_sum_input(5000, 3)
    on_card = [a.cuda() for a in args]
    x_card = torch.from_numpy(x).cuda()
    torch.cuda.synchronize()
    before = dict(_lib.LAUNCHES)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = (*farm_serve(*on_card), seq_cumsum(x_card))
    for name in ("farm_serve", "seq_cumsum"):
        assert _lib.LAUNCHES[name] == before[name] + 1, name
    want = (*farm_serve(*args), seq_cumsum(torch.from_numpy(x)))
    for _ in range(2):
        for out in got:
            out.fill_(False if out.dtype == torch.bool else float("nan"))
        g.replay()
        torch.cuda.synchronize()
        for gt, w in zip(got, want):
            assert torch.equal(gt.cpu(), w)


def test_chain_probe_times_both_chains():
    from repro_torch.kernels.chain_probe import chain_probe

    r = chain_probe(1 << 12)
    assert r["n"] == 1 << 12
    assert 1 <= r["add_cycles"] < r["row_cycles"] and 0 < r["add_ns"] < r["row_ns"]
    # the round-robin step (a redux.sync and a few integer operations) is
    # shorter than a farm row in the reference's order (two DSETPs)
    assert 0 < r["rr_step_cycles"] < r["straight_row_cycles"]
    assert 0 < r["rr_step_ns"] < r["straight_row_ns"]
    assert r["rr_step_cycles"] <= r["rr16_step_cycles"]


def _calendar_equal(w, do_sw=True, n_slots=512):
    from repro_torch.kernels.calendar import build_calendar

    out_gpu = torch.full((n_slots,), -7, dtype=torch.int32, device="cuda")
    flag = torch.tensor([do_sw], device="cuda")
    before = _lib.LAUNCHES["build_calendar"]
    build_calendar(w.cuda(), flag, out_gpu)
    assert _lib.LAUNCHES["build_calendar"] == before + 1
    want = build_calendar(w, torch.tensor([do_sw]),
                          torch.full((n_slots,), -7, dtype=torch.int32))
    assert torch.equal(out_gpu.cpu(), want)
    return want


# the smoke's member counts: one warp's edges (31, 32, 33), numpy's 128-lane
# block (128, 129) and the kernel's 512
@pytest.mark.parametrize("m", [1, 5, 16, 31, 32, 33, 64, 128, 129, 256, 511, 512])
@pytest.mark.parametrize("kind", CALENDAR_KINDS)
def test_build_calendar_equals_plain(m, kind):
    cal = _calendar_equal(torch.from_numpy(calendar_weights(m, kind, m)))
    assert int(cal.min()) >= 0 and int(cal.max()) < m


@pytest.mark.parametrize("n_slots,m", [(1, 1), (100, 1), (100, 7), (100, 100), (511, 16),
                                       (511, 300), (511, 511)])
@pytest.mark.parametrize("kind", ["random", "ties", "dominant"])
def test_build_calendar_slot_counts_equal_plain(n_slots, m, kind):
    cal = _calendar_equal(torch.from_numpy(calendar_weights(m, kind, n_slots + m)),
                          n_slots=n_slots)
    assert cal.shape == (n_slots,) and int(cal.max()) < m


def test_build_calendar_in_a_graph_replay():
    """One captured launch replayed with new weights (and a new switch flag)
    copied in between: each replay equals the plain version on them, and a
    replay with do_sw false leaves the last calendar in place."""
    from repro_torch.kernels.calendar import build_calendar

    w = torch.ones(64, dtype=torch.float64, device="cuda")
    flag = torch.tensor([True], device="cuda")
    out = torch.full((512,), -7, dtype=torch.int32, device="cuda")
    build_calendar(w, flag, out)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = _lib.LAUNCHES["build_calendar"]
    with torch.cuda.graph(g):
        build_calendar(w, flag, out)
    assert _lib.LAUNCHES["build_calendar"] == before + 1
    rng = np.random.default_rng(20)
    for i, kind in enumerate(["random", "dominant", "ties", "random"]):
        wn = calendar_weights(64, kind, i)
        w.copy_(torch.from_numpy(wn))
        g.replay()
        torch.cuda.synchronize()
        want = build_calendar(torch.from_numpy(wn), torch.tensor([True]),
                              torch.empty(512, dtype=torch.int32))
        assert torch.equal(out.cpu(), want), kind
    w.copy_(torch.from_numpy(rng.uniform(0.05, 8.0, 64)))
    flag.fill_(False)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)


def test_build_calendar_without_switch_leaves_out_untouched():
    cal = _calendar_equal(torch.linspace(0.5, 2.0, 16, dtype=torch.float64), do_sw=False)
    assert bool((cal == -7).all())


def test_fused_engine_on_the_card_equals_the_host_engine():
    """The straggler at 6 members: the fused engine on the card (one capture,
    one replay per 8 windows, every kernel launched in every window of the
    captured superblock) against the host engine on the card."""
    from repro_torch.simnet import Simulator, get_scenario
    from repro_torch.simnet import fused

    scn = get_scenario("straggler")
    cfg = lambda engine: scn.build_config(steps=24, n_members=6, engine=engine,
                                          device="cuda")
    host = Simulator(cfg("host"), dataclasses.replace(scn)).run()
    traces0, calls0 = fused.FUSED_TRACES, fused.FUSED_STEP_CALLS
    sim = Simulator(cfg("fused"), dataclasses.replace(scn))
    eng = fused.FusedEngine(sim)
    got = eng.run()
    assert got.engine == "fused"
    assert fused.FUSED_TRACES - traces0 <= 1 and fused.FUSED_STEP_CALLS - calls0 == 3
    for name in ("lb_route", "farm_serve", "seq_cumsum", "build_calendar"):
        assert eng.program.launches_per_run[name] == 8, name
    for f in ("packets_sent", "packets_delivered", "packets_dropped_queue",
              "duplicates_absorbed", "bundles_completed", "bundles_pending",
              "bundles_timed_out", "bundles_vanished", "epoch_switches"):
        assert getattr(got, f) == getattr(host, f), f
    for f in ("latency_p50_s", "latency_p99_s", "latency_max_s", "latency_mean_s"):
        assert getattr(got, f) == pytest.approx(getattr(host, f), rel=1e-9, abs=1e-12), f
    assert got.per_member_segments == host.per_member_segments
    # a second run of the same shape replays the same capture
    traces1 = fused.FUSED_TRACES
    again = Simulator(cfg("fused"), dataclasses.replace(scn)).run()
    assert fused.FUSED_TRACES == traces1 and again.bundles_completed == got.bundles_completed


def test_a_prefill_on_the_card_reads_a_share_of_its_roofline():
    """Yi-6B's width at 2 layers (bf16, random weights), a 1 x 2048-token
    prefill timed with CUDA events after a warm-up, against the port's
    analytic model on the H100: mfu and roofline_fraction in (0, 1.05]."""
    from repro_torch.analysis import perfmodel, roofline
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.shapes import ShapeSpec

    cfg = get_config("yi_6b").with_(n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 2048), dtype=torch.int32, device="cuda")
    ms = []
    with torch.no_grad():
        for _ in range(4):
            state = M.init_decode_state(cfg, 1, 2048, "cuda")
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            M.prefill(params, {"tokens": toks}, state, cfg)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    shape = ShapeSpec("prefill_2048", 2048, 1, "prefill")
    got = roofline.against(perfmodel.estimate(cfg, shape, 1, 1, 1), model_flops(cfg, shape),
                           min(ms[1:]) / 1e3)
    assert 0 < got["mfu"] <= 1.05 and 0 < got["roofline_fraction"] <= 1.05, got


def test_kernel_wrappers_launch_nothing_on_meta():
    """A meta input takes the plain version (shapes only); a CUDA input
    still launches the kernel."""
    q = torch.empty((1, 256, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 256, 4, 128), dtype=torch.bfloat16, device="meta")
    member = torch.empty(4096, dtype=torch.int32, device="meta")
    before = dict(_lib.LAUNCHES)
    out = flash_attention(q, k, k)
    pos, counts = dispatch_plan(member, n_members=16)
    assert _lib.LAUNCHES == before
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    assert pos.shape == (4096,) and counts.shape == (16,) and pos.device.type == "meta"
    flash_attention(*(torch.zeros(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, k)))
    dispatch_plan(torch.zeros(4096, dtype=torch.int32, device="cuda"), n_members=16)
    assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert _lib.LAUNCHES["dispatch_plan"] == before["dispatch_plan"] + 1
