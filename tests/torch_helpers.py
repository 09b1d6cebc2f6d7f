"""Shared builders for the parity tests of the PyTorch port against the JAX
package (``tests/test_torch_*.py``): the same numpy inputs go through both,
and results come back as numpy for exact comparison."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tables import device_tables_from_numpy


def jax_tables_np(tables) -> dict:
    """A JAX ``DeviceTables`` as a dict of numpy arrays."""
    return {f.name: np.asarray(getattr(tables, f.name))
            for f in dataclasses.fields(tables)}


def port_tables(jax_tables):
    """The JAX package's tables carried across to the port, on the CPU."""
    return device_tables_from_numpy(jax_tables_np(jax_tables), "cpu")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def headers(n, seed=0, corrupt_every=0, spread=1 << 48):
    """Random wire headers (uint32[n, 4]); every ``corrupt_every``-th one
    has a wrong magic, the one after it a wrong version."""
    from repro_torch.core.protocol import encode_headers

    rng = np.random.default_rng(seed)
    ev = rng.integers(0, spread, n).astype(np.uint64)
    en = rng.integers(0, 1 << 16, n).astype(np.uint32)
    h = encode_headers(ev, en)
    if corrupt_every:
        h[::corrupt_every, 0] ^= np.uint32(0x1_0000)
        h[1::corrupt_every, 0] ^= np.uint32(0x200)
    return h


def program(pkg, max_members=32, n_members=10, seed=0, switches=2, boundaries=None):
    """Program one LB instance the same way in either package: members with
    mixed lane widths, seeded weights, then ``switches`` epoch switches (at
    ``boundaries[k]`` when given)."""
    rng = np.random.default_rng(seed)
    em = pkg.EpochManager(max_members=max_members)
    weights = {i: float(rng.uniform(0.5, 2.0)) for i in range(n_members)}
    em.initialize({i: pkg.MemberSpec(node_id=i, base_lane=16 * i, lane_bits=i % 4)
                   for i in weights}, weights)
    for k in range(switches):
        ids = range(k + 1, n_members)
        em.reconfigure({i: pkg.MemberSpec(node_id=i + 100, lane_bits=1) for i in ids},
                       {i: float(rng.uniform(0.5, 2.0)) for i in ids},
                       boundary_event=(boundaries[k] if boundaries is not None
                                       else (1 << 40) + (k + 1) * (1 << 30)))
    return em


#: epoch switches on 2^32 boundaries (the hi word of the event changes there)
EDGE_BOUNDARIES = (1 << 32, (2 << 32) + 5, 255 << 32, 1 << 63)


def seg_starts(hi, lo) -> list[int]:
    """The u64 segment starts of one instance from its hi/lo words."""
    return [(int(h) << 32) | int(l) for h, l in zip(np.asarray(hi).ravel(),
                                                    np.asarray(lo).ravel())]


def edge_headers(starts, n, seed=0) -> np.ndarray:
    """``n`` wire headers (uint32[n, 4]) whose events sit on the epoch
    search's edges — every segment start and its neighbours, the 2^32
    boundaries, 0 and the top of the u64 space — cycled, then random events
    in the same ranges; every 7th header has a wrong magic."""
    from repro_torch.core.protocol import encode_headers

    top = 2**64 - 1
    ev = {0, 1, top, top - 1}
    for s in list(starts) + [k << 32 for k in (1, 2, 3, 255, 256, 1 << 31, (1 << 32) - 1)]:
        ev.update(v for v in (s - 1, s, s + 1) if 0 <= v <= top)
    edges = np.array(sorted(ev), np.uint64)
    rng = np.random.default_rng(seed)
    events = edges[np.arange(n) % len(edges)]
    rand = np.arange(n) >= 2 * len(edges)
    events[rand] = edges[rng.integers(0, len(edges), int(rand.sum()))] + rng.integers(
        0, 1 << 20, int(rand.sum())).astype(np.uint64)  # wraps past the top
    h = encode_headers(events, rng.integers(0, 1 << 16, n).astype(np.uint32))
    h[::7, 0] ^= np.uint32(0x1_0000)
    return h


def spread_program(pkg, max_members, n_live=200, seed=0, switches=2, boundaries=EDGE_BOUNDARIES):
    """Program one LB instance of ``max_members`` slots whose ``n_live``
    members sit on slots spread over the whole table (the last slot among
    them), with mixed lane widths and ``switches`` epoch switches: tables
    whose member reads reach every part of the member arrays."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(max_members - 1, n_live - 1, replace=False)).tolist()
    ids.append(max_members - 1)
    em = pkg.EpochManager(max_members=max_members)
    em.initialize({i: pkg.MemberSpec(node_id=i + 3, base_lane=(8 * i) % 4096, lane_bits=i % 4)
                   for i in ids}, {i: float(rng.uniform(0.5, 2.0)) for i in ids})
    for k in range(switches):
        live = ids[k + 1:]
        em.reconfigure({i: pkg.MemberSpec(node_id=i + 100, lane_bits=1) for i in live},
                       {i: float(rng.uniform(0.5, 2.0)) for i in live},
                       boundary_event=boundaries[k])
    return em


#: (instances, member slots) of the LB table shapes at the edges of the
#: ``lb_route`` kernel's two designs: the largest stacked and single tables
#: that fit a block's shared memory, one member slot past each, farm_1k
#: (4 x 4096), the fabric at K = 7 and K = 8 LBs (2K x 64)
LB_TABLE_SHAPES = ((4, 2595), (4, 2596), (1, 13491), (1, 13492), (4, 4096), (14, 64), (16, 64))


# member row counts on the edges of farm_serve's ring (256-row tiles, 4
# stages, 8-row batches): a member across several tiles with a ragged tail,
# members starting at odd rows, every row in one member, more members than
# the old 128-thread grid, empty members between full ones
FARM_RING_EDGES = {
    "spans_ring_tiles": [1100, 3, 700],
    "odd_row_offsets": [1, 3, 5, 257, 7, 511, 9],
    "all_rows_one_member": [16_384],
    "300_members": np.random.default_rng(300).integers(0, 60, 300).tolist(),
    "empty_between_full": [0, 600, 0, 0, 300, 0],
}
# running-sum lengths on the edges of seq_cumsum's ring (1024-row tiles,
# 16-value batches) and the full size
SCAN_RING_SIZES = (15, 16, 17, 1023, 1024, 1025, 1 << 20)


def serve_case(counts, seed, cap=0.05, before_t_last=False, s_scale=1.0, extra_rows=0):
    """Rows sorted by (member, arrival) with ``counts[m]`` rows of member m,
    float64 on the CPU, as ``farm_serve`` takes them; ``before_t_last`` puts
    arrivals before the carried clock, as jittered next-window packets do;
    ``extra_rows`` rows past ``offsets[-1]`` belong to no member."""
    rng = np.random.default_rng(seed)
    m = len(counts)
    t = np.concatenate([np.sort(rng.uniform(0.0, 0.01, c)) for c in counts]
                       + [rng.uniform(0.0, 0.01, extra_rows)])
    s = rng.uniform(1e-5, 2e-3, len(t)) * s_scale
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    t0 = np.full(m, 0.02 if before_t_last else 0.0)
    w0 = rng.uniform(0.0, 0.01, m)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (f(t), f(s), f(offsets), f(w0), f(t0), f(np.full(m, cap)))


def signed_sum_input(n, seed) -> np.ndarray:
    """float64[n] with zeros, negatives and -0.0 first (np.cumsum keeps
    out[0] = -0.0, where 0 + x[0] would give +0.0)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-7e-6, 7e-6, n) * rng.choice([1.0, 1e-3, 1e3], n)
    x[rng.random(n) < 0.2] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    x[0] = -0.0
    return x


CALENDAR_KINDS = ("equal", "dominant", "random", "ties")


def calendar_weights(m, kind, seed) -> np.ndarray:
    """Float64 weights of m calendar members: ``CALENDAR_KINDS`` (as
    ``chip_smoke.calendar_weights`` makes them), "surplus" (one member at
    40 m over the rest at 0.05: hundreds of members raised to one slot, the
    surplus loop's longest runs) and "log-uniform" (16 decades)."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.ones(m)
    if kind == "dominant":
        return np.r_[40.0, np.full(m - 1, 0.05)][:m]
    if kind == "random":
        return rng.uniform(0.05, 8.0, m)
    if kind == "ties":
        return np.repeat(rng.uniform(0.3, 2.0, (m + 2) // 3), 3)[:m]
    if kind == "surplus":
        return np.r_[40.0 * m, np.full(m - 1, 0.05)][:m]
    if kind == "log-uniform":
        return np.exp(rng.uniform(-8.0, 8.0, m))
    raise ValueError(f"unknown weight kind {kind!r}")


# -- the gloo multi-process cases of tests/test_torch_distributed.py ----------

#: LB members of the multi-process ingest: more than any world size (nodes
#: past W are dropped), with one heavy member (its events overflow cap)
DIST_MEMBERS = 6


def dist_case(world: int) -> dict:
    """The numpy inputs of one world size, made alike in the parent (for the
    reference) and in every rank (which takes its rows)."""
    rng = np.random.default_rng(100 + world)
    b, t = 8 * world, 8
    from repro_torch.core.protocol import encode_headers

    events = rng.integers(0, 1 << 40, b).astype(np.uint64)
    tokens = rng.integers(0, 256, (b, t)).astype(np.int32)
    member = rng.integers(-1, world, 8 * world).astype(np.int32)
    member[::2] = np.where(rng.random(4 * world) < 0.7, 0, member[::2])  # member 0 overflows
    return dict(
        weights=np.r_[4.0, rng.uniform(0.5, 2.0, DIST_MEMBERS - 1)],
        tokens=tokens,
        headers=encode_headers(events, rng.integers(0, 1 << 16, b).astype(np.uint32)),
        payload=(np.arange(8 * world * 2, dtype=np.float32).reshape(-1, 2) * 10.0),
        member=member,
    )


def dist_program(pkg, weights):
    """One LB instance of ``DIST_MEMBERS`` members (node id = member id)."""
    em = pkg.EpochManager(max_members=16)
    em.initialize({i: pkg.MemberSpec(node_id=i) for i in range(len(weights))},
                  {i: float(w) for i, w in enumerate(weights)})
    return em


def dist_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One gloo rank: ``_ingest`` of its arrival shard and
    ``make_redistribute`` of its payload rows; the results go to
    ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist

    import repro_torch.core as tcore
    from repro_torch.core.router import make_redistribute
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.train.train_step import _ingest

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        c = dist_case(world)
        mesh = Mesh(("data",), (world,))
        tables = dist_program(tcore, c["weights"]).device_tables("cpu")
        rows = slice(rank * len(c["tokens"]) // world, (rank + 1) * len(c["tokens"]) // world)
        out, occ = _ingest({"tokens": c["tokens"][rows], "labels": c["tokens"][rows].copy(),
                            "headers": c["headers"][rows]}, tables, mesh)
        per = len(c["member"]) // world
        mine = slice(rank * per, (rank + 1) * per)
        recv, rocc = make_redistribute(mesh, ("data",), 3)(
            torch.from_numpy(c["payload"][mine]), torch.from_numpy(c["member"][mine]))
        np.savez(f"{out_dir}/rank{rank}.npz", tokens=out["tokens"].numpy(),
                 labels=out["labels"].numpy(), occ=occ.numpy(), recv=recv.numpy(),
                 rocc=rocc.numpy())
    finally:
        dist.destroy_process_group()
