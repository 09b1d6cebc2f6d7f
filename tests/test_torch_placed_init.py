"""``train_step.init_train_state(..., specs=, mesh=)`` (the params cut to
the rank's blocks before the moments are made, as the Trainer over a
process group builds its state) against ``shard_state`` of the whole state
(the one way before it): leaf for leaf equal on every rank of (1, 2) and
(2, 1), with float32 and with 8-bit moments (the per-row scales of a leaf
whose last dim is split are the case where the two could differ).

Each rank runs in this process as a rank of torch's fake process group
(``launch.dryrun.fake_world``'s backend): neither construction issues a
collective, so no other process is needed."""
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.tree import leaves


def _states(arch, eight_bit, shape, rank):
    """(placed at init, sharded whole, the whole params) on ``rank`` of a
    fake world of the mesh ``shape``."""
    cfg = get_smoke_config(arch)
    tc = TS.TrainConfig(adamw=TO.AdamWConfig(eight_bit=eight_bit))
    gen = lambda: torch.Generator().manual_seed(3)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=shape[0] * shape[1])
    try:
        mesh = make_debug_mesh(*shape)
        specs = TS.placement(cfg, tc, mesh, TS.state_shapes(cfg, tc)["params"],
                             min_fsdp_size=1024)
        placed = TS.init_train_state(gen(), cfg, tc, "cpu", specs=specs, mesh=mesh)
        whole = TS.init_train_state(gen(), cfg, tc, "cpu")
        return placed, TS.shard_state(whole, specs, mesh), whole["params"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("eight_bit", [False, True], ids=["f32", "8bit"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x22b"])
def test_placed_init_equals_shard_state_of_the_whole_state(arch, shape, eight_bit):
    split_last = 0
    for rank in range(shape[0] * shape[1]):
        placed, sharded, whole = _states(arch, eight_bit, shape, rank)
        assert placed.keys() == sharded.keys()
        for part in ("params", "opt"):
            got, want = leaves(placed[part]), leaves(sharded[part])
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                assert a.dtype == b.dtype and torch.equal(a, b), f"rank {rank}: {part} leaf {i}"
        assert int(placed["step"]) == int(sharded["step"]) == 0
        split_last += sum(p.shape[-1] < w.shape[-1]
                          for p, w in zip(leaves(placed["params"]), leaves(whole)))
    # the case the per-row scales could differ on is there
    assert split_last > 0
