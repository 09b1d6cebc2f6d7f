"""``repro_torch.testing.plans``: the ``dispatch_plan`` calls of one
training step, as the step on the card is held against plain with them
(``chip_smoke.py``'s ``[train_families]``, ``scripts/train_dp_torch.py``).

On the CPU the wrapper takes the plain version, so here the record's count
and shapes are what is checked: the LB ingest's pack first, then each MoE
layer's in the forward and, under remat, again in the recompute on the same
members; and ``held`` must notice a pack that differs from plain."""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import _lib
from repro_torch.testing.plans import held, recorded_plans
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer, TrainerConfig

BATCH, SEQ = 4, 16


def _step_calls(tmp_path, arch, remat):
    cfg = get_smoke_config(arch)
    tc = TS.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3), remat=remat, lb_ingest=True,
                        q_chunk=8, k_chunk=8)
    tr = Trainer(cfg, tc, TrainerConfig(ckpt_dir=str(tmp_path), device="cpu"),
                 mesh=Mesh(("data",), (1,)))
    tr.init_or_restore(torch.Generator().manual_seed(0))
    with recorded_plans() as calls:
        tr.run(1, batch=BATCH, seq=SEQ)
    return cfg, calls


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_a_moe_step_packs_once_in_the_ingest_and_per_layer_pass(tmp_path, remat):
    cfg, calls = _step_calls(tmp_path, "mixtral_8x22b", remat)
    passes = 2 if remat else 1
    assert len(calls) == 1 + passes * cfg.n_layers
    plans = held(calls)
    assert all(p["equal"] for p in plans)
    # the ingest packs the batch's events over the data ranks (one here)
    assert (plans[0]["n"], plans[0]["n_members"]) == (BATCH, 1)
    for p in plans[1:]:
        assert (p["n"], p["n_members"]) == (cfg.top_k * BATCH * SEQ, cfg.n_experts)
    if remat:  # the backward recomputes the layers last first, on the forward's members
        fwd, again = calls[1:1 + cfg.n_layers], calls[1 + cfg.n_layers:]
        assert all(torch.equal(a[0], b[0]) for a, b in zip(fwd, again[::-1]))


def test_a_dense_step_packs_only_in_the_ingest(tmp_path):
    _cfg, calls = _step_calls(tmp_path, "yi_6b", True)
    assert [(p["n"], p["equal"]) for p in held(calls)] == [(BATCH, True)]


def test_held_finds_a_pack_that_differs_from_plain():
    member = torch.tensor([2, 0, 2, 1, 2, -1, 0], dtype=torch.int32)
    before = dict(_lib.LAUNCHES)
    with recorded_plans() as calls:
        from repro_torch.kernels import dispatch
        pos, counts = dispatch.dispatch_plan(member, n_members=3)
    assert dict(_lib.LAUNCHES) == before  # a CPU tensor takes the plain version
    assert pos.tolist() == [0, 0, 1, 0, 2, -1, 1] and counts.tolist() == [2, 1, 3]
    assert held(calls) == [dict(n=7, n_members=3, equal=True)]
    swapped = pos.clone()
    swapped[[0, 2]] = swapped[[2, 0]]
    assert held([(member, 3, swapped, counts)])[0]["equal"] is False
    assert held([(member, 3, pos, counts + 1)])[0]["equal"] is False
