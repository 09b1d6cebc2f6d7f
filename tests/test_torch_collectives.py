"""The port's collective record (``analysis/collectives.py``) against the
JAX package's HLO accounting (``repro/analysis/hlo.py``), and the dry run's
training cell on the reference's sharded meshes over torch's fake process
group.

Each collective kind the port issues (through ``distributed.dp``), at group
sizes 2, 4 and 16, is recorded on a fake process group of that many ranks
(this process as rank 0) and held equal to ``hlo.collective_stats`` over
the HLO line of the same collective: the same ops, payload and ring-model
wire bytes per device.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis import hlo
from repro.analysis import roofline as RR
from repro_torch.analysis import roofline as TR
from repro_torch.analysis.collectives import CollectiveRecord
from repro_torch.distributed import dp
from repro_torch.launch.dryrun import fake_world

ROOT = Path(__file__).resolve().parents[1]
N = 96  # f32 elements a rank sends (a multiple of every group size below)


def _hlo(kind: str, out_elems: int, g: int) -> str:
    """One HLO computation holding one collective of ``kind`` over groups
    of ``g``, whose output is ``out_elems`` f32."""
    return ("HloModule m\n\n"
            f"ENTRY %main (p: f32[{N}]) -> f32[{out_elems}] {{\n"
            f"  %p = f32[{N}]{{0}} parameter(0)\n"
            f"  ROOT %c = f32[{out_elems}]{{0}} {kind}(%p), replica_groups=[1,{g}]<=[{g}]\n"
            "}\n")


#: kind -> (issue it through dp on a group of g, its HLO output's elements)
KINDS = {
    "all-reduce": (lambda x, grp: dp.all_reduce(x, grp), lambda g: N),
    "all-gather": (lambda x, grp: dp.all_gather(x, grp), lambda g: N * g),
    "reduce-scatter": (lambda x, grp: dp.reduce_scatter(x, grp, 0), lambda g: N // g),
    "all-to-all": (lambda x, grp: dp.all_to_all(x, grp), lambda g: N),
}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_record_equals_hlo_accounting(kind, g):
    issue, out_elems = KINDS[kind]
    with fake_world(g):
        with CollectiveRecord() as rec:
            issue(torch.ones(N, device="meta"), dist.group.WORLD)
    got = rec.stats().to_json()
    assert got == hlo.collective_stats(_hlo(kind, out_elems(g), g)).to_json()
    assert got["ops"] == {kind: 1} and got["total_wire_bytes"] > 0


def test_a_group_of_one_records_nothing_and_dtensor_issues_its_own():
    """A collective over one rank is recorded as nothing (also when issued
    directly, past ``dp``'s skip); a DTensor's redistribution is recorded
    as the all-gather that DTensor's dispatch issues."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(2):
        one = dist.new_group([0])
        with CollectiveRecord() as rec:
            dist.all_reduce(torch.ones(N), group=one)
            dp.all_gather(torch.ones(N), one)
        assert rec.calls == []
        mesh = init_device_mesh("cpu", (2,))
        x = distribute_tensor(torch.ones(4, N), mesh, [Shard(0)])
        with CollectiveRecord() as rec:
            x.redistribute(mesh, [Replicate()])
        assert [k for k, _, g in rec.calls] == ["all-gather"] and rec.calls[0][2] == 2


def test_train_cell_on_the_sharded_meshes_records_collectives():
    """Yi's smoke config in the ``train_4k`` cell at
    ``make_production_mesh()`` (16 x 16), at ``tp4`` (64 x 4) and at
    ``seqpar`` (16 x 16, the residual stream split by sequence over
    "model"), lowered in a subprocess as rank 0 of a fake 256-rank world:
    every operation stays on meta (the dry run fails a cell otherwise), the
    record holds all-gathers, all-reduces and the ingest's all-to-alls (and
    under seqpar the stream's reduce-scatters on the model group, beside no
    fewer all-gathers than the baseline's), and both packages' ``analyze``
    read the artifact."""
    code = (
        "import json\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch import dryrun as D\n"
        "with D.fake_world(256):\n"
        "    arts = [D.lower_cell('yi_6b', 'train_4k', v, mesh='single',\n"
        "                         cfg=get_smoke_config('yi_6b'))\n"
        "            for v in ('baseline', 'tp4', 'seqpar')]\n"
        "print(json.dumps(arts))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    arts = json.loads(res.stdout.splitlines()[-1])
    for art, (dp_, tp_) in zip(arts, [(16, 16), (64, 4), (16, 16)]):
        assert (art["chips"], art["dp"], art["tp"]) == (256, dp_, tp_)
        col = art["collectives"]
        assert col["total_wire_bytes"] > 0
        assert {"all-gather", "all-reduce", "all-to-all"} <= set(col["ops"])
        assert col["ops"] == {k: int(v) for k, v in col["dynamic_ops"].items()}
        for analyze in (RR.analyze, TR.analyze):
            r = analyze(art)
            assert r.chips == 256 and r.wire_bytes_per_device > 0 and r.collective_s > 0
        assert art["memory"]["argument_size_in_bytes"] > 0 and art["cost"]["flops"] > 0
    base, seq = arts[0]["collectives"]["ops"], arts[2]["collectives"]["ops"]
    assert seq.get("reduce-scatter", 0) > base.get("reduce-scatter", 0)
    assert seq["all-gather"] >= base["all-gather"]
