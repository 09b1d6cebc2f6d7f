"""The port's ``launch/mesh.py`` and ``launch/shardspecs.py`` against the JAX
package's, and ``param_sharding`` over the full configs.

On the one-device (1, 1) mesh the reference runs in this process, as
``tests/test_launch.py`` does. Its 256/512-chip meshes need as many
devices: one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (as
``src/repro/launch/dryrun.py`` sets it) writes the reference's mesh axes
and its specs at (16, 16), (2, 16, 16), (256, 1) and ``make_hybrid_mesh(4)``
as JSON, and the port's specs (no devices needed) are held equal to
them: the decode-state specs for every arch x runnable prefill and decode
shape, the batch specs for every arch x runnable shape, and the params'
specs of every full config at (16, 16) (the port's on the meta device).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs import get_config as j_config
from repro.launch import mesh as JMESH
from repro.launch import shapes as JSH
from repro.launch.shardspecs import batch_shardings as j_batch
from repro.launch.shardspecs import decode_state_shardings as j_decode
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import shapes as TSH
from repro_torch.launch.shardspecs import batch_shardings, decode_state_shardings
from repro_torch.distributed.sharding import Mesh, param_sharding
from repro_torch.models import model as TM
from repro_torch.tree import flat_paths

ROOT = Path(__file__).resolve().parents[1]

#: name -> the factory call, the same in both packages
MESHES = {
    "production": "make_production_mesh()",
    "multi_pod": "make_production_mesh(multi_pod=True)",
    "dp": "make_dp_mesh()",
    "dp_multi_pod": "make_dp_mesh(multi_pod=True)",
    "hybrid_tp4": "make_hybrid_mesh(4)",
    "hybrid_tp16_multi_pod": "make_hybrid_mesh(16, multi_pod=True)",
}
#: the meshes whose specs are compared
SPEC_MESHES = ("production", "multi_pod", "dp", "hybrid_tp4")

_SCRIPT = r"""
import json, sys
import jax
from repro.configs import get_config
from repro.launch import mesh as MESH, shapes as SH
from repro.launch.shardspecs import batch_shardings, decode_state_shardings
from repro.distributed.sharding import param_sharding
from repro.models import model as M
from repro_torch.configs import ARCH_IDS

def flat(tree):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)
        out[key] = list(s.spec)
    return out

calls, spec_meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"axes": {}, "decode": {}, "batch": {}, "params": {}}
for name, call in calls.items():
    mesh = eval("MESH." + call)
    out["axes"][name] = [list(mesh.axis_names), [mesh.shape[a] for a in mesh.axis_names]]
    if name not in spec_meshes:
        continue
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SH.runnable_cells(cfg):
            key = f"{name}|{arch}|{shape}"
            out["batch"][key] = flat(batch_shardings(mesh, SH.batch_specs(cfg, shape)))
            if SH.SHAPES[shape].kind != "train" and not cfg.encoder_only:
                out["decode"][key] = flat(decode_state_shardings(
                    cfg, mesh, SH.decode_state_specs(cfg, shape)))
        if name == "production":
            shapes = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
            out["params"][arch] = flat(param_sharding(shapes, mesh, cfg))
json.dump(out, sys.stdout)
"""


def _norm(spec_tree) -> dict:
    """The port's specs as the reference's JSON: path -> list of entries."""
    return json.loads(json.dumps({k: list(v) for k, v in flat_paths(spec_tree).items()}))


def _port_mesh(call: str) -> Mesh:
    return eval("TMESH." + call)


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(MESHES),
                          json.dumps(SPEC_MESHES)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_factories_equal_reference(reference, name):
    mesh = _port_mesh(MESHES[name])
    assert [list(mesh.axis_names), list(mesh.axis_sizes)] == reference["axes"][name]
    assert mesh.group is None  # no process group in this process: nothing bound


def test_debug_mesh_equals_reference_on_one_device():
    jm, tm = JMESH.make_debug_mesh(1, 1), TMESH.make_debug_mesh(1, 1)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.axis_sizes == tuple(jm.shape[a] for a in jm.axis_names)


def _cells(kinds):
    return [(arch, shape) for arch in ARCH_IDS for shape in JSH.runnable_cells(j_config(arch))
            if JSH.SHAPES[shape].kind in kinds
            and not (JSH.SHAPES[shape].kind != "train" and j_config(arch).encoder_only)]


def _j_flat(tree) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)] = list(s.spec)
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("arch,shape", _cells(("prefill", "decode")))
def test_decode_state_specs_equal_reference_on_one_device(arch, shape):
    jcfg, tcfg = j_config(arch), get_config(arch)
    want = _j_flat(j_decode(jcfg, jax.make_mesh((1, 1), ("data", "model")),
                            JSH.decode_state_specs(jcfg, shape)))
    got = decode_state_shardings(tcfg, Mesh(("data", "model"), (1, 1)),
                                 TSH.decode_state_specs(tcfg, shape))
    assert _norm(got) == want


@pytest.mark.parametrize("arch,shape", _cells(("train", "prefill", "decode")))
def test_batch_specs_equal_reference_on_one_device(arch, shape):
    jcfg, tcfg = j_config(arch), get_config(arch)
    want = _j_flat(j_batch(jax.make_mesh((1, 1), ("data", "model")), JSH.batch_specs(jcfg, shape)))
    assert _norm(batch_shardings(Mesh(("data", "model"), (1, 1)),
                                 TSH.batch_specs(tcfg, shape))) == want


@pytest.mark.parametrize("name", SPEC_MESHES)
def test_decode_and_batch_specs_equal_reference_on_large_meshes(reference, name):
    mesh = _port_mesh(MESHES[name])
    n = 0
    for key, want in reference["decode"].items():
        m, arch, shape = key.split("|")
        if m == name:
            cfg = get_config(arch)
            got = decode_state_shardings(cfg, mesh, TSH.decode_state_specs(cfg, shape))
            assert _norm(got) == want, key
            n += 1
    for key, want in reference["batch"].items():
        m, arch, shape = key.split("|")
        if m == name:
            assert _norm(batch_shardings(mesh, TSH.batch_specs(get_config(arch), shape))) == want
            n += 1
    assert n > len(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_of_full_configs_equal_reference_at_16x16(reference, arch):
    cfg = get_config(arch)
    params = TM.init_params(cfg, None, "meta")
    got = _norm(param_sharding(params, TMESH.make_production_mesh(), cfg))
    assert got == reference["params"][arch]


def test_unknown_decode_state_path_is_refused():
    cfg = get_config("yi_6b")
    with pytest.raises(ValueError, match="no placement rule"):
        decode_state_shardings(cfg, Mesh(("data", "model"), (1, 1)),
                               {"kv_extra": TSH.decode_state_specs(cfg, "decode_32k")["pos"]})


def test_factories_bind_the_data_axes_group_of_a_512_rank_world():
    """On torch's fake process group (one process standing as rank 3 of
    512): the multi-pod meshes bind the group of their ("pod", "data")
    axes, 2 x 16 = 32 ranks beside 16-way "model", all 512 at (2, 256, 1);
    a (16, 16) mesh is refused by the 512-rank world."""
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=3, world_size=512)\n"
        "from repro_torch.launch import mesh as M\n"
        "for m in (M.make_production_mesh(multi_pod=True),\n"
        "          M.make_dp_mesh(multi_pod=True)):\n"
        "    print(dist.get_world_size(m.group), dist.get_rank(m.group))\n"
        "try:\n"
        "    M.make_production_mesh()\n"
        "except ValueError as exc:\n"
        "    print(exc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[:2] == ["32 0", "512 3"]
    assert "needs 256 ranks; the process group has 512" in lines[2]
