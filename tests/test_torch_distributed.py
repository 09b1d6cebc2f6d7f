"""The port's distributed pieces on the CPU against the JAX package's.

Sharding specs: ``param_sharding`` on ``AbstractMesh`` meshes (no devices
needed) against the port's on the same shapes, in the port's list layout.
Across processes (gloo, 2 and 4 ranks): ``_ingest`` on each rank's arrival
shard against the reference's single-program ``_ingest`` on the whole batch,
``make_redistribute`` against the reference's per-source
``router.dispatch`` transposed. The reference's own multi-device tests
fail in this environment (``tests/test_distributed.py::TestMultiDevice``),
so the single-program functions are the oracle. Integer outputs are exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core as jcore
from repro.configs import get_config as j_config
from repro.core.router import dispatch as j_dispatch
from repro.distributed import compression as JC
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.train_step import _ingest as j_ingest
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.context import constrain, get_rules, use_rules
from torch_helpers import dist_case, dist_program

ROOT = Path(__file__).resolve().parents[1]
#: ranks of a gloo world get this long to finish (a hang fails its own test)
JOIN_TIMEOUT_S = 180

MESHES = {
    "data4_model2": ((4, 2), ("data", "model")),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
    "data8": ((8,), ("data",)),
}


def _shapes(arch):
    cfg = j_config(arch)
    return cfg, jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))


def _port_layout(tree, n_layers):
    """The reference's shapes as the port holds them: meta tensors, the
    stacked layers as a list of per-layer dicts."""
    meta = lambda s: torch.empty(s, device="meta")
    out = {k: jax.tree.map(lambda v: meta(v.shape), v) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = [jax.tree.map(lambda v: meta(v.shape[1:]), tree["layers"])
                     for _ in range(n_layers)]
    return out


def _ref_specs(tree):
    return jax.tree.map(lambda s: tuple(s.spec), tree)


@pytest.mark.parametrize("arch", ["yi_6b", "granite_20b", "chatglm3_6b"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp,tp_enabled,wide_tp", [(True, True, False), (False, True, False),
                                                      (True, False, False), (True, True, True),
                                                      (False, True, True)])
def test_param_sharding_equals_reference(arch, mesh_name, fsdp, tp_enabled, wide_tp):
    cfg, shapes = _shapes(arch)
    sizes, names = MESHES[mesh_name]
    kw = dict(fsdp=fsdp, tp_enabled=tp_enabled, wide_tp=wide_tp)
    want = _ref_specs(JS.param_sharding(shapes, AbstractMesh(sizes, names), cfg, **kw))
    got = TS.param_sharding(_port_layout(shapes, cfg.n_layers), TS.Mesh(names, sizes), cfg, **kw)
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_optimizer_state_sharding_equals_reference(mesh_name):
    """The moments' specs (ZeRO-style: FSDP on the states), 8-bit states too."""
    cfg, shapes = _shapes("yi_6b")
    sizes, names = MESHES[mesh_name]
    for eight_bit in (False, True):
        st = jax.eval_shape(lambda: JO.init(shapes, JO.AdamWConfig(eight_bit=eight_bit)))
        want = _ref_specs(JS.param_sharding(st, AbstractMesh(sizes, names), cfg))
        port_mu = _port_layout(st["mu"], cfg.n_layers)
        got = TS.param_sharding({"mu": port_mu, "count": torch.empty((), device="meta")},
                                TS.Mesh(names, sizes), cfg)
        assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_sharding_and_logical_rules_equal_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    jm, tm = AbstractMesh(sizes, names), TS.Mesh(names, sizes)
    for ndim in (1, 2, 3):
        assert TS.batch_sharding(tm, ndim) == tuple(JS.batch_sharding(jm, ndim).spec)
    assert TS.batch_sharding(tm, 3, batch_dim=1) == tuple(
        JS.batch_sharding(jm, 3, batch_dim=1).spec)
    assert TS.replicated(tm) == tuple(JS.replicated(jm).spec)
    assert TS.data_axes(tm) == JS.data_axes(jm) and TS.model_axis(tm) == JS.model_axis(jm)
    for seq_axis in (None, "model"):
        jr, tr = JS.logical_rules(jm, seq_axis=seq_axis), TS.logical_rules(tm, seq_axis=seq_axis)
        assert tr.rules == jr.rules
        for logical in (("batch", "seq", None), ("batch", None, "vocab"), ("heads", "ff")):
            assert tr.spec(logical) == tuple(jr.spec(logical))


def test_constrain_is_a_no_op_under_rules():
    rules = TS.logical_rules(TS.Mesh(("data", "model"), (4, 2)))
    x = torch.ones(2, 3)
    with use_rules(rules):
        assert get_rules() is rules
        assert constrain(x, ("batch", None)) is x
    assert get_rules() is None


# -- compression ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 256, 7, 4096 + 3])
def test_quantize_and_compress_decompress_equal_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    x[::17] = 0.0
    jq, js, jn = JC.quantize_int8(jnp.asarray(x))
    tq, ts, tn = TC.quantize_int8(torch.from_numpy(x))
    assert tn == jn
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TC.compress_decompress(torch.from_numpy(x)).numpy(),
                                  np.asarray(JC.compress_decompress(jnp.asarray(x))))


# -- across processes (gloo) ------------------------------------------------------

def _run_world(world, tmp_path):
    env = {"PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}", "PATH": os.environ["PATH"],
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    init = tmp_path / "init"
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, torch_helpers as h; "
                               "h.dist_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
                               "sys.argv[4])", str(r), str(world), str(init), str(tmp_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    w = request.param
    return w, _run_world(w, tmp_path_factory.mktemp(f"gloo{w}"))


def test_ingest_across_ranks_equals_single_program_ingest(world):
    w, ranks = world
    c = dist_case(w)
    tables = dist_program(jcore, c["weights"]).device_tables()
    batch = {"tokens": jnp.asarray(c["tokens"]), "labels": jnp.asarray(c["tokens"]),
             "headers": jnp.asarray(c["headers"])}
    out, occ = j_ingest(batch, tables, AbstractMesh((w,), ("data",)), len(c["tokens"]))
    out, occ = jax.tree.map(np.asarray, out), np.asarray(occ)
    cap = len(c["tokens"]) // w
    assert 0 < occ.sum() < len(occ)  # some rows dropped: nodes past W, overflow
    for r, got in enumerate(ranks):
        shard = slice(r * cap, (r + 1) * cap)
        np.testing.assert_array_equal(got["occ"], occ[shard])
        np.testing.assert_array_equal(got["tokens"], out["tokens"][shard])
        np.testing.assert_array_equal(got["labels"], out["labels"][shard])


def test_redistribute_equals_per_source_dispatch_transposed(world):
    w, ranks = world
    c = dist_case(w)
    per = len(c["member"]) // w
    packed = [j_dispatch(jnp.asarray(c["payload"][s * per:(s + 1) * per]),
                         jnp.asarray(c["member"][s * per:(s + 1) * per]), w, 3)
              for s in range(w)]
    for r, got in enumerate(ranks):
        want = np.concatenate([np.asarray(buf)[r] for buf, _, _ in packed])
        want_occ = np.concatenate([np.asarray(occ)[r] for _, occ, _ in packed])
        np.testing.assert_array_equal(got["recv"], want)
        np.testing.assert_array_equal(got["rocc"], want_occ)
    assert any(int(np.asarray(counts).max()) > 3 for _, _, counts in packed)  # overflow
