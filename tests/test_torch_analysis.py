"""The port's analysis and dry-run modules on the CPU against the JAX
package's: ``analysis.perfmodel.estimate`` equal as floats over the whole
grid (10 archs x 4 shapes x 4 meshes, f32 and 8-bit moments),
``launch.shapes`` (skips, the batch and decode-state stand-ins),
``analysis.roofline`` (fed the reference's TPU v5e constants it equals the
reference's ``analyze``; by default its terms are the H100's), the meta dry
run (each family's smoke config at the four kinds, Yi-6B's full-size
``prefill_32k``, the CLI and its refusals) read by the reference's
``analyze``, and the kernel wrappers' meta branch.

About 70 s on one CPU core, most of it the smoke configs' meta steps (RWKV6's
prefill and train step 33 s).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import perfmodel as RPM
from repro.analysis import roofline as RR
from repro.configs import ARCH_IDS, get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.launch import shapes as RSH
from repro_torch.analysis import perfmodel as TPM
from repro_torch.analysis import roofline as TR
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import dispatch_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lb_route import lb_route
from repro_torch.kernels.ref import dispatch_plan_ref, flash_attention_ref, lb_route_ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes as TSH
from repro_torch.models.layers import KVCache
from repro_torch.tree import flat_paths, stacked_shape

MESHES = [(256, 16, 16), (256, 256, 1), (512, 32, 16), (1, 1, 1)]
V5E = TR.Chip("TPU v5e (the reference's constants)", RR.PEAK_FLOPS, RR.HBM_BW, RR.ICI_BW,
              RR.BF16_CORRECTION)
#: the reference's dtypes as the port carries them (u32 header words as
#: their int32 bits)
DTYPES = {"int32": torch.int32, "uint32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
#: one arch of each family
FAMILIES = ["yi_6b", "mixtral_8x22b", "llama_3_2_vision_90b", "hubert_xlarge",
            "zamba2_2_7b", "rwkv6_7b"]


# -- perfmodel -----------------------------------------------------------------

@pytest.mark.parametrize("shape", list(RSH.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_equals_reference(arch, shape):
    """Every (chips, dp, tp) and both moment widths: flops, bytes and every
    item equal as floats; a ``ShapeSpec`` gives what its name gives."""
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    spec = TSH.SHAPES[shape]
    for chips, dp, tp in MESHES:
        for eight in (False, True):
            want = RPM.estimate(rcfg, shape, chips, dp, tp, eight_bit_opt=eight)
            got = TPM.estimate(tcfg, shape, chips, dp, tp, eight_bit_opt=eight)
            assert got.flops == want.flops and got.bytes_hbm == want.bytes_hbm
            assert got.items == want.items and got.to_json() == want.to_json()
            by_spec = TPM.estimate(tcfg, dataclasses.replace(spec, name="own"), chips, dp, tp,
                                   eight_bit_opt=eight)
            assert by_spec.to_json() == got.to_json()
    assert TPM._mixer_flops_per_token(tcfg, spec.seq_len) == \
        RPM._mixer_flops_per_token(rcfg, spec.seq_len)
    assert TPM._decode_mixer_flops(tcfg, spec.seq_len) == \
        RPM._decode_mixer_flops(rcfg, spec.seq_len)
    assert TPM._cache_bytes(tcfg, 3, spec.seq_len) == RPM._cache_bytes(rcfg, 3, spec.seq_len)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_estimate_at_a_cut_depth_and_own_shape(kind, monkeypatch):
    """The [roofline] phase's use: a config cut in depth at a path's own
    batch and length, equal to the reference's at the same shape."""
    monkeypatch.setitem(RSH.SHAPES, "own", RSH.ShapeSpec("own", 3938, 4, kind))
    spec = TSH.ShapeSpec("own", 3938, 4, kind)
    for arch in ("yi_6b", "mixtral_8x22b", "zamba2_2_7b", "llama_3_2_vision_90b"):
        rcfg, tcfg = r_get_config(arch), get_config(arch)
        n = rcfg.attn_every or rcfg.cross_attn_every or 8
        want = RPM.estimate(rcfg.with_(n_layers=n), "own", 1, 1, 1)
        assert TPM.estimate(tcfg.with_(n_layers=n), spec, 1, 1, 1).to_json() == want.to_json()


# -- shapes --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skips_and_runnable_cells_equal_reference(arch):
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    assert list(TSH.SHAPES) == list(RSH.SHAPES)
    for name, s in RSH.SHAPES.items():
        assert dataclasses.astuple(TSH.SHAPES[name]) == dataclasses.astuple(s)
        assert TSH.skip_reason(tcfg, name) == RSH.skip_reason(rcfg, name)
    assert TSH.runnable_cells(tcfg) == RSH.runnable_cells(rcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_reference(arch):
    """Names (in order), shapes and dtypes, every cell; all on meta."""
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    for name in RSH.SHAPES:
        want = RSH.batch_specs(rcfg, name)
        got = TSH.batch_specs(tcfg, name)
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (name, k)
            assert got[k].dtype == DTYPES[str(w.dtype)], (name, k)
            assert got[k].device.type == "meta"


def _reference_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)
        out[key] = leaf
    return out


def _kv_as_dicts(tree):
    if isinstance(tree, KVCache):
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _kv_as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_kv_as_dicts(v) for v in tree]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_equal_reference(arch):
    """The reference's ``jax.eval_shape`` tree: the port's per-layer lists
    read as its stacked dims (``stacked_shape``), every leaf on meta."""
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    cells = [n for n in RSH.runnable_cells(rcfg) if RSH.SHAPES[n].kind == "decode"]
    assert cells or rcfg.encoder_only
    for name in cells:
        want = _reference_flat(RSH.decode_state_specs(rcfg, name))
        got = flat_paths(_kv_as_dicts(TSH.decode_state_specs(tcfg, name)))
        assert sorted(got) == sorted(want), name
        for k, w in want.items():
            assert stacked_shape(got[k]) == tuple(w.shape), (name, k)
            leaf = got[k]
            while isinstance(leaf, list):
                leaf = leaf[0]
            assert leaf.dtype == DTYPES[str(w.dtype)] and leaf.device.type == "meta"


# -- roofline ------------------------------------------------------------------

def _synthetic_artifacts():
    rng = np.random.default_rng(7)
    arts = []
    for i, (chips, flops, wire) in enumerate([(256, 3.2e15, 4.1e11), (512, 0.0, 0.0),
                                              (1, 5.5e13, 0.0), (16, 1e9, 8e12)]):
        arts.append({"arch": ["yi-6b", "llama-3.2-vision-90b", "rwkv6_7b", "x"][i],
                     "shape": "prefill_32k", "mesh": "single", "chips": chips,
                     "analytic": {"flops": flops, "bytes_hbm": float(rng.uniform(1e9, 1e12))},
                     "collectives": {"total_wire_bytes": wire},
                     **({"model_flops": float(rng.uniform(1e12, 1e17))} if i != 3 else {})})
    return arts


def test_analyze_with_v5e_constants_equals_reference(tmp_path):
    arts = _synthetic_artifacts()
    for a in arts:
        assert TR.analyze(a, V5E).to_json() == RR.analyze(a).to_json()
        assert [f.name for f in dataclasses.fields(TR.Roofline)] == \
            [f.name for f in dataclasses.fields(RR.Roofline)]
    for i, a in enumerate(arts):
        (tmp_path / f"{i}.json").write_text(json.dumps(a))
    (tmp_path / "notes.txt").write_text("not an artifact")
    assert TR.load_artifacts(str(tmp_path)) == RR.load_artifacts(str(tmp_path))
    assert TR.markdown_table([TR.analyze(a, V5E) for a in arts]) == \
        RR.markdown_table([RR.analyze(a) for a in arts])


def test_analyze_defaults_to_the_h100():
    a = _synthetic_artifacts()[2]
    r = TR.analyze(a)
    assert TR.H100.peak_flops == 989.4e12 and TR.H100.hbm_bw == 3.35e12
    assert TR.H100.link_bw == 450e9 and TR.H100.wire_correction == 1.0
    assert "H100" in TR.H100.name and "700 W" in TR.H100.name
    assert r.compute_s == a["analytic"]["flops"] / 989.4e12
    assert r.memory_s == a["analytic"]["bytes_hbm"] / 3.35e12
    assert r.collective_s == 0.0
    w = TR.analyze(_synthetic_artifacts()[3])
    assert w.wire_bytes_per_device == 8e12 and w.collective_s == 8e12 / 450e9


def test_against_measured_time():
    """mfu and roofline_fraction of a measured step on the H100: a step at
    exactly its bound reads 1, twice as long 0.5."""
    cfg = get_config("yi_6b").with_(n_layers=8)
    spec = TSH.ShapeSpec("p", 2048, 2, "prefill")
    est = TPM.estimate(cfg, spec, 1, 1, 1)
    mf = D.model_flops(cfg, spec)
    bound_s = max(est.flops / 989.4e12, est.bytes_hbm / 3.35e12)
    at = TR.against(est, mf, bound_s)
    assert at["roofline_fraction"] == pytest.approx(1.0, rel=1e-12)
    assert at["bound_by"] == "compute" and at["analytic_flops"] == est.flops
    half = TR.against(est, mf, 2 * bound_s)
    assert half["roofline_fraction"] == pytest.approx(0.5, rel=1e-12)
    assert half["mfu"] == pytest.approx(mf / (2 * bound_s * 989.4e12), rel=1e-12)
    assert 0 < half["mfu"] < half["roofline_fraction"]
    dec = TR.against(TPM.estimate(cfg, TSH.ShapeSpec("d", 4096, 4, "decode"), 1, 1, 1), 1.0, 1.0)
    assert dec["bound_by"] == "memory"


# -- the meta dry run ----------------------------------------------------------

REFERENCE_KEYS = {"arch", "shape", "mesh", "variant", "chips", "dp", "tp", "cost", "memory",
                  "collectives", "analytic", "model_flops"}


def _check_artifact(art, cfg, shape):
    assert REFERENCE_KEYS <= set(art)
    assert (art["mesh"], art["chips"], art["dp"], art["tp"]) == ("h100", 1, 1, 1)
    assert art["collectives"]["total_wire_bytes"] == 0.0
    assert art["memory"]["argument_size_in_bytes"] > 0
    assert art["model_flops"] == D.model_flops(cfg, shape)
    r = RR.analyze(json.loads(json.dumps(art)))  # the reference reads it as written
    assert r.model_flops == art["model_flops"] and r.chips == 1
    assert TR.analyze(art, V5E).to_json() == r.to_json()
    assert TR.analyze(art).compute_s == art["analytic"]["flops"] / 989.4e12


@pytest.mark.parametrize("shape", list(TSH.SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_dry_run_of_each_family(arch, shape, monkeypatch):
    """Each family's smoke config at the cell's batch and length: the
    reference's keys, read by its ``analyze``; the counted FLOPs at least
    the model FLOPs where the plain path computes every product (every
    family but ssm: RWKV6's 2N counts its token-shift mixes and decay lora
    as products); the skipped cells carry the reference's reason."""
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    cfg = get_smoke_config(arch)
    art = D.lower_cell(arch, shape)
    reason = RSH.skip_reason(r_get_smoke_config(arch), shape)
    assert TSH.skip_reason(cfg, shape) == reason
    if reason:
        assert art == {"arch": arch, "shape": shape, "mesh": "h100", "skipped": reason}
        return
    _check_artifact(art, cfg, shape)
    assert art["analytic"] == TPM.estimate(cfg, shape, 1, 1, 1,
                                           eight_bit_opt=arch in D.EIGHT_BIT).to_json()
    if cfg.family != "ssm":
        assert art["cost"]["flops"] >= art["model_flops"] > 0
    else:
        assert art["cost"]["flops"] > 0 and art["rwkv_chunk"] == D.RWKV_CHUNK
    if TSH.SHAPES[shape].kind == "train":
        assert art["lb_ingest"] is True and art["eight_bit_opt"] == (arch in D.EIGHT_BIT)


def test_meta_dry_run_full_size_prefill(tmp_path):
    """Yi-6B's published config at prefill_32k (32 x 32768 tokens) through
    the CLI, in seconds: the plain attention's whole T x T (masked half
    included) against 2 N D gives a useful ratio near 0.43; the argument
    bytes are the params and the decode state's."""
    D.main(["--arch", "yi_6b", "--shape", "prefill_32k", "--out", str(tmp_path)])
    (art,) = RR.load_artifacts(str(tmp_path))
    cfg = get_config("yi_6b")
    _check_artifact(art, cfg, "prefill_32k")
    useful = RR.analyze(art)
    assert 0.40 < art["model_flops"] / art["cost"]["flops"] < 0.46
    assert useful.useful_ratio == art["model_flops"] / art["analytic"]["flops"]
    n_params = cfg.param_count()[0] + cfg.d_model  # + the final norm's scales
    state = TSH.decode_state_specs(cfg, "prefill_32k")
    state_bytes = sum(t.numel() * t.element_size() for t in D.tensors(state))
    assert art["memory"]["argument_size_in_bytes"] == \
        2 * n_params + 32 * 32768 * 4 + state_bytes
    assert art["lower_compile_s"] > 0


def test_cli_writes_the_skipped_cell_and_refuses_sharded_meshes(tmp_path, capsys):
    D.main(["--arch", "yi-6b", "--shape", "long_500k", "--out", str(tmp_path)])
    (art,) = RR.load_artifacts(str(tmp_path))
    assert art["skipped"] == RSH.skip_reason(r_get_config("yi_6b"), "long_500k")
    assert "skipped" in art and "cost" not in art
    # the sharded meshes' variants on the one card (the decode cell on the
    # sharded meshes lowers: tests/test_torch_serve_tp.py)
    for argv in (["--variant", "dponly"], ["--variant", "rwkvchunk+seqpar"],
                 ["--variant", "tp4"], ["--variant", "widetp"], ["--variant", "moegroup"]):
        with pytest.raises(SystemExit) as e:
            D.main(["--arch", "yi_6b", "--shape", "decode_32k", "--out", str(tmp_path)] + argv)
        assert "sharded" in str(e.value.code)
    with pytest.raises(SystemExit):
        D.lower_cell("yi_6b", "decode_32k", "widetp")


def test_cli_accepts_the_train_cell_on_the_sharded_meshes(tmp_path, monkeypatch):
    """``--mesh single --shape train_4k`` (and ``both``, ``--variant
    dponly``, ``tp4``, ``seqpar``) lowers each mesh's cell inside a fake
    process group of the mesh's size (the lowering itself:
    ``tests/test_torch_collectives.py``)."""
    import torch.distributed as dist

    seen = []

    def fake_lower(arch, shape, variant, *, mesh):
        seen.append((arch, shape, variant, mesh, dist.get_world_size()))
        return {"arch": arch, "shape": shape, "mesh": mesh, "skipped": "stub"}

    monkeypatch.setattr(D, "lower_cell", fake_lower)
    for mesh, variant in (("both", "baseline"), ("single", "dponly"), ("single", "tp4"),
                          ("single", "seqpar")):
        D.main(["--arch", "yi_6b", "--shape", "train_4k", "--mesh", mesh, "--variant", variant,
                "--out", str(tmp_path)])
    assert seen == [("yi_6b", "train_4k", "baseline", "single", 256),
                    ("yi_6b", "train_4k", "baseline", "multi", 512),
                    ("yi_6b", "train_4k", "dponly", "single", 256),
                    ("yi_6b", "train_4k", "tp4", "single", 256),
                    ("yi_6b", "train_4k", "seqpar", "single", 256)]
    assert not dist.is_initialized()
    assert sorted(os.listdir(tmp_path)) == [
        "yi_6b__train_4k__multi.json", "yi_6b__train_4k__single.json",
        "yi_6b__train_4k__single__dponly.json", "yi_6b__train_4k__single__seqpar.json",
        "yi_6b__train_4k__single__tp4.json"]


def test_dry_run_refuses_a_tensor_off_meta():
    with pytest.raises(RuntimeError, match="meta dry run"):
        D._counted(lambda: torch.ones(3) @ torch.ones(3))
    with pytest.raises(RuntimeError, match="not on meta"):
        D._nbytes({"a": [torch.empty(2, device="meta"), torch.zeros(2)]})
    flops, by_op = D._counted(lambda: torch.empty(4, 8, device="meta") @
                              torch.empty(8, 2, device="meta"))
    assert flops == 2 * 4 * 8 * 2 and by_op == {"aten.mm": 128.0}


def test_eight_bit_archs_by_either_spelling():
    """``EIGHT_BIT`` matches the reference's three archs under the ids the
    sweep iterates (the reference's set, hyphenated, misses them there)."""
    assert {D._arch_id(a) for a in ("arctic-480b", "llama-3.2-vision-90b",
                                    "mixtral-8x22b")} == D.EIGHT_BIT
    assert D.EIGHT_BIT <= set(ARCH_IDS)


# -- the kernel wrappers on meta -------------------------------------------------

class _Elsewhere:
    """Stands in for a tensor on a device the wrappers do not take."""

    def __init__(self, shape, ndim=None):
        self.shape, self.ndim = torch.Size(shape), ndim or len(shape)
        self.device, self.requires_grad = torch.device("xpu"), False


def _like(got, want):
    """Meta outputs with the shapes and dtypes of the CPU's."""
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype


def test_flash_attention_on_meta_is_its_plain_version_in_shape():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, h, 16), np.float32))
               for h in (4, 2, 2))
    before = dict(_lib.LAUNCHES)
    for causal in (True, False):
        want = flash_attention(q, k, v, causal=causal)
        assert torch.equal(want, flash_attention_ref(q, k, v, causal=causal))
        got = flash_attention(*(x.to("meta") for x in (q, k, v)), causal=causal)
        _like(got, want)
        _like(flash_attention(*(x.to("meta", torch.bfloat16) for x in (q, k, v))),
              want.bfloat16())
    assert _lib.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(_Elsewhere((2, 9, 4, 16)), _Elsewhere((2, 9, 2, 16)),
                        _Elsewhere((2, 9, 2, 16)))


def test_dispatch_plan_on_meta_is_its_plain_version_in_shape():
    member = torch.from_numpy(np.random.default_rng(1).integers(-1, 9, 300).astype(np.int32))
    before = dict(_lib.LAUNCHES)
    want = dispatch_plan(member, n_members=7)
    for g, w in zip(want, dispatch_plan_ref(member, n_members=7)):
        assert torch.equal(g, w)
    _like(dispatch_plan(member.to("meta"), n_members=7), want)
    assert _lib.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch_plan(_Elsewhere((300,)), n_members=7)


def test_lb_route_on_meta_is_its_plain_version_in_shape():
    from repro_torch.core.protocol import encode_headers, words_to_tensor

    rng = np.random.default_rng(2)
    words = words_to_tensor(encode_headers(rng.integers(0, 1 << 40, 64).astype(np.uint64),
                                           rng.integers(0, 1 << 16, 64).astype(np.uint32)),
                            "cpu")
    before = dict(_lib.LAUNCHES)
    want = lb_route(words, D.build_tables(3, "cpu"))
    for g, w in zip(want, lb_route_ref(words, D.build_tables(3, "cpu"))):
        assert torch.equal(g, w)
    _like(lb_route(words.to("meta"), D.build_tables(3, "meta")), want)
    assert _lib.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        lb_route(_Elsewhere((64, 4)), D.build_tables(3, "cpu"))
