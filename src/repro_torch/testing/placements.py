"""A training placement with optimizer leaves on the layer list.

``train_step.placement`` puts each moment where its param lies. The
reference's rules place every leaf of the optimizer's tree by its own shape
(``param_sharding`` over that tree): at a small ``min_fsdp_size`` the 8-bit
row scales of a per-layer norm (``[L, 1]``) then lie on the layer dim,
whole layers per data rank, where the port's placement holds them whole.
``on_layer_list`` gives the port's placement with those leaves placed as
the reference places them, so that a step, a checkpoint and a restore can
be run on such a state (``distributed.sharding.LIST``).
"""
from __future__ import annotations

from repro_torch.distributed import sharding as shd
from repro_torch.train import train_step as TS
from repro_torch.tree import flat_paths, list_depth, unflatten_paths


def on_layer_list(model_cfg, train_cfg, mesh, *, min_fsdp_size: int) -> dict:
    """``train_step.placement`` at ``min_fsdp_size``, with each optimizer
    leaf that it holds whole over the data axes taking the reference's
    spec where that places the leaf's layer list on the data axes."""
    shapes = TS.state_shapes(model_cfg, train_cfg)
    specs = TS.placement(model_cfg, train_cfg, mesh, shapes["params"],
                         min_fsdp_size=min_fsdp_size)
    ref = flat_paths(shd.param_sharding(shapes["opt"], mesh, model_cfg,
                                        min_fsdp_size=min_fsdp_size))
    depth = {k: list_depth(v) for k, v in flat_paths(shapes["opt"]).items()}
    opt = {}
    for k, spec in flat_paths(specs["opt"]).items():
        d = shd.data_dim(ref[k], mesh)
        whole = shd.data_dim(spec, mesh) is None
        opt[k] = ref[k] if whole and d is not None and d < depth[k] else spec
    return {"params": specs["params"], "opt": unflatten_paths(opt)}
