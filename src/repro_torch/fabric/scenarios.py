"""Named fabric scenarios — each one encodes a gate.

* ``vlb_spray``: one white-hot DAQ (16x the rest). Direct per-DAQ hashing
  concentrates ~3/4 of the aggregate on one LB; the VLB gate is that the
  two-phase spray's max-LB load share stays at or below direct's.
* ``elephant_mice``: one elephant stream among mice. Run twice (isolation
  on/off); the gate is mice p99 strictly better with isolation ON.
* ``lb_node_failure``: lossless links, kill a tier member mid-run. Gate:
  zero lost bundles and a clean invariant audit (windows are atomic, the
  spray plane re-indexes over survivors).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fabric.elephant import ElephantConfig
from repro_torch.fabric.sim import FabricScenario
from repro_torch.simnet.links import LinkConfig


def _hot_daq(scale: float):
    def make(n_daqs: int) -> np.ndarray:
        s = np.ones(n_daqs)
        s[0] = scale
        return s
    return make


def _kill_midrun(sim, step: int) -> None:
    if step == sim.cfg.steps // 2 and len(sim.live) > 1:
        sim.kill_lb(sim.live[0])


FABRIC_SCENARIOS: dict[str, FabricScenario] = {
    "vlb_spray": FabricScenario(
        name="vlb_spray",
        description="Skewed DAQ load; VLB spray must beat direct hashing "
                    "on max-LB load share.",
        overrides=dict(
            steps=40, k_lbs=4, n_members=16, n_daqs=8,
            triggers_per_step=4, trigger_period_s=1e-3,
            mean_bundle_bytes=12_000, seed=7,
        ),
        daq_scale=_hot_daq(16.0),
    ),
    "elephant_mice": FabricScenario(
        name="elephant_mice",
        description="One elephant stream among mice; reserved-lane "
                    "isolation must cut mice p99.",
        overrides=dict(
            steps=50, k_lbs=2, n_members=8, n_daqs=6,
            triggers_per_step=4, trigger_period_s=1e-3,
            mean_bundle_bytes=12_000, seed=11,
            reserved_fraction=0.25,
            detector=ElephantConfig(hi_Bps=30e6, lo_Bps=15e6, alpha=0.3),
        ),
        daq_scale=_hot_daq(6.0),
    ),
    "lb_node_failure": FabricScenario(
        name="lb_node_failure",
        description="Kill one LB tier member mid-run on lossless links; "
                    "re-spray must be hit-less (zero lost bundles).",
        overrides=dict(
            steps=30, k_lbs=4, n_members=16, n_daqs=8,
            triggers_per_step=4, trigger_period_s=1e-3,
            mean_bundle_bytes=8_000, seed=3,
            daq_uplink=LinkConfig(rate_Bps=400e6, jitter_s=1e-5),
            lb_ingress=LinkConfig(rate_Bps=400e6, prop_delay_s=2e-4,
                                  jitter_s=1e-5),
            lb_fabric=LinkConfig(rate_Bps=400e6, prop_delay_s=5e-5,
                                 jitter_s=1e-5),
            member_link=LinkConfig(rate_Bps=100e6, prop_delay_s=5e-5,
                                   jitter_s=1e-5),
            queue_capacity_s=10.0,
        ),
        on_step=_kill_midrun,
    ),
}


def get_fabric_scenario(name: str) -> FabricScenario:
    try:
        return dataclasses.replace(FABRIC_SCENARIOS[name])
    except KeyError:
        raise KeyError(
            f"unknown fabric scenario {name!r}; "
            f"have {sorted(FABRIC_SCENARIOS)}") from None
