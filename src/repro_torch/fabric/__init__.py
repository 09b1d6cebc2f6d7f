"""repro_torch.fabric — two-tier LB fabric.

A fleet of DAQs sprays event bundles across a tier of K LB instances via
two-phase Valiant load balancing (random intermediate, then direct to the
owning instance; per-bundle spray keys keep a bundle's segments on one
path), while an elephant-flow detector strict-source-routes heavy streams
onto reserved calendar lanes so mice never share a queue with them. Every
window routes through the stacked tables of all 2K calendars in one
``lb_route`` launch on the card.
"""
from repro_torch.fabric.elephant import ElephantConfig, ElephantDetector
from repro_torch.fabric.scenarios import FABRIC_SCENARIOS, get_fabric_scenario
from repro_torch.fabric.sim import FabricConfig, FabricReport, FabricScenario, FabricSim
from repro_torch.fabric.spray import mix64, spray_keys, spray_paths

__all__ = [
    "ElephantConfig", "ElephantDetector",
    "FABRIC_SCENARIOS", "get_fabric_scenario",
    "FabricConfig", "FabricReport", "FabricScenario", "FabricSim",
    "mix64", "spray_keys", "spray_paths",
]
