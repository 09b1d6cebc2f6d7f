"""repro_torch.simnet — discrete virtual-time network & farm simulator.

Latency is the paper's keystone claim (a *low fixed-latency* LB data plane);
this package gives the port a notion of time so end-to-end latency, queue
occupancy and control-plane reaction are measured, not assumed. The port of
the JAX package's ``repro.simnet``: the host engine (``sim.Simulator``)
routes every window through the ``lb_route`` kernel, and the fused engine
(``fused.FusedEngine``) runs K windows as one replay of a captured CUDA
graph.
"""
from repro_torch.simnet.clock import VirtualClock
from repro_torch.simnet.links import Link, LinkConfig
from repro_torch.simnet.queues import FarmConfig, FarmQueues
from repro_torch.simnet.scenarios import SCENARIOS, get_scenario
from repro_torch.simnet.sim import SimConfig, SimReport, Simulator

__all__ = [
    "VirtualClock", "Link", "LinkConfig", "FarmConfig", "FarmQueues",
    "SCENARIOS", "get_scenario", "SimConfig", "SimReport", "Simulator",
]
