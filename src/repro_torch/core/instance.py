"""Virtual LB instances (paper §I-C): four independent balancing contexts.

"The load balancer supports multiple IPv4 and IPv6 addresses, with each
destination address mapping to one of four independent instances of all of
the load balancing context." Instance selection is the L3 filter's job; each
instance owns an independent EpochManager/RouterState. On the device, the
four table sets are stacked on a leading instance dimension and packets are
routed per-instance in one fused pass through core/dataplane.DataPlane.
"""
from __future__ import annotations

from repro_torch.core.epoch import EpochManager
from repro_torch.core.tables import DeviceTables, L2L3Filter, L3Entry, stack_tables

N_INSTANCES = 4


class VirtualLoadBalancer:
    """One physical LB hosting N_INSTANCES independent contexts."""

    def __init__(self, max_members: int = 512):
        self.filter = L2L3Filter()
        self.instances = [EpochManager(max_members=max_members) for _ in range(N_INSTANCES)]

    def bind_address(self, ethertype: int, dst_ip: str, src_ip: str, instance_id: int) -> None:
        if not 0 <= instance_id < N_INSTANCES:
            raise ValueError(f"instance id {instance_id} out of range")
        self.filter.add_l3(L3Entry(ethertype=ethertype, dst_ip=dst_ip,
                                   src_ip=src_ip, instance_id=instance_id))

    def classify(self, mac_da: str, ethertype: int, dst_ip: str):
        """L2/L3 admission -> instance id, or None (packet discarded)."""
        entry = self.filter.admit(mac_da, ethertype, dst_ip)
        return None if entry is None else entry.instance_id

    def device_tables(self, device="cuda") -> DeviceTables:
        """Stacked tables, leading dim = instance id."""
        return stack_tables([em.device_tables(device) for em in self.instances])
