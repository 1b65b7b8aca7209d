"""Cluster substrate of the port: fat-tree topology + columnar flow-level
network model (copies of ``repro.cluster.topology`` and ``.network``)."""

from .network import BackgroundTraffic, FlowNetwork, FlowPlane, FlowView, Transfer
from .topology import (
    FatTree,
    HashNicPolicy,
    Instance,
    LeastLoadedNicPolicy,
    Link,
    MAX_PATH_LEN,
    NIC_POLICIES,
    NicPolicy,
    RailAffineNicPolicy,
    make_instances,
    make_nic_policy,
)

__all__ = [
    "FatTree", "Instance", "Link", "MAX_PATH_LEN", "make_instances",
    "NicPolicy", "HashNicPolicy", "LeastLoadedNicPolicy",
    "RailAffineNicPolicy", "NIC_POLICIES", "make_nic_policy",
    "BackgroundTraffic", "FlowNetwork", "FlowPlane", "FlowView", "Transfer",
]
