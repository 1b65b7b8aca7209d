"""Cluster substrate of the port: fat-tree topology + columnar flow-level
network model (copies of ``repro.cluster.topology`` and ``.network``)."""

from .network import BackgroundTraffic, FlowNetwork, FlowPlane
from .topology import FatTree, make_instances

__all__ = ["BackgroundTraffic", "FatTree", "FlowNetwork", "FlowPlane",
           "make_instances"]
