"""Executable disaggregated serving of the port: real engines + NetKV routing."""

from .cluster import DisaggregatedCluster, ServeRequest, ServeResult
from .engine import DecodeEngine, PrefillEngine, PrefillResult
from .transfer import (
    merge_chunk_buffers, pack_transfer, pack_transfer_chunk, paged_view,
    unpack_transfer,
)

__all__ = ["DecodeEngine", "PrefillEngine", "PrefillResult",
           "DisaggregatedCluster", "ServeRequest", "ServeResult",
           "merge_chunk_buffers", "pack_transfer", "pack_transfer_chunk",
           "paged_view", "unpack_transfer"]
