"""Decode engine: share of the traced stretch's decode steps whose enqueue holds a decode.graph span (a replayed CUDA graph), % (batch cells)."""

from nkb.graph_trace import decode_graph_pct as read  # noqa: F401
