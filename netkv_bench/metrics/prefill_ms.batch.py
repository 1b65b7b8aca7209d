"""Prefill engine: mean of cluster.walls' prefill_s, ms."""

from nkb.readers import prefill_ms as read  # noqa: F401
