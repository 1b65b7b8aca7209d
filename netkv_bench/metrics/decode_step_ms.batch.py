"""Decode engine: mean span of DecodeEngine.step, ms (batch cells)."""

from nkb.readers import decode_step_ms as read  # noqa: F401
