"""Decode engine: lanes serving a request over lanes decoded, summed over the traced stretch's steps, % (batch cells)."""

from nkb.program_trace import decode_lane_use_pct as read  # noqa: F401
