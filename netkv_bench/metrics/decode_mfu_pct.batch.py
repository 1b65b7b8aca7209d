"""The whole decode step: its useful work's least time at the peaks over
its wall, % (batch cells)."""

from nkb.readers import decode_mfu as read  # noqa: F401
