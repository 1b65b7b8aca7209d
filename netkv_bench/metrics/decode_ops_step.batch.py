"""Decode step: device events whose launching call lies inside the program's decode.step spans, a step, by correlation id on the host clock (batch cells)."""

from nkb.program_trace import decode_ops_step as read  # noqa: F401
