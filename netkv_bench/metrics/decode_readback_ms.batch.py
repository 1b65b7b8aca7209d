"""Decode engine: mean of the program's decode.readback span (the host waiting for the step's tokens) a step of the traced stretch, ms (batch cells)."""

from nkb.program_trace import decode_readback_ms as read  # noqa: F401
