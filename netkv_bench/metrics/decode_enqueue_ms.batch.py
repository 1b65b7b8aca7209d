"""Decode engine: mean of the program's decode.enqueue span a step of the traced stretch, ms (batch cells)."""

from nkb.program_trace import decode_enqueue_ms as read  # noqa: F401
