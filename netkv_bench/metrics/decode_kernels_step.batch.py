"""Decode step: device kernels starting inside the program's decode.step spans, a step, where the clock check holds (batch cells)."""

from nkb.program_trace import decode_kernels_step as read  # noqa: F401
