"""Attention: the program's layer.attn spans summed a step, mean over the traced stretch's steps, host ms (batch cells)."""

from nkb.program_trace import attn_host_ms as read  # noqa: F401
