"""FFN: the program's layer.ffn spans summed a step, mean over the traced stretch's steps, host ms (batch cells)."""

from nkb.program_trace import ffn_host_ms as read  # noqa: F401
