"""Mamba mixer: the program's layer.mamba spans summed a prefill of the traced stretch, per 1,000 prompt tokens, mean over the stretch's prefills, host ms (batch cells)."""

from nkb.mamba_trace import mamba_prefill_ms as read  # noqa: F401
