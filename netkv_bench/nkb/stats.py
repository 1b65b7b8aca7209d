"""Counts over a window, as the end-to-end metrics take them."""

from __future__ import annotations

def tokens_in_window(requests, window_s: float) -> int:
    """Output tokens delivered in the window: each decode step's emissions,
    the prefill's token with its request's first."""
    return sum(r.tokens_at(window_s) for r in requests)
