"""Device: share of the traced stretch with no kernel running, % (batch cells)."""

from nkb.readers import device_idle as read  # noqa: F401
