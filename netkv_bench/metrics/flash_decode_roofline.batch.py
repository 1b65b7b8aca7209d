"""K4 (flash_decode): share of HBM bandwidth over its device time, % (batch cells)."""

from nkb.readers import flash_decode_roofline as read  # noqa: F401
